"""Batched inference engine, counterpart of ``learning3d_tpu/serve.py::
InferenceEngine``.

    engine = InferenceEngine(model, batch_size=256)
    logits = engine(points)     # numpy (n, N, 3), any n -> numpy (n, ...)

    result = InferenceEngine(dcp, batch_size=32)(template, source)  # dict

Inputs of any leading size are split into full ``batch_size`` chunks; the
tail chunk is zero-padded to ``batch_size``, so the model always sees the
same shape, and the padding is stripped from the output. Each chunk makes
one host-to-device copy per input and one device-to-host copy per output
(per tensor of the result), under ``torch.inference_mode()``. A bf16
output comes back as float32 numpy (numpy has no bf16). The result may be
a tensor or tuples, lists and dicts of them, nested as a JAX pytree: the
slicing, the copy and the concatenation across chunks map over its
tensors, and every container keeps its type (a tuple stays a tuple, a dict
a dict; a None stays None); ``output_key`` picks one key of a dict.

    reg = TemplateRegistrar(dcp, template, batch_size=32)
    result = reg(sources)       # numpy (n, N, 3), any n -> dict

registers many sources against one fixed template, whose encoder pass runs
once.

    out = multistart_register(model, template, source, rotation_starts(8))

registers each pair from K initial rotations folded into the batch (one
forward at K * B) and keeps, per pair, the start whose composed transform
gives the lowest symmetric Chamfer distance (K12 on the card). Mesh serving
and per-shape CUDA graphs are not ported yet.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.kernels.chamfer import chamfer_distance


def _to_numpy(t: torch.Tensor, rows: int) -> np.ndarray:
    t = t[:rows]
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure): tuples, lists and dicts are
    walked and rebuilt with their own type, None is kept, anything else is a
    leaf. The JAX engine's ``jax.tree.map`` on a model's output."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((key, _tree_map(fn, val, *(r[key] for r in rest))) for key, val in tree.items())
    if isinstance(tree, (tuple, list)):
        items = [_tree_map(fn, val, *(r[i] for r in rest)) for i, val in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def _host_rows(out, rows: int):
    """The first ``rows`` rows of every tensor of a model's output, as numpy."""
    return _tree_map(lambda t: _to_numpy(t, rows), out)


def _concat(pieces):
    """The per-chunk results joined along the batch axis, leaf by leaf."""
    if len(pieces) == 1:
        return pieces[0]
    return _tree_map(lambda *xs: np.concatenate(xs, axis=0), *pieces)


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, batch_size: int = 256, *, output_key: str | None = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        self.output_key = output_key

    def __call__(self, *inputs):
        """inputs: numpy arrays with a shared leading dimension n. Returns
        the model's output with every tensor a numpy array of leading
        dimension n, in the output's own containers (one array of a dict if
        ``output_key`` is set)."""
        inputs = [np.ascontiguousarray(a) for a in inputs]
        n = inputs[0].shape[0]
        if any(a.shape[0] != n for a in inputs):
            raise ValueError("inputs must share the leading (batch) dimension")
        bs = self.batch_size
        pieces = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                chunk = [a[lo : lo + bs] for a in inputs]
                got = chunk[0].shape[0]
                if got < bs:  # pad the tail to keep the batch shape
                    chunk = [np.concatenate([c, np.zeros((bs - got,) + c.shape[1:], c.dtype)]) for c in chunk]
                args = [torch.from_numpy(c).to(self.device) for c in chunk]
                pieces.append(_host_rows(self.model(*args), got))
        out = _concat(pieces)
        if self.output_key is not None and isinstance(out, dict):
            return out[self.output_key]
        return out


class TemplateRegistrar:
    """One-template-many-sources registration serving, for a model with
    ``encode()`` / ``register_encoded()`` (DCP, and its int8 clone from
    ``quant.quantize_dcp``). The template's encoder features are computed
    once, here; each chunk of sources is registered against them broadcast
    to the chunk, so a request pays only the sources' encoder, the pointer
    and the head. Chunks are ``batch_size`` sources, the tail zero-padded
    and stripped, as in ``InferenceEngine``; est_* map each source onto the
    template."""

    def __init__(self, model: torch.nn.Module, template, batch_size: int = 32, *, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        t = np.asarray(template, np.float32)
        if t.ndim == 2:
            t = t[None]
        if t.ndim != 3 or t.shape[0] != 1:
            raise ValueError("template must be one (N, 3) cloud")
        self._template = torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
        with torch.inference_mode():
            self._temb = self.model.encode(self._template)  # (1, N, E), cached

    def __call__(self, sources):
        sources = np.asarray(sources, np.float32)
        if sources.ndim == 2:
            sources = sources[None]
        n, bs = sources.shape[0], self.batch_size
        pieces = []
        with torch.inference_mode():
            for lo in range(0, n, bs):
                chunk = sources[lo : lo + bs]
                got = chunk.shape[0]
                if got < bs:  # pad the tail to keep the batch shape
                    chunk = np.concatenate([chunk, np.zeros((bs - got,) + chunk.shape[1:], chunk.dtype)])
                src = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
                out = self.model.register_encoded(self._template.expand(bs, -1, -1), self._temb.expand(bs, -1, -1),
                                                  src)
                pieces.append(_host_rows(out, got))
        return _concat(pieces)


def rotation_starts(n_starts: int = 8) -> torch.Tensor:
    """The first ``n_starts`` elements of the 24-rotation octahedral group
    (the signed 3x3 permutation matrices with det +1), identity first, then
    greedily ordered for spread, as a (n_starts, 3, 3) f32 CPU tensor: a
    deterministic coarse cover of SO(3) for ``multistart_register``. The
    order is the JAX package's, kept for parity: each next start is the one
    whose largest trace against the chosen ones is smallest (the "min" in
    the loop, not a max)."""
    if not 1 <= n_starts <= 24:
        raise ValueError("n_starts must be in [1, 24] (octahedral rotation group)")
    rots = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3), np.float32)
            for i, (j, sgn) in enumerate(zip(perm, signs)):
                R[i, j] = sgn
            if np.linalg.det(R) > 0:
                rots.append(R)
    rots = np.stack(rots)  # (24, 3, 3)
    order = [int(np.argmax([np.trace(R) for R in rots]))]
    rest = [i for i in range(len(rots)) if i != order[0]]
    while rest and len(order) < n_starts:
        # geodesic distance ~ arccos((tr(Ra^T Rb) - 1) / 2); trace is monotone
        dmin = [min(np.trace(rots[a].T @ rots[b]) for b in order) for a in rest]
        nxt = rest[int(np.argmin(dmin))]
        order.append(nxt)
        rest.remove(nxt)
    return torch.from_numpy(rots[order[:n_starts]])


def _apply(R, pts):
    """R (..., 3, 3) applied to points (..., M, 3), products summed
    elementwise (no TF32)."""
    return (R[..., None, :, :] * pts[..., :, None, :]).sum(-1)


def multistart_scores(model, template, source, rotations):
    """The candidates of ``multistart_register``: (total (K, B, 4, 4), the
    composed transform of each start, mapping the original source onto the
    template; score (K, B), its symmetric Chamfer distance, K12 on the
    card)."""
    Rs = torch.as_tensor(rotations).to(device=template.device, dtype=template.dtype)
    K, B = Rs.shape[0], template.shape[0]
    xyz = source[..., :3]
    c = xyz.mean(dim=1)  # (B, 3): rotate about the source centroid, so the
    # pre-rotated cloud stays inside the translation range the model saw
    rot = _apply(Rs[:, None], (xyz - c[:, None, :])[None]) + c[None, :, None, :]  # (K, B, M, 3)
    if source.shape[-1] > 3:  # carry normals through the pre-rotation
        rot = torch.cat([rot, _apply(Rs[:, None], source[None, ..., 3:6])], dim=-1)
    src_k = rot.reshape((K * B,) + tuple(rot.shape[2:]))
    tmpl_k = template[None].expand((K,) + tuple(template.shape)).reshape((K * B,) + tuple(template.shape[1:]))
    order = getattr(model, "forward_arg_order", "template_source")
    out = model(src_k, tmpl_k) if order == "source_template" else model(tmpl_k, src_k)
    est = out["est_T"].reshape(K, B, 4, 4)
    # the pre-rotation as a 4x4: G_k x = R_k (x - c) + c
    Rg, cg = Rs.to(est.dtype), c.to(est.dtype)
    G = torch.zeros((K, B, 4, 4), dtype=est.dtype, device=est.device)
    G[..., :3, :3] = Rg[:, None]
    G[..., :3, 3] = cg[None] - (Rg[:, None] * cg[None, :, None, :]).sum(-1)
    G[..., 3, 3] = 1.0
    total = (est[..., :, :, None] * G[..., None, :, :]).sum(-2)  # est @ G
    return total, chamfer_scores(total, template, source)


def chamfer_scores(total, template, source):
    """The symmetric Chamfer distance (chamfer_distance_loss's reduction,
    per item) between each template and its source moved by each candidate
    transform: total (K, B, 4, 4) -> (K, B)."""
    K, B = total.shape[:2]
    xyz = source[..., :3]
    moved = _apply(total[..., :3, :3], xyz[None].to(total.dtype)) + total[..., None, :3, 3]  # (K, B, M, 3)
    t_flat = template[None, ..., :3].expand((K,) + tuple(template.shape[:-1]) + (3,)).reshape(K * B, -1, 3)
    d1, d2 = chamfer_distance(t_flat, moved.reshape(K * B, -1, 3))
    return 0.5 * (torch.mean(torch.sqrt(torch.clamp(d1, min=1e-12)), dim=-1)
                  + torch.mean(torch.sqrt(torch.clamp(d2, min=1e-12)), dim=-1)).reshape(K, B)


def multistart_register(model, template, source, rotations):
    """Multi-start registration: fold K initial rotations into the batch
    (one forward at batch K * B), then pick per item the start whose
    composed transform gives the lowest symmetric Chamfer distance.

    model:     a registration model returning {"est_T": (B, 4, 4)} (est_T
               maps source -> template); ``forward_arg_order`` is honored
               ("source_template" for PRNet).
    template:  (B, N, 3) or (B, N, 6) with normals
    source:    (B, M, 3) or (B, M, 6)
    rotations: (K, 3, 3) initial rotations (``rotation_starts``), applied
               about each source's centroid before the forward; normals are
               rotated with them.

    Returns {"est_T": (B, 4, 4) the composed best transform, "start_idx":
    (B,) the winning start, "chamfer": (B,) its score}, the score being
    chamfer_distance_loss's per item. No data-dependent control flow."""
    total, score = multistart_scores(model, template, source, rotations)
    k_star = torch.argmin(score, dim=0)  # (B,), the first of equal scores
    pick = total[k_star, torch.arange(template.shape[0], device=total.device)]
    return {"est_T": pick, "start_idx": k_star, "chamfer": score.min(dim=0).values}
