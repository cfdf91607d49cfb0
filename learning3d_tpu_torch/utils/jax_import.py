"""Carry weights across from the JAX package.

``load_nnx_state(model, flat)`` takes the flattened nnx state of the JAX
twin as numpy arrays, keyed by the dotted ``nnx.to_flat_state`` paths
(``{"feature_model.convs.0.kernel": ndarray, ...}``), and copies it into
the port's module of the same structure. The flattening itself happens on
the JAX side (the tests do it); this module never imports JAX.

Mapping (the port keeps torch's orientation for Linear):
    Linear    kernel (in, out)  -> weight (out, in), transposed
              bias              -> bias
    BatchNorm scale / bias      -> weight / bias
              mean / var        -> running_mean / running_var
    GroupNorm scale / bias      -> weight / bias (no running statistics)
    Param     any other leaf    -> the parameter of the same path
Entries under ``rngs`` (dropout keys and counters, PRNet's head's Gumbel
stream) are skipped. Every ported model crosses this way (PointNet, the
classifier, DGCNN, DCP with either head, PRNet, iPCRNet, PCN, FlowNet3D,
PPFNet, RPMNet, PointNetLK, MaskNet, Segmentation, PointConv, CurveNet,
DeepGMR and MaskNet2, whose ``nnx.List`` blocks map onto ``nn.ModuleList``
indices; MaskNet2's attention gates ``beta`` (1,) are plain Params): the port's
modules carry the JAX modules' attribute names. A BatchNorm's state is
per channel whatever the rank of its input (PointConv's and CurveNet's
BatchNorms over (B, S, K, C) groups), and the one- and two-channel
BatchNorms of CurveNet's walk cross like any other; a module the JAX model
holds as None (a CIC block without a shortcut or curves) has no entry on
either side. PointNetLK's ``dt`` (an ``nnx.Variable``, or
a ``Param`` under ``learn_delta``) reaches the buffer or the parameter of
that name. PCN's conv5 keeps one
(emb + 5, 512) kernel, which the folding decoder splits by linearity in its
forward, and PRDGCNN's edge convs one (2C, Co) kernel, which its forward
splits into the neighbor and the center term, as the JAX package does;
PRNet's head carries its unused ``temperature`` (1,).

Quantized state crosses as well, as numpy: ``load_quant_pointnet`` takes the
arrays of a JAX ``QuantPointNetClassifier`` pytree, ``load_quant_dcp`` the
int8 variables and Python-float scales of a JAX ``quantize_dcp`` clone, so
that the port's integer math can be held against the JAX package's with
identical scales.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def nnx_to_torch(flat) -> dict[str, np.ndarray]:
    """Rename and re-orient a flat nnx state into torch state_dict keys."""
    out = {}
    for key, value in flat.items():
        parts = key.split(".")
        if "rngs" in parts:
            continue
        value = np.asarray(value)
        leaf = parts[-1]
        if leaf == "kernel":
            if value.ndim != 2:
                raise ValueError(f"{key}: expected a 2-D Linear kernel, got {value.shape}")
            parts[-1], value = "weight", value.T
        else:
            parts[-1] = _RENAME.get(leaf, leaf)
        out[".".join(parts)] = value
    return out


def load_nnx_state(model: torch.nn.Module, flat) -> torch.nn.Module:
    """Copy a flat nnx state into ``model`` in place. Raises KeyError on a
    tensor missing from either side and ValueError on a shape mismatch."""
    src = nnx_to_torch(flat)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    unexpected = sorted(set(src) - set(dst))
    if missing or unexpected:
        raise KeyError(f"missing from the nnx state: {missing}; not in the model: {unexpected}")
    for key, target in dst.items():
        if tuple(src[key].shape) != tuple(target.shape):
            raise ValueError(f"{key}: nnx shape {src[key].shape} vs model {tuple(target.shape)}")
    with torch.no_grad():
        for key, target in dst.items():
            target.copy_(torch.from_numpy(np.array(src[key], copy=True)).to(target.dtype))
    return model


def load_quant_pointnet(arrays, device="cuda"):
    """A ``quant.QuantPointNetClassifier`` from the arrays of the JAX pytree:
    ``{"w1", "b1", "w_out", "b_out"}`` and ``"enc"`` / ``"head"``, lists of
    ``{"w_q", "s_w", "b", "s_x"}`` (one per QuantLinear)."""
    from learning3d_tpu_torch import resolve_device
    from learning3d_tpu_torch.quant import QuantLinear, QuantPointNetClassifier

    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def layers(key):
        return [QuantLinear(t(q["w_q"]), t(q["s_w"]), t(q["b"]), t(q["s_x"])) for q in arrays[key]]

    return QuantPointNetClassifier(t(arrays["w1"]), t(arrays["b1"]), layers("enc"), layers("head"),
                                   t(arrays["w_out"]), t(arrays["b_out"]))


def load_quant_dcp(model, flat, scales, int8_scales=None, int8_pv=False):
    """The int8 serving clone of a port DCP whose float weights equal the
    JAX model's, from the JAX ``quantize_dcp`` clone: ``flat`` holds its nnx
    state (the int8 blocks' variables under their dotted paths, e.g.
    ``pointer.enc_layers.0.self_attn.wq_q``), ``scales`` maps each block's
    path to its Python-float scales (``s_in_q``, ..., ``s_att`` of a
    QuantMHA; ``s_in``, ``s_h`` of a QuantFF), ``int8_scales`` is the
    encoder's ``emb_nn.int8_scales``. ``model`` is untouched."""
    import copy

    from learning3d_tpu_torch.quant import QuantFF, QuantMHA, _pointer_blocks

    clone = copy.deepcopy(model).eval()
    dev = next(clone.parameters()).device
    for owner, attr, kind, path in _pointer_blocks(clone.pointer):
        inner = getattr(owner, attr)
        names = ("wq_q", "s_wq", "bq", "wkv_q", "s_wkv", "bkv", "wo_q", "s_wo", "bo") if kind == "mha" else \
            ("w1_q", "s_w1", "b1", "w2_q", "s_w2", "b2")
        tensors = {n: torch.from_numpy(np.array(flat[f"{path}.{n}"], copy=True)).to(dev) for n in names}
        if kind == "mha":
            block = QuantMHA(inner.h, inner.d_k, tensors, scales[path], int8_pv, inner.wo.dtype)
        else:
            block = QuantFF(tensors, scales[path], inner.w2.dtype)
        setattr(owner, attr, block)
    if int8_scales is not None:
        clone.emb_nn.int8_scales = int8_scales
    return clone
