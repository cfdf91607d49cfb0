"""PRNet, partial-to-partial registration with keypoints, counterpart of
``learning3d_tpu/models/prnet.py``: a PRNet-local encoder (``PRDGCNN``,
whose graph is recomputed at every stage, or ``PRPointNet``), the
co-attention Transformer pointer, KeyPointNet (top-k points by embedding
norm), TemperatureNet and an SVD head with a temperature-scaled softmax (or
straight-through Gumbel) correspondence, iterated ``num_iters`` times with
the transforms composed. Given ``igt`` the forward also returns the
reference's discounted training loss.

On the card, every PRDGCNN stage's kNN is one launch of K8
(``ops.geometry.knn``, inside the JAX package's gate: N >= 512, C <= 256,
k <= 64), over xyz and then over 64, 64 and 128 feature channels, and the
pointer's six attention calls a pass run K6: at the configuration of
``examples/train.py`` (a partial source of 768 points, a template of 1024,
3 iterations) 16 K8 and 18 K6 launches a forward. The template's
embedding is computed once a forward, outside the loop, as in the JAX
package.

Departure: the Gumbel sampler draws its uniforms from a ``torch.Generator``
the head owns, where the JAX package draws from ``rngs.gumbel``; PRNet
itself builds the softmax head, as the JAX package does.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.ops import se3
from learning3d_tpu_torch.ops.geometry import index_points, knn
from learning3d_tpu_torch.ops.transforms import transform_point_cloud
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, _compute_dtype, to_bnc, validate_input_shape
from learning3d_tpu_torch.utils.svd import procrustes_from_correspondence
from learning3d_tpu_torch.utils.transformer import Identity, Transformer


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _matmul3(a, b):
    """a @ b for (..., 3, 3) matrices, products summed elementwise (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _matvec3(a, v):
    return (a * v[..., None, :]).sum(-1)


def cycle_consistency(R_ab, t_ab, R_ba, t_ba):
    """MSE(R_ab R_ba, I) + MSE(t_ab, -t_ba)."""
    eye = torch.eye(3, dtype=R_ab.dtype, device=R_ab.device)
    return torch.mean((_matmul3(R_ab, R_ba) - eye) ** 2) + torch.mean((t_ab + t_ba) ** 2)


class PRPointNet(nn.Module):
    """PRNet's PointNet: bias-free per-point convs, BatchNorm, ReLU."""

    def __init__(self, emb_dims: int = 512, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.emb_dims = emb_dims
        dims = [3, 64, 64, 64, 128, emb_dims]
        self.convs = nn.ModuleList(Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device)
                                   for i, o in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for o in dims[1:])

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv(x)))
        return x


class PRDGCNN(nn.Module):
    """PRNet's dynamic-graph DGCNN: the kNN graph recomputed on each stage's
    input, LeakyReLU(0.2). The edge conv on concat(neighbor, center) runs as
    two products, ``zn = h @ W[:C]`` and ``zc = h @ W[C:]``, gathered and
    added after (the same math, k times fewer products). In train mode
    BatchNorm takes its statistics over the (B, N, k, Co) edge tensor; in
    eval mode BN is a per-channel affine s z + b and LeakyReLU is monotone,
    so the max over the neighbors is taken of zn first (its min where s <
    0) and the affine and LeakyReLU run on (B, N, Co)."""

    def __init__(self, emb_dims: int = 512, k: int = 20, approx_knn: bool = False, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.emb_dims = emb_dims
        self.k = k
        self.approx_knn = approx_knn
        dims = [(6, 64), (128, 64), (128, 128), (256, 256), (512, emb_dims)]
        self.convs = nn.ModuleList(Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device)
                                   for i, o in dims)
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for _, o in dims)

    def forward(self, x):
        stage_outputs = []
        h = x
        for conv, bn in zip(self.convs[:4], self.bns[:4]):
            idx = knn(h, self.k, approx=self.approx_knn)  # (B, N, k); K8 on the card
            C = h.shape[-1]
            dt = _compute_dtype(conv.dtype, h, conv.weight)
            hd, w = h.to(dt), conv.weight.to(dt)
            zn = F.linear(hd, w[:, :C])  # neighbor term (B, N, Co)
            zc = F.linear(hd, w[:, C:])  # center term (B, N, Co)
            if bn.use_running():
                inv = torch.rsqrt(bn.running_var + bn.eps)
                s = (bn.weight * inv).to(zn.dtype)
                b = (bn.bias - bn.running_mean * bn.weight * inv).to(zn.dtype)
                g = index_points(zn, idx)  # (B, N, k, Co)
                v = torch.where(s >= 0, torch.amax(g, dim=2), torch.amin(g, dim=2))
                h = _lrelu(s * (v + zc) + b)
            else:
                z = index_points(zn, idx) + zc[:, :, None, :]
                h = torch.amax(_lrelu(bn(z)), dim=2)  # (B, N, Co)
            stage_outputs.append(h)
        cat = torch.cat(stage_outputs, dim=-1)  # (B, N, 512)
        return _lrelu(self.bns[4](self.convs[4](cat)))


class TemperatureNet(nn.Module):
    """The softmax temperature from the disparity |mean(src) - mean(tgt)| of
    the two embeddings: three Linear + BatchNorm + ReLU layers, a Linear to
    one value, ReLU, clipped to [1 / temp_factor, temp_factor]. Returns
    (temperature (B, 1), disparity (B, E))."""

    def __init__(self, emb_dims, temp_factor=100.0, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.temp_factor = temp_factor
        dims = [emb_dims, 128, 128, 128]
        self.layers = nn.ModuleList(Linear(i, o, dtype=dtype, generator=generator, device=device)
                                    for i, o in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for o in dims[1:])
        self.head = Linear(128, 1, dtype=dtype, generator=generator, device=device)

    def forward(self, src_embedding, tgt_embedding):
        residual = torch.abs(torch.mean(src_embedding, dim=1) - torch.mean(tgt_embedding, dim=1))
        x = residual
        for lin, bn in zip(self.layers, self.bns):
            x = torch.relu(bn(lin(x)))
        temp = torch.relu(self.head(x))
        return torch.clamp(temp, 1.0 / self.temp_factor, self.temp_factor), residual


class PRSVDHead(nn.Module):
    """Soft correspondences src_corr = probs @ tgt, probs from the scores
    src_emb tgt_emb^T / sqrt(E) by a temperature-scaled softmax
    (``"softmax"``) or a straight-through Gumbel softmax
    (``"gumbel_softmax"``), then the batched Kabsch solver. ``temperature``
    is a parameter the forward does not use, kept so that the weights match
    the JAX package's; its uniforms for the Gumbel noise come from
    ``generator``, owned by the head (seeded with 0 by default)."""

    def __init__(self, emb_dims, cat_sampler="softmax", *, generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if cat_sampler not in ("softmax", "gumbel_softmax"):
            raise ValueError(cat_sampler)
        device = resolve_device(device)
        self.cat_sampler = cat_sampler
        self.temperature = nn.Parameter(0.5 * torch.ones(1, device=device))
        if generator is None and cat_sampler == "gumbel_softmax":
            generator = torch.Generator(device=device).manual_seed(0)
        self.generator = generator

    def uniform(self, shape, device):
        """The Gumbel sampler's uniforms in [0, 1)."""
        return torch.rand(shape, generator=self.generator, device=device)

    def forward(self, src_emb, tgt_emb, src, tgt, temperature):
        d_k = src_emb.shape[-1]
        scores = torch.matmul(src_emb, tgt_emb.transpose(-1, -2)) / math.sqrt(d_k)
        temp = temperature.reshape(-1, 1, 1)
        if self.cat_sampler == "softmax":
            probs = torch.softmax(temp * scores, dim=-1)
        else:
            u = self.uniform(scores.shape, scores.device)
            g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
            soft = torch.softmax((scores + g) / temp, dim=-1)
            hard = F.one_hot(torch.argmax(soft, dim=-1), scores.shape[-1]).to(soft.dtype)
            probs = (hard - soft).detach() + soft  # straight-through
        src_corr = torch.matmul(probs, tgt.to(probs.dtype))
        return procrustes_from_correspondence(src.float(), src_corr.float())


class KeyPointNet(nn.Module):
    """The ``num_keypoints`` points of largest embedding norm of each cloud,
    in ``jax.lax.top_k``'s order: largest first, equal norms to the smaller
    index (a stable descending sort; ``torch.topk`` promises no tie order)."""

    def __init__(self, num_keypoints):
        super().__init__()
        self.num_keypoints = num_keypoints

    def _top(self, emb):
        norm = torch.linalg.vector_norm(emb, dim=-1)
        return torch.sort(norm, dim=-1, descending=True, stable=True)[1][..., :self.num_keypoints]

    def forward(self, src, tgt, src_emb, tgt_emb):
        src_idx, tgt_idx = self._top(src_emb), self._top(tgt_emb)
        return (index_points(src, src_idx), index_points(tgt, tgt_idx), index_points(src_emb, src_idx),
                index_points(tgt_emb, tgt_idx))


class PRNet(nn.Module):
    # PRNet estimates source -> template from (source, template), the
    # opposite argument order of the other registration models
    forward_arg_order = "source_template"

    def __init__(self, emb_nn: str = "dgcnn", attention: str = "transformer", head: str = "svd",
                 emb_dims: int = 512, num_keypoints: int = 512, num_subsampled_points: int = 768,
                 num_iters: int = 3, cycle_consistency_loss: float = 0.1, feature_alignment_loss: float = 0.1,
                 discount_factor: float = 0.9, input_shape: str = "bnc", approx_knn: bool = False, *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.emb_dims = emb_dims
        self.num_keypoints = num_keypoints
        self.num_iters = num_iters
        self.discount_factor = discount_factor
        self.feature_alignment_loss = feature_alignment_loss
        self.cycle_consistency_loss = cycle_consistency_loss
        self.input_shape = validate_input_shape(input_shape)
        kw = dict(dtype=dtype, generator=generator, device=device)
        if emb_nn == "pointnet":
            self.emb_nn = PRPointNet(emb_dims, **kw)
        elif emb_nn == "dgcnn":
            self.emb_nn = PRDGCNN(emb_dims, approx_knn=approx_knn, **kw)
        else:
            raise ValueError(emb_nn)
        if attention == "identity":
            self.attention = Identity()
        elif attention == "transformer":
            self.attention = Transformer(emb_dims, n_blocks=1, dropout=0.0, ff_dims=1024, n_heads=4, **kw)
        else:
            raise ValueError(attention)
        self.temp_net = TemperatureNet(emb_dims, 100.0, **kw)
        if head != "svd":
            raise ValueError(head)
        self.head = PRSVDHead(emb_dims, "softmax", device=device)
        self.keypointnet = KeyPointNet(num_keypoints) if num_keypoints != num_subsampled_points else None

    def _predict_embedding(self, src, tgt, tgt_emb):
        src_emb = self.emb_nn(src)
        src_p, tgt_p = self.attention(src_emb, tgt_emb)
        src_emb = src_emb + src_p
        tgt_emb = tgt_emb + tgt_p
        if self.keypointnet is not None:
            src, tgt, src_emb, tgt_emb = self.keypointnet(src, tgt, src_emb, tgt_emb)
        temperature, disparity = self.temp_net(src_emb, tgt_emb)
        return src, tgt, src_emb, tgt_emb, temperature, disparity

    def _spam(self, src, tgt, tgt_emb_raw):
        s, t, src_emb, tgt_emb, temp, disparity = self._predict_embedding(src, tgt, tgt_emb_raw)
        R_ab, t_ab = self.head(src_emb, tgt_emb, s, t, temp)
        R_ba, t_ba = self.head(tgt_emb, src_emb, t, s, temp)
        return R_ab, t_ab, R_ba, t_ba, disparity

    def forward(self, source, template, igt=None):
        """source/template (B, N, 3); est_* map source -> template. Pass igt
        (B, 4, 4), or an (R, t) tuple, the ground truth of source ->
        template, to also get the discounted training loss in
        result["loss"]."""
        src = to_bnc(source, self.input_shape)
        tgt = to_bnc(template, self.input_shape)
        calculate_loss = igt is not None
        if calculate_loss:
            R_gt, t_gt = igt if isinstance(igt, tuple) else (igt[:, :3, :3], igt[:, :3, 3])

        B = src.shape[0]
        eye = torch.eye(3, dtype=src.dtype, device=src.device)
        R_ab_pred = eye.expand(B, 3, 3)
        t_ab_pred = torch.zeros((B, 3), dtype=src.dtype, device=src.device)
        R_ba_pred = eye.expand(B, 3, 3)
        t_ba_pred = torch.zeros((B, 3), dtype=src.dtype, device=src.device)

        # the template never moves: its embedding is computed once (train-mode
        # BN normalizes each call by its own batch, so the output is the
        # reference's, which embeds it every iteration)
        tgt_emb_raw = self.emb_nn(tgt)

        total_loss = 0.0
        for i in range(self.num_iters):
            R_ab_i, t_ab_i, R_ba_i, t_ba_i, disparity = self._spam(src, tgt, tgt_emb_raw)
            R_ab_pred = _matmul3(R_ab_i, R_ab_pred)
            t_ab_pred = _matvec3(R_ab_i, t_ab_pred) + t_ab_i
            R_ba_pred = _matmul3(R_ba_i, R_ba_pred)
            t_ba_pred = _matvec3(R_ba_i, t_ba_pred) + t_ba_i
            if calculate_loss:
                d = self.discount_factor ** i
                loss = (torch.mean((_matmul3(R_ab_pred.transpose(-1, -2), R_gt) - eye) ** 2)
                        + torch.mean((t_ab_pred - t_gt) ** 2)) * d
                fa = torch.mean(disparity) * self.feature_alignment_loss * d
                cc = cycle_consistency(R_ab_i, t_ab_i, R_ba_i, t_ba_i) * self.cycle_consistency_loss * d
                total_loss = total_loss + loss + fa + cc
            src = transform_point_cloud(src, R_ab_i, t_ab_i)

        result = {"est_R": R_ab_pred, "est_t": t_ab_pred, "est_T": se3.from_rt(R_ab_pred, t_ab_pred),
                  "transformed_source": src}
        if calculate_loss:
            result["loss"] = total_loss
        return result
