"""Point-cloud geometry primitives, counterpart of
``learning3d_tpu/ops/geometry.py``. Ported so far: what DGCNN and PRNet
need (squared distances, exact kNN of a cloud and of queries among
another cloud, neighbor gather, edge features).

All functions are channel-last (B, N, C). Neighbor selection follows
``jax.lax.top_k``: nearest first, exact ties to the smaller index.
``torch.topk`` promises no order among ties, so the port sorts stably.

On the card, ``knn`` and ``knn_point`` launch K8 (``kernels.knn``) where
the JAX package's gate sends an exact TPU call to its Pallas kernel
(``_use_knn_kernel``), with detached operands (the kernel has no
backward); everywhere else, a CPU tensor included, they take the JAX
package's XLA path: the matmul expansion and a stable sort. ``approx`` is
accepted for the JAX signature and selects exactly: ``jax.lax.approx_min_k``
has no counterpart in PyTorch (it is exact on JAX's CPU backend too), so an
``approx=True`` call takes the same path as an exact one, K8 on the card.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import knn as _k8


def square_distance(src, dst):
    """Pairwise squared L2: (..., N, C) x (..., M, C) -> (..., N, M), by the
    matmul expansion |a|^2 + |b|^2 - 2ab, in full float32 (neighbor
    selection is sensitive to the rounding of TF32 and bf16). The inner
    products are accumulated one channel at a time in float32, so no TF32
    setting can reach them and no (..., N, M, C) product is ever held: the
    intermediates are a few (..., N, M) buffers. The channel order is that of
    a sequential sum, so at C=3 the result is bit-identical to summing the
    elementwise product over C."""
    src, dst = src.float(), dst.float()
    dot = src[..., :, None, 0] * dst[..., None, :, 0]
    for c in range(1, src.shape[-1]):
        dot += src[..., :, None, c] * dst[..., None, :, c]
    d = -2.0 * dot
    d = d + torch.sum(src * src, dim=-1)[..., :, None]
    return d + torch.sum(dst * dst, dim=-1)[..., None, :]


def _use_knn_kernel(points, k):
    """The JAX package's ``_use_knn_pallas`` gate with the card in place of
    the TPU: C <= 256, k <= 64 and N >= 512. JAX's gate also turns away
    ``approx``, for which it has another op; the port selects exactly for
    both, so both take K8."""
    return points.shape[-1] <= 256 and k <= 64 and points.shape[-2] >= 512 and points.device.type == "cuda"


def _smallest(d, k):
    """(values, indices) of the k smallest entries of the last axis, nearest
    first, ties to the smaller index (a stable sort)."""
    val, idx = torch.sort(d, dim=-1, stable=True)
    return val[..., :k], idx[..., :k]


def knn(points, k, include_self=True, approx=False):
    """Self kNN indices (B, N, k) int64, nearest first, exact ties to the
    smaller index. ``include_self=False`` drops the query point itself (a
    k+1 search, first column removed). K8 on the card inside the gate;
    ``approx`` selects exactly (module docstring)."""
    kk = k if include_self else k + 1
    if _use_knn_kernel(points, kk):
        p = points.detach()
        idx = _k8.knn_pallas(p, p, kk)[1].long()
    else:
        idx = _smallest(square_distance(points, points), kk)[1]
    return idx if include_self else idx[..., 1:]


def knn_point(k, pos1, pos2, approx=False):
    """For each query of pos2 (B, M, C) its k nearest points of pos1 (B, N,
    C): (distance (B, M, k), the L2 distance, not squared; indices (B, M,
    k) int64), nearest first. On K8's path the distance carries no gradient
    (the kernel has none; every caller uses the indices only)."""
    if _use_knn_kernel(pos1, k):
        sq, idx = _k8.knn_pallas(pos2.detach(), pos1.detach(), k)
        return torch.sqrt(torch.clamp(sq, min=0.0)), idx.long()
    val, idx = _smallest(square_distance(pos2, pos1), k)
    return torch.sqrt(torch.clamp(val, min=0.0)), idx


def index_points(points, idx):
    """Batched gather. points (B, N, C); idx (B, S) or (B, S, K) int ->
    (B, S, C) or (B, S, K, C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(idx.shape + (C,))


def get_graph_feature(x, k=20):
    """DGCNN edge features, channel-last: x (B, N, C) -> (B, N, k, 2C) =
    concat(neighbor features, center features)."""
    neighbors = index_points(x, knn(x, k))  # (B, N, k, C)
    center = x[:, :, None, :].expand(neighbors.shape)
    return torch.cat([neighbors, center], dim=-1)
