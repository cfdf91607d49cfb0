"""Point-cloud geometry primitives, counterpart of
``learning3d_tpu/ops/geometry.py``. Ported so far: what DGCNN needs
(squared distances, exact kNN, neighbor gather, edge features).

All functions are channel-last (B, N, C). Neighbor selection follows
``jax.lax.top_k``: nearest first, exact ties to the smaller index.
``torch.topk`` promises no order among ties, so the port sorts stably.
"""

from __future__ import annotations

import torch


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


def knn(points, k, include_self=True):
    """Self kNN indices (B, N, k), nearest first, exact ties to the smaller
    index (a stable sort). ``include_self=False`` drops the query point
    itself (a k+1 search, first column removed)."""
    kk = k if include_self else k + 1
    idx = torch.sort(square_distance(points, points), dim=-1, stable=True)[1][..., :kk]
    return idx if include_self else idx[..., 1:]


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
