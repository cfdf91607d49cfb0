"""Point-cloud geometry primitives, counterpart of
``learning3d_tpu/ops/geometry.py``. Ported so far: what DGCNN, PRNet,
FlowNet3D and PPFNet need (squared distances, exact kNN of a cloud and of
queries among another cloud, neighbor gather, edge features, farthest-point
sampling, ball query, three-NN inverse-distance interpolation, the robust
angle between vectors).

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

On the card ``farthest_point_sample`` launches K14 and ``query_ball_point``
K15 (``kernels.sampling``) at every npoint and nsample: the JAX package's
TPU gates (npoint <= 1024, nsample <= 128) are its kernels' VMEM limits,
which the CUDA kernels do not have. ``get_cnt`` has no kernel (the JAX
package sends it to its CPU path) and raises on the card. ``three_nn``
takes K8 where the known cloud has >= 512 points. On a CPU tensor each
takes the JAX package's CPU path: the FPS scan, the ball query by the
matmul expansion (``square_distance``) and a sort of the in-ball indices
(not the kernel's exact differences: on a point that lies on the radius
the two can disagree), and three-NN by exact differences and a stable
sort.
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch.kernels import knn as _k8
from learning3d_tpu_torch.kernels import sampling as _sampling


def square_distance(src, dst):
    """Pairwise squared L2: (..., N, C) x (..., M, C) -> (..., N, M), by the
    matmul expansion ``(-2 dot + |src|^2) + |dst|^2`` in full float32 (no
    TF32 setting reaches it), without a (..., N, M, C) product.

    On the CPU it is the JAX package's ``square_distance`` as XLA's CPU
    backend evaluates it, the reference of the CPU tests: the cross term a
    chain of fused multiply-adds over the channels in order, each emulated
    in float64 (where the product of two float32 is exact) and rounded to
    float32, the squared norms summed channel by channel. Bit for bit at C
    <= 8, where XLA's dot is that loop (on points that lie on the radius
    the ball query's in-or-out hangs on it); at feature widths XLA sums in
    blocks, and the two differ by the sum order. The rows go in two halves,
    so that the float64 buffers stay within the bytes of the float32
    result.

    On the card there is no XLA rounding to match: each product and sum is
    rounded on its own in float32, the norms by ``torch.sum``. On an H100
    the float64 chain took 327 us a call against 130 at FlowNet3D's (16,
    256, 256) kNN, and 0.46 ms of its 12.0 ms eval forward
    (``tools/torch_square_distance_ab.py``).

    Float64 operands stay float64 (the JAX package's expansion under x64):
    the f64 parity tests hold values computed from the distances, such as
    PointConv's kernel density, to JAX's f64 ones."""
    if src.dtype == torch.float64 or dst.dtype == torch.float64:
        src, dst = src.double(), dst.double()
        dot = torch.einsum("...nc,...mc->...nm", src, dst)
        return (-2.0 * dot + torch.sum(src * src, -1)[..., :, None]) + torch.sum(dst * dst, -1)[..., None, :]
    src, dst = src.float(), dst.float()
    if src.device.type == "cuda":
        dot = src[..., :, None, 0] * dst[..., None, :, 0]
        for c in range(1, src.shape[-1]):
            dot += src[..., :, None, c] * dst[..., None, :, c]
        return (-2.0 * dot + torch.sum(src * src, -1)[..., :, None]) + torch.sum(dst * dst, -1)[..., None, :]
    n = src.shape[-2]
    half = max(1, (n + 1) // 2)
    src64, dst64 = src.double(), dst.double()
    dot = torch.cat([_fma_dot(src[..., lo : lo + half, :], dst, src64[..., lo : lo + half, :], dst64)
                     for lo in range(0, max(n, 1), half)], dim=-2)
    return (-2.0 * dot + _sq_norm(src)[..., :, None]) + _sq_norm(dst)[..., None, :]


def _fma_dot(src, dst, src64, dst64):
    dot = src[..., :, None, 0] * dst[..., None, :, 0]
    for c in range(1, src.shape[-1]):
        dot = torch.addcmul(dot.double(), src64[..., :, None, c], dst64[..., None, :, c]).float()
    return dot


def _sq_norm(v):
    out = v[..., 0] * v[..., 0]
    for c in range(1, v.shape[-1]):
        out = out + v[..., c] * v[..., c]
    return out


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


def farthest_point_sample(xyz, npoint, generator=None):
    """Farthest-point sampling -> indices (B, npoint) int64. ``generator=None``
    starts every item at point 0; a ``torch.Generator`` draws each item's
    start uniformly from [0, N) with ``torch.randint`` (the JAX package
    draws it from a PRNG key: the same distribution, another stream). K14
    on the card, the scan on the CPU (``fps_pallas`` dispatches)."""
    B, N, _ = xyz.shape
    start = None
    if generator is not None:
        start = torch.randint(0, N, (B,), generator=generator, device=generator.device).to(xyz.device)
    return _sampling.fps_pallas(xyz.detach(), npoint, start=start).long()


def gather_operation(points, idx):
    """pointnet2's ``gather_operation``, channel-last."""
    return index_points(points, idx)


grouping_operation = index_points


def query_ball_point(radius, nsample, xyz, new_xyz, get_cnt=False):
    """Ball query: for each query of new_xyz (B, S, 3) the indices (B, S,
    nsample) int64 of the points of xyz (B, N, 3) within ``radius``, in
    ascending order, the first nsample, padded with the first in-ball index
    (N everywhere where none is in the ball); with ``get_cnt`` also the
    number in the ball (B, S), on the CPU only. K15 on the card; on the CPU
    JAX's CPU path: the matmul expansion (``square_distance``) against
    ``radius * radius``."""
    B, N, _ = xyz.shape
    if xyz.device.type == "cuda":
        if get_cnt:
            raise NotImplementedError("query_ball_point(get_cnt=True) has no kernel on the card (K15 returns the "
                                      "indices only)")
        return _sampling.ball_query_pallas(radius, nsample, xyz, new_xyz, dtype=torch.int64)  # K15 writes int64
    sqrdists = square_distance(new_xyz.detach(), xyz.detach())  # (B, S, N)
    r2 = torch.tensor(np.float32(float(radius) * float(radius)), device=xyz.device)
    cols = torch.arange(N, device=xyz.device)
    group_idx = torch.where(sqrdists > r2, N, cols)
    group_sorted = torch.topk(group_idx, nsample, dim=-1, largest=False, sorted=True).values
    out = torch.where(group_sorted == N, group_sorted[..., :1], group_sorted)
    if get_cnt:
        return out, (group_idx != N).sum(-1)
    return out


def ball_query_pad_first(radius, nsample, xyz, new_xyz):
    """pointnet2's ball query (the first nsample in-ball indices in scan
    order, padded with the first): the same result as
    ``query_ball_point``, under FlowNet3D's name for it."""
    return query_ball_point(radius, nsample, xyz, new_xyz)


def _xyz_sq_dist(diff):
    """``(d0*d0 + d1*d1) + d2*d2`` over the last axis of 3, each operation
    rounded on its own (K8's C == 3 arithmetic)."""
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def three_nn(unknown, known):
    """The 3 nearest points of known (B, M, 3) to each point of unknown (B,
    N, 3) -> (dist (B, N, 3), the L2 distance, not squared; idx (B, N, 3)
    int64), nearest first, ties to the smaller index. Exact per-coordinate
    differences, so a coincident point gives 0 exactly. On the card where M
    >= 512 (JAX's TPU gate) K8 selects on detached operands and the
    distances are recomputed from the gathered neighbours, so that the
    gradient reaches the selected pairs as on the dense path."""
    if unknown.ndim == 3 and known.shape[-2] >= 512 and unknown.device.type == "cuda":
        idx = _k8.knn_pallas(unknown.detach(), known.detach(), 3)[1].long()
        d = _xyz_sq_dist(unknown[..., :, None, :] - index_points(known, idx))
        return torch.sqrt(torch.clamp(d, min=0.0)), idx
    d = _xyz_sq_dist(unknown[..., :, None, :] - known[..., None, :, :])  # (B, N, M)
    val, idx = _smallest(d, 3)
    return torch.sqrt(torch.clamp(val, min=0.0)), idx


def three_interpolate(points, idx, weight):
    """Inverse-distance-weighted 3-NN interpolation: points (B, M, C); idx,
    weight (B, N, 3) -> (B, N, C), the three terms summed in order."""
    g = index_points(points, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return (g[..., 0, :] * w[..., 0, :] + g[..., 1, :] * w[..., 1, :]) + g[..., 2, :] * w[..., 2, :]


def three_interpolate_weights(dist, eps=1e-8):
    """Inverse-distance weights: w = (1/(d + eps)) / sum(1/(d + eps))."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def angle(v1, v2, eps=1e-12):
    """The angle between vector batches, atan2(|v1 x v2|, v1 . v2), as the
    JAX package's ``angle``: where |v1 x v2|^2 <= eps the cross norm is
    flushed to 0 (angles below ~1e-6 between unit vectors become 0 or pi),
    and where also |v1 . v2| <= eps (a zero vector, such as the offset of a
    neighbour slot padded with the center) the pair is pinned to atan2(0, 1)
    = 0. The double where keeps the gradient finite (zero) at those points,
    where sqrt and atan2 have none. v1 and v2 broadcast against each other
    over the leading axes; the last axis is 3."""
    v1, v2 = torch.broadcast_tensors(v1, v2)
    cross = torch.linalg.cross(v1, v2, dim=-1)
    s = torch.sum(cross * cross, dim=-1)
    dot = torch.sum(v1 * v2, dim=-1)
    safe_s = s > eps
    cross_norm = torch.where(safe_s, torch.sqrt(torch.where(safe_s, s, torch.ones_like(s))), torch.zeros_like(s))
    degen = ~safe_s & (torch.abs(dot) <= eps)
    y = torch.where(degen, torch.zeros_like(cross_norm), cross_norm)
    x = torch.where(degen, torch.ones_like(dot), dot)
    return torch.atan2(y, x)
