"""Exact k-nearest-neighbour selection, K8: one CUDA kernel
(``csrc/knn.cu``), counterpart of ``learning3d_tpu/kernels/knn.py::
knn_pallas``.

``knn_pallas(queries, points, k)``: queries (B, S, C), points (B, N, C),
C <= 256, k <= 64 -> (sq_dist (B, S, k) f32, idx (B, S, k) int32), nearest
first, ties to the smaller index, the TPU kernel's contract. The squared
distance is, in f32 with every operation rounded on its own:
* C == 3: exact per-coordinate differences ``(d0*d0 + d1*d1) + d2*d2``
  (coincident points give exactly 0);
* C != 3: the expansion ``(|q|^2 - 2 q.p) + |p|^2``, the three sums taken
  one channel at a time in ascending channel order. Near-equal feature
  vectors can give a slightly negative distance, which sorts before 0.

A CUDA tensor launches the kernel, or raises NotImplementedError naming the
limit it breaks (``kernel_limit``); a CPU tensor runs the plain version
``knn_reference``, the same arithmetic with torch ops, which the kernel
matches bit for bit. The kernel has no backward: callers detach the
operands, as the JAX package does, and recompute any distance that needs a
gradient from the gathered points.

The indices are int32, as the TPU kernel's; ``ops.geometry.knn`` and
``knn_point`` widen them once to the int64 that ``torch.gather`` takes, so
that their indices have one dtype on the kernel's path and the plain one.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

MAX_K = 64
MAX_C = 256
CHUNK_BYTES = 1 << 28  # the plain version's (b, S, N) f32 intermediates stay under 256 MiB a batch chunk


def kernel_limit(channels, k):
    """The limit of K8 that (C, k) breaks, as a message, or None where the
    kernel takes the shape: 1 <= k <= MAX_K, 1 <= C <= MAX_C. Any S and any
    N >= k (which every call needs, ``_check``): the points stream through
    the kernel in tiles."""
    if not 1 <= k <= MAX_K:
        return f"K8 (knn_pallas) takes 1 <= k <= {MAX_K}, got k={k}"
    if not 1 <= channels <= MAX_C:
        return f"K8 (knn_pallas) takes 1 <= C <= {MAX_C}, got C={channels}"
    return None


def _sq_dist(q, p):
    """(b, S, N) f32 squared distances in the kernel's arithmetic."""
    if q.shape[-1] == 3:
        d = None
        for c in range(3):
            t = q[:, :, None, c] - p[:, None, :, c]
            t = t.mul_(t)
            d = t if d is None else d.add_(t)
        return d
    q_sq = q[..., 0] * q[..., 0]
    p_sq = p[..., 0] * p[..., 0]
    cross = q[:, :, None, 0] * p[:, None, :, 0]
    for c in range(1, q.shape[-1]):
        q_sq = q_sq + q[..., c] * q[..., c]
        p_sq = p_sq + p[..., c] * p[..., c]
        cross.add_(q[:, :, None, c] * p[:, None, :, c])
    return cross.mul_(-2.0).add_(q_sq[:, :, None]).add_(p_sq[:, None, :])


def knn_reference(queries, points, k):
    """The kernel's plain version: (sq_dist (B, S, k) f32, idx (B, S, k)
    int32) by a stable sort of ``_sq_dist``, so ties go to the smaller
    index. Batches go in chunks whose (b, S, N) distances stay under
    CHUNK_BYTES (-2 q.p + |q|^2 is the same f32 sum as |q|^2 - 2 q.p)."""
    q, p = queries.float(), points.float()
    B, S, _ = q.shape
    step = max(1, CHUNK_BYTES // (4 * S * p.shape[1]))
    dists, idxs = [], []
    for lo in range(0, B, step):
        d, i = torch.sort(_sq_dist(q[lo : lo + step], p[lo : lo + step]), dim=-1, stable=True)
        dists.append(d[..., :k].contiguous())
        idxs.append(i[..., :k].to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


def _check(queries, points, k):
    if queries.ndim != 3 or points.ndim != 3 or queries.shape[0] != points.shape[0] \
            or queries.shape[-1] != points.shape[-1]:
        raise ValueError(f"queries and points must be (B, S, C) and (B, N, C), got {tuple(queries.shape)} "
                         f"and {tuple(points.shape)}")
    if queries.device != points.device:
        raise ValueError(f"queries on {queries.device}, points on {points.device}")
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"k must be in [1, N={points.shape[1]}], got {k}")


def knn_pallas(queries, points, k):
    """queries (B, S, C), points (B, N, C) -> (sq_dist (B, S, k) f32, idx
    (B, S, k) int32), nearest first. One kernel launch on a CUDA tensor (past
    ``kernel_limit`` NotImplementedError), the plain version on a CPU one."""
    _check(queries, points, k)
    if queries.device.type == "cpu":
        return knn_reference(queries, points, k)
    if queries.device.type != "cuda":
        raise ValueError(f"no kernel for device {queries.device}")
    limit = kernel_limit(points.shape[-1], k)
    if limit is not None:
        raise NotImplementedError(limit)
    q, p = queries.detach().float().contiguous(), points.detach().float().contiguous()
    B, S, C = q.shape
    dist = torch.empty((B, S, k), device=q.device, dtype=torch.float32)
    idx = torch.empty((B, S, k), device=q.device, dtype=torch.int32)
    if B == 0 or S == 0:
        return dist, idx
    _build.launch("knn_select", q.device, q.data_ptr(), p.data_ptr(), dist.data_ptr(), idx.data_ptr(), B, S,
                  p.shape[1], C, k)
    LAUNCHES["knn_pallas"] += 1
    return dist, idx
