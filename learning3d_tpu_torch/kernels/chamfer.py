"""Chamfer nearest neighbour, K12: one CUDA kernel (``csrc/chamfer.cu``),
counterpart of ``learning3d_tpu/kernels/chamfer.py``.

``nn_oneway(x, y)``: for each point of x (B, N, 3) its squared distance to
the nearest point of y (B, M, 3) and that point's index, over exact f32
squared distances ``(d0*d0 + d1*d1) + d2*d2`` of per-coordinate differences
(no FMA), ties to the smaller index: what the TPU kernel
``_nn_oneway_pallas`` computes. ``nn_distance`` runs both directions, one
launch each; ``chamfer_distance`` is differentiable, its backward replaying
gathers and scatter-adds from the saved argmins (the JAX package has no
backward kernel).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version ``_nn_oneway_reference``, the same arithmetic with torch ops. The
JAX package's CPU path, ``_nn_oneway_xla``, selects by the matmul expansion
|x|^2 + |y|^2 - 2 x.y instead: the two can differ on near-ties only.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

CHUNK_BYTES = 1 << 30  # the plain version's (b, N, M) f32 distances stay under 1 GiB a batch chunk


def _nn_oneway_reference(x, y):
    """The kernel's plain version: x (B, N, 3), y (B, M, 3) f32 -> (min
    squared distance (B, N) f32, argmin (B, N) int32). The distances are
    summed one coordinate at a time, in the kernel's order, so no (B, N, M,
    3) tensor exists; batches go in chunks whose (b, N, M) distances stay
    under 1 GiB. ``torch.min`` returns the first of equal minima."""
    x, y = x.float(), y.float()
    B, N, _ = x.shape
    M = y.shape[1]
    step = max(1, CHUNK_BYTES // (4 * N * M))
    dists, idxs = [], []
    for lo in range(0, B, step):
        xs, ys = x[lo : lo + step], y[lo : lo + step]
        d = None
        for c in range(3):
            t = xs[:, :, None, c] - ys[:, None, :, c]
            t = t.mul_(t)
            d = t if d is None else d.add_(t)
        m, i = torch.min(d, dim=-1)
        dists.append(m)
        idxs.append(i.to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


def _check(x, y):
    if x.ndim != 3 or y.ndim != 3 or x.shape[-1] != 3 or y.shape[-1] != 3 or x.shape[0] != y.shape[0]:
        raise ValueError(f"x and y must be (B, N, 3) and (B, M, 3), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] < 1 or y.shape[1] < 1:
        raise ValueError("x and y need at least one point each")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")


def nn_oneway(x, y):
    """x (B, N, 3), y (B, M, 3) -> (min squared distance (B, N) f32, argmin
    (B, N) int32). One kernel launch on a CUDA tensor, the plain version on
    a CPU one."""
    _check(x, y)
    if x.device.type == "cpu":
        return _nn_oneway_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x, y = x.float().contiguous(), y.float().contiguous()
    B, N, _ = x.shape
    d = torch.empty((B, N), device=x.device, dtype=torch.float32)
    idx = torch.empty((B, N), device=x.device, dtype=torch.int32)
    if B == 0:
        return d, idx
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nn_oneway(x.data_ptr(), y.data_ptr(), d.data_ptr(), idx.data_ptr(), B, N, y.shape[1], stream)
    _build.check(err, "nn_oneway")
    LAUNCHES["_nn_oneway_pallas"] += 1
    return d, idx


def nn_distance(x, y):
    """Both directions: x (B, N, 3), y (B, M, 3) -> (d1 (B, N), idx1 (B, N),
    d2 (B, M), idx2 (B, M)), d the squared distance to the nearest point of
    the other cloud, in f32. No gradient flows through this (use
    ``chamfer_distance``)."""
    x, y = x.float(), y.float()
    d1, i1 = nn_oneway(x, y)
    d2, i2 = nn_oneway(y, x)
    return d1, i1, d2, i2


def _gather_pts(pts, idx):
    return torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, pts.shape[-1]))


def _scatter_add(like, idx, vals):
    """Per-batch scatter-add of vals (B, M, 3) into the rows idx (B, M) of a
    zero tensor shaped like ``like``."""
    return torch.zeros_like(like).scatter_add_(1, idx.long()[..., None].expand_as(vals), vals)


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        d1, i1, d2, i2 = nn_distance(x, y)
        ctx.save_for_backward(x, y, i1, i2)
        return d1, d2

    @staticmethod
    def backward(ctx, g1, g2):
        x, y, i1, i2 = ctx.saved_tensors
        x, y = x.float(), y.float()  # autograd casts the gradients back to the inputs' dtype
        y_near = _gather_pts(y, i1)  # nearest y for each x
        x_near = _gather_pts(x, i2)  # nearest x for each y
        # d|x - y*|^2/dx, and the scatter of d|y - x*|^2/dx* contributions
        dx = 2.0 * g1[..., None] * (x - y_near)
        dx = dx + _scatter_add(x, i2, 2.0 * g2[..., None] * (x_near - y))
        dy = 2.0 * g2[..., None] * (y - x_near)
        dy = dy + _scatter_add(y, i1, 2.0 * g1[..., None] * (y_near - x))
        return dx, dy


def chamfer_distance(x, y):
    """Differentiable two-sided squared Chamfer terms: (d1 (B, N), d2 (B,
    M)). The gradient treats the argmin matching as locally constant, as
    the reference's CUDA extension does."""
    return _Chamfer.apply(x, y)
