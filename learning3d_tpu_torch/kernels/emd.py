"""Approximate Earth Mover's Distance (approxmatch), K13: CUDA kernels in
``csrc/emd.cu``, counterpart of ``learning3d_tpu/kernels/emd.py``.

Per annealing level (level = -4^j for j = 7..-1, then 0), with
K = exp(level * d^2) over the (N, M) squared distances:

    ratioL  = remainL / (K @ remainR + 1e-9)
    sumr    = remainR * (K^T @ ratioL)
    ratioR  = min(remainR / (sumr + 1e-9), 1) * remainR
    remainR = max(0, remainR - sumr)
    W       = K * ratioL[:, None] * ratioR[None, :]   (the level's match)
    remainL = max(0, remainL - W @ 1)

The cost is sum(W * |x - y|) over the levels; the gradients hold the match
fixed (the reference's matchcostgrad): g1 = sum_m (W / C)[n, m] (x_n - y_m),
g2 likewise over n.

``emd_fwd(x, y)`` returns (cost (B,), g1 (B, N, 3), g2 (B, M, 3)) in f32
without any (N, M) matrix in device memory: on a CUDA tensor within the JAX
package's gate (``emd_kernel_ok``: N, M <= 4096, 3 channels) the kernels
recompute the distances from the coordinates in every pass; on a CPU tensor,
or off the gate on any device (where the JAX package runs ``_emd_fwd_impl``
on its accelerator too), the plain version ``_emd_fwd_reference`` runs. Both
take d^2 from exact per-coordinate differences, (d0*d0 + d1*d1) + d2*d2,
and factor the match's row and column sums the same way (below).
``emd_loss`` is differentiable: the backward scales the saved g1, g2 by the
cost's cotangent.

How the sums are factored (the kernels' arithmetic, which the plain version
repeats): the column pass of a level computes, per column m, s = sum_n
K ratioL, s_c = sum_n K ratioL / C and s_cx = sum_n K ratioL / C x_n, from
which ratioR follows and then the column sums of W / C are ratioR * s_c and
ratioR * s_cx; the row pass computes, per row n, sums over m of K ratioR,
K ratioR C, K ratioR / C and K ratioR / C y_m, which times ratioL are the row
sums of W, W C, W / C and W / C y. 1 / C is taken once per pair.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

_EPS = 1e-9
LEVELS = tuple([-float(4**j) for j in range(7, 0, -1)] + [-1.0, -0.25, 0.0])  # j = 7..-1, then 0
MAX_POINTS = 4096
CHUNK_BYTES = 1 << 28  # the plain version's (b, N, M) f32 tensors stay under 256 MiB a batch chunk


def _multipliers(n, m):
    """(multiL, multiR): the larger cloud's points share the smaller's mass."""
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


def emd_kernel_ok(x, y):
    """The JAX package's gate ``_use_emd_pallas`` without its platform test:
    N, M <= 4096 and 3 channels."""
    return x.shape[1] <= MAX_POINTS and y.shape[1] <= MAX_POINTS and x.shape[2] == 3


def _sqdist(x, y):
    """Exact squared distances (B, N, M), summed one coordinate at a time:
    (d0*d0 + d1*d1) + d2*d2 for 3 channels."""
    d = None
    for c in range(x.shape[-1]):
        t = x[:, :, None, c] - y[:, None, :, c]
        t = t.mul_(t)
        d = t if d is None else d.add_(t)
    return d


def _dot(w, pts, dim):
    """sum over ``dim`` of w (B, N, M) times the points' coordinates, one
    coordinate at a time (no matrix product, so no TF32): -> (B, ., C)."""
    if dim == 1:  # pts (B, N, C) against the rows
        return torch.stack([(w * pts[:, :, None, c]).sum(1) for c in range(pts.shape[-1])], -1)
    return torch.stack([(w * pts[:, None, :, c]).sum(2) for c in range(pts.shape[-1])], -1)


def _emd_chunk(x, y):
    N, M = x.shape[1], y.shape[1]
    mult_l, mult_r = _multipliers(N, M)
    d2 = _sqdist(x, y)
    c = torch.sqrt(torch.clamp(d2, min=1e-20))
    ic = 1.0 / c
    remain_l = torch.full(x.shape[:2], mult_l, device=x.device)
    rr = torch.full(y.shape[:2], mult_r, device=x.device)
    cost_row = torch.zeros(x.shape[:2], device=x.device)
    g1, g2 = torch.zeros_like(x), torch.zeros_like(y)
    ratio_l = remain_l / ((torch.exp(LEVELS[0] * d2) * rr[:, None, :]).sum(-1) + _EPS)
    for li, level in enumerate(LEVELS):
        k = torch.exp(level * d2)
        # column pass: ratioR, remainR and the column sums of W / C
        kl = k * ratio_l[:, :, None]
        s = kl.sum(1)
        klc = kl * ic
        s_c, s_cx = klc.sum(1), _dot(klc, x, 1)
        del kl, klc
        sumr = rr * s
        ratio_r = torch.clamp(rr / (sumr + _EPS), max=1.0) * rr
        rr = torch.clamp(rr - sumr, min=0.0)
        g2 = g2 + (y * (ratio_r * s_c)[..., None] - ratio_r[..., None] * s_cx)
        # row pass: the row sums of W, W C, W / C and W / C y; then the next
        # level's K @ remainR
        kr = k * ratio_r[:, None, :]
        row = kr.sum(-1)
        cost_row = cost_row + ratio_l * (kr * c).sum(-1)
        krc = kr * ic
        g1 = g1 + (x * (ratio_l * krc.sum(-1))[..., None] - ratio_l[..., None] * _dot(krc, y, 2))
        del kr, krc
        remain_l = torch.clamp(remain_l - ratio_l * row, min=0.0)
        if li + 1 < len(LEVELS):
            k = torch.exp(LEVELS[li + 1] * d2)
            ratio_l = remain_l / ((k * rr[:, None, :]).sum(-1) + _EPS)
    return cost_row.sum(-1), g1, g2


def _emd_fwd_reference(x, y):
    """The kernels' plain version: x (B, N, C), y (B, M, C) -> (cost (B,),
    g1 (B, N, C), g2 (B, M, C)) f32 (C = 3 on the kernels' gate), in
    batch chunks whose (b, N, M) f32 tensors stay under 256 MiB (some eight
    are alive at once)."""
    x, y = x.float(), y.float()
    B, N, _ = x.shape
    step = max(1, CHUNK_BYTES // (4 * N * y.shape[1]))
    parts = [_emd_chunk(x[lo : lo + step], y[lo : lo + step]) for lo in range(0, B, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _check(x, y):
    if x.ndim != 3 or y.ndim != 3 or x.shape[-1] != y.shape[-1] or x.shape[0] != y.shape[0]:
        raise ValueError(f"x and y must be (B, N, C) and (B, M, C), got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] < 1 or y.shape[1] < 1:
        raise ValueError("x and y need at least one point each")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")


def emd_kernel(x, y):
    """The CUDA kernels: x (B, N, 3), y (B, M, 3) f32 on the card, N, M <=
    4096 -> (cost (B,), g1 (B, N, 3), g2 (B, M, 3)). One call makes 22
    launches: the first row pass, a column and a row pass a level, and the
    cost's sum."""
    _check(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not emd_kernel_ok(x, y):
        raise NotImplementedError(f"K13 (approxmatch) takes N, M <= {MAX_POINTS} and 3 channels, "
                                  f"got {tuple(x.shape)}, {tuple(y.shape)}")
    x, y = x.float().contiguous(), y.float().contiguous()
    B, N, _ = x.shape
    M = y.shape[1]
    cost = torch.empty((B,), device=x.device, dtype=torch.float32)
    g1 = torch.empty((B, N, 3), device=x.device, dtype=torch.float32)
    g2 = torch.empty((B, M, 3), device=x.device, dtype=torch.float32)
    if B == 0:
        return cost, g1, g2
    scratch = torch.empty((B * (3 * N + 2 * M),), device=x.device, dtype=torch.float32)
    mult_l, mult_r = _multipliers(N, M)
    _build.launch("emd_fwd", x.device, x.data_ptr(), y.data_ptr(), cost.data_ptr(), g1.data_ptr(), g2.data_ptr(),
                  scratch.data_ptr(), B, N, M, mult_l, mult_r)
    LAUNCHES["_emd_fwd_pallas"] += 1
    return cost, g1, g2


def emd_fwd(x, y):
    """(cost (B,), g1 (B, N, 3), g2 (B, M, 3)) f32: the kernels on a CUDA
    tensor within the gate, the plain version otherwise."""
    _check(x, y)
    if x.device.type == "cuda" and emd_kernel_ok(x, y):
        return emd_kernel(x, y)
    return _emd_fwd_reference(x, y)



class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        cost, g1, g2 = emd_fwd(x, y)
        ctx.save_for_backward(g1, g2)
        return cost

    @staticmethod
    def backward(ctx, g):
        g1, g2 = ctx.saved_tensors
        return g[..., None, None] * g1, g[..., None, None] * g2


def emd_loss(x, y):
    """Approximate EMD cost per batch item, (B,), for x (B, N, 3) and y
    (B, M, 3). The backward treats the computed match as constant, as the
    reference's extension does."""
    return _EMD.apply(x, y)


def approx_match(x, y):
    """The full match matrix (B, N, M), x on the rows, y on the columns: the
    levels above with W accumulated (rows sum to about multiL, columns to
    multiR). For parity checks and debugging; it builds (N, M) matrices."""
    x, y = x.float(), y.float()
    N, M = x.shape[1], y.shape[1]
    mult_l, mult_r = _multipliers(N, M)
    d2 = _sqdist(x, y)
    remain_l = torch.full(x.shape[:2], mult_l, device=x.device)
    remain_r = torch.full(y.shape[:2], mult_r, device=x.device)
    match = torch.zeros_like(d2)
    for level in LEVELS:
        k = torch.exp(level * d2)
        ratio_l = remain_l / ((k * remain_r[:, None, :]).sum(-1) + _EPS)
        sumr = remain_r * (k * ratio_l[:, :, None]).sum(1)
        ratio_r = torch.clamp(remain_r / (sumr + _EPS), max=1.0) * remain_r
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
        w = k * ratio_l[:, :, None] * ratio_r[:, None, :]
        remain_l = torch.clamp(remain_l - w.sum(-1), min=0.0)
        match = match + w
    return match


def match_cost(match, x, y):
    """sum(match * |x - y|) per batch item (the reference's matchcost)."""
    c = torch.sqrt(torch.clamp(_sqdist(x.float(), y.float()), min=1e-20))
    return (match * c).sum((-2, -1))
