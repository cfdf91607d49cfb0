"""The train-mode fused PointNet tail's kernels, counterpart of
``learning3d_tpu/kernels/poolgrad.py``: K3 ``pool_stats`` (forward
statistics of conv5 + BatchNorm + ReLU + max-pool) and K4 ``pool_bwd`` (its
sparse max-pool backward), both in ``csrc/poolgrad.cu``.

K3 computes z = x W + c without writing it and returns what the Gram-matrix
batch statistics and the sparse backward need: per (cloud, channel) the max,
min, argmax and argmin of z over the points (ties to the smaller point
index), the K x K Gram matrix sum_bn x x^T and the column sum of x. K4
scatters the pooled cotangents back: dx_sp[b, idx[b,e], :] +=
dsel[b,e] W[:, e] (dense, zeros elsewhere) and dW_sel[:, e] =
sum_b x[b, idx[b,e], :] dsel[b,e].

On the card K3 reads W^T through a weight pack, the bf16 image of
wgmma's K-major operand (``stats_weight_image`` states its bytes), and x
through TMA tiles; f32 operands go through a bf16 hi/lo split.

A wrapper takes its kernel's plain version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. The plain versions repeat the
kernels' arithmetic (not the XLA branch of ``utils.layers``): K3's z is f32
from the operands as given (bf16 products are exact), K4 rounds dsel to bf16
for the dx product when W is bf16, as the TPU kernel's one-hot tile is
rounded, and takes it in f32 for dW.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

KERNEL_K = 128  # the kernels' input width: PointNet's conv5 reads 128 channels
MAX_E_BWD = 4096  # K4 keeps e in the low 12 bits of a list entry
MAX_N_BWD = (1 << 20) - 1  # its C entry takes N < 2**20
# K4's dx_sp schedule (``csrc/poolgrad.cu``): rows a block, warps a block
# (each a contiguous range of e in the compaction), W^T rows a row loads
# before their FMAs
BWD_ROW_TILE = 128
BWD_WARPS = 8
BWD_KEY_BATCH = 4


def pool_stats_ok(N, E, K):
    """The JAX package's shape gate for K3 (lane-aligned K and E)."""
    return K % 128 == 0 and E % 128 == 0


def pool_bwd_ok(N, E, K):
    """The JAX package's shape gate for K4."""
    return K % 128 == 0 and E % 128 == 0


def pool_stats_reference(x, W, c):
    """K3's plain version: x (B, N, K), W (K, E), c (E) -> (mx, mn, amax,
    amin, G, colsum). z in f32 from the operands as given; argmax/argmin
    take the first of equal values."""
    f32 = torch.float32
    B, N, K = x.shape
    xf = x.to(f32)
    z = torch.matmul(xf, W.to(f32)) + c.to(f32)
    mx, mn = z.amax(1), z.amin(1)
    row = torch.arange(N, device=x.device).view(1, N, 1)
    amax = torch.where(z == mx[:, None, :], row, N).amin(1).to(torch.int32)
    amin = torch.where(z == mn[:, None, :], row, N).amin(1).to(torch.int32)
    flat = xf.reshape(B * N, K)
    return mx, mn, amax, amin, flat.t() @ flat, flat.sum(0)


IMAGE_ROW_BYTES = 256  # a channel's 128 bf16 weights in the pack


def stats_weight_image(W):
    """The bytes K3's weight pack writes (``csrc/poolgrad.cu``, ``pack_kernel``),
    stated in torch: W^T (E rows, the output channels) in blocks of 64
    channels, each two boxes of 64 rows (input channels 0..63, then 64..127)
    of 128 bytes of bf16, every row with the 128-byte swizzle (the 16-byte
    chunk c of row r stored at chunk c ^ (r % 8)): the layout wgmma reads
    K-major operands in. For f32 W a hi image, bf16(W), then a lo image,
    bf16(W - hi). W (128, E) -> uint8 (256 E,), or (512 E,) for f32."""
    wt = W.t().cpu()
    parts = [wt.to(torch.bfloat16)]
    if W.dtype == torch.float32:
        parts.append((wt - parts[0].float()).to(torch.bfloat16))
    out = []
    for part in parts:
        rows = part.reshape(-1, 64, 2, 64).permute(0, 2, 1, 3).reshape(-1, 64)  # (block, box, row) x 64
        phys = torch.arange(8)[None, :] ^ (torch.arange(rows.shape[0]) % 8)[:, None]
        swizzled = torch.gather(rows.reshape(-1, 8, 8), 1, phys[..., None].expand(-1, 8, 8))
        out.append(swizzled.reshape(-1).view(torch.uint8))
    return torch.cat(out)


def pool_bwd_reference(idx, dsel, W, x):
    """K4's plain version: a gather for dW_sel and one index_add_ for dx_sp
    (the clouds' rows offset by b * N, so each cloud scatters into its own
    rows). No dense (B, N, E) one-hot is built."""
    f32 = torch.float32
    B, N, K = x.shape
    E = idx.shape[1]
    d = dsel.to(f32)
    coef = d.to(torch.bfloat16).to(f32) if W.dtype == torch.bfloat16 else d
    rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    vals = (coef[:, :, None] * W.to(f32).t()[None]).reshape(B * E, K)
    dx = torch.zeros(B * N, K, device=x.device, dtype=f32).index_add_(0, rows, vals).view(B, N, K)
    x_sel = torch.gather(x, 1, idx.long()[:, :, None].expand(B, E, K)).to(f32)
    return dx, torch.einsum("bek,be->ke", x_sel, d)


def _kernel_dtype(x, W):
    if x.dtype not in (torch.bfloat16, torch.float32) or W.dtype != x.dtype:
        raise ValueError(f"x and W must be both bf16 or both f32, got {x.dtype} and {W.dtype}")
    return x.dtype == torch.float32


def _check_stats_args(x, W, c):
    if x.ndim != 3 or W.ndim != 2 or c.shape != (W.shape[1],) or W.shape[0] != x.shape[2]:
        raise ValueError(f"shapes x {tuple(x.shape)}, W {tuple(W.shape)}, c {tuple(c.shape)}")
    B, N, K = x.shape
    E = W.shape[1]
    if K != KERNEL_K or E % 128 or E == 0:
        raise NotImplementedError(f"K3 (pool_stats) takes K == {KERNEL_K} and E % 128 == 0, got K={K}, E={E}")
    if B < 1 or N < 1:
        raise NotImplementedError(f"K3 (pool_stats) takes B >= 1 and N >= 1, got B={B}, N={N}")
    if W.device != x.device or c.device != x.device:
        raise ValueError("x, W and c must be on one device")


def pool_stats(x, W, c):
    """x (B, N, K) and W (K, E), both bf16 or both f32, c (E) ->
    (mx, mn (B, E) f32, amax, amin (B, E) int32, G (K, K) f32, colsum (K)
    f32). A CUDA tensor runs K3; a CPU tensor the plain version."""
    if x.device.type == "cpu":
        return pool_stats_reference(x, W, c)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_stats_args(x, W, c)
    is_f32 = _kernel_dtype(x, W)
    f32 = torch.float32
    x, W = x.contiguous(), W.contiguous()  # the pack reads W (K, E) in place
    c = c.to(f32).contiguous()
    B, N, K = x.shape
    E = W.shape[1]
    dev = x.device
    mx, mn = torch.empty(B, E, device=dev, dtype=f32), torch.empty(B, E, device=dev, dtype=f32)
    amax = torch.empty(B, E, device=dev, dtype=torch.int32)
    amin = torch.empty(B, E, device=dev, dtype=torch.int32)
    G, colsum = torch.empty(K, K, device=dev, dtype=f32), torch.empty(K, device=dev, dtype=f32)
    gpart, cspart = torch.empty(B, K, K, device=dev, dtype=f32), torch.empty(B, K, device=dev, dtype=f32)
    img = torch.empty(IMAGE_ROW_BYTES * E * (2 if is_f32 else 1), device=dev, dtype=torch.uint8)
    xs = torch.empty(2 * x.numel() if is_f32 else 0, device=dev, dtype=torch.bfloat16)
    _build.launch("pool_stats", dev, x.data_ptr(), W.data_ptr(), c.data_ptr(), int(is_f32), mx.data_ptr(),
                  mn.data_ptr(), amax.data_ptr(), amin.data_ptr(), gpart.data_ptr(), cspart.data_ptr(), G.data_ptr(),
                  colsum.data_ptr(), img.data_ptr(), xs.data_ptr() if is_f32 else None, B, N, E)
    LAUNCHES["pool_stats_pallas"] += 1
    return mx, mn, amax, amin, G, colsum


def _check_bwd_args(idx, dsel, W, x):
    if x.ndim != 3 or W.ndim != 2 or W.shape[0] != x.shape[2] or idx.shape != (x.shape[0], W.shape[1]) \
            or dsel.shape != idx.shape:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, dsel {tuple(dsel.shape)}, W {tuple(W.shape)}, "
                         f"x {tuple(x.shape)}")
    B, N, K = x.shape
    E = W.shape[1]
    if K != KERNEL_K or not 1 <= E <= MAX_E_BWD or not 1 <= N <= MAX_N_BWD or B < 1:
        raise NotImplementedError(f"K4 (pool_bwd) takes K == {KERNEL_K}, 1 <= E <= {MAX_E_BWD} and "
                                  f"1 <= N <= {MAX_N_BWD}, got K={K}, E={E}, N={N}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if any(t.device != x.device for t in (idx, dsel, W)):
        raise ValueError("idx, dsel, W and x must be on one device")


def pool_bwd(idx, dsel, W, x):
    """idx (B, E) int32, dsel (B, E), W (K, E) and x (B, N, K), W and x both
    bf16 or both f32 -> (dx_sp (B, N, K) f32, dW_sel (K, E) f32). A CUDA
    tensor runs K4; a CPU tensor the plain version. dW_sel comes back as the
    transpose of the kernel's (E, K) output."""
    if x.device.type == "cpu":
        return pool_bwd_reference(idx, dsel, W, x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_bwd_args(idx, dsel, W, x)
    is_f32 = _kernel_dtype(x, W)
    f32 = torch.float32
    x, idx = x.contiguous(), idx.contiguous()
    dsel = dsel.to(f32).contiguous()
    wt = W.t().contiguous()
    B, N, K = x.shape
    E = wt.shape[0]
    dx = torch.empty(B, N, K, device=x.device, dtype=f32)
    dwt = torch.empty(E, K, device=x.device, dtype=f32)
    _build.launch("pool_bwd", x.device, idx.data_ptr(), dsel.data_ptr(), wt.data_ptr(), x.data_ptr(), int(is_f32),
                  dx.data_ptr(), dwt.data_ptr(), B, N, E)
    LAUNCHES["pool_bwd_pallas"] += 1
    return dx, dwt.t()
