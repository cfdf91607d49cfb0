"""Int8 arithmetic shared by the quantized modules and the int8 kernels'
plain versions, with the JAX package's roundings.

Every scale enters as a float32 tensor on the operand's device: a CUDA
tensor divided by a Python number is multiplied by the number's reciprocal
(another rounding than true division, and than the JAX package's), while a
division by a tensor is a true division on every device.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def f32_scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a Python number or a tensor) as a 0-d float32 tensor on
    ``like``'s device; a Python float is rounded to float32 once, as JAX
    rounds a weakly typed constant."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=F32)
    return torch.full((), float(value), dtype=F32, device=like.device)


def div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s as a true float32 division on every device."""
    return torch.div(x, f32_scalar(s, x))


def to_int8(y: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp to [-127, 127], int8."""
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: w (in, out) -> (w_q int8,
    s_w (out,)) with s_w = max|w[:, j]| / 127 (at least 1e-12 / 127)."""
    w = w.to(F32)
    s = div(torch.clamp_min(torch.amax(torch.abs(w), dim=0), 1e-12), 127.0)
    return to_int8(w / s), s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, exact (int32 sums).
    A plain product outside any kernel, as the JAX package leaves it to
    XLA; ``torch._int_mm`` takes 2-D operands and, on the card, a row count
    cuBLASLt's int8 product supports (it refused 74, 1,400 and 3,000 rows on
    the H100 and took 4,096), so the rows are flattened and zero-padded to a
    multiple of 32."""
    K, N = b.shape
    a2 = a.reshape(-1, K).contiguous()
    m = a2.shape[0]
    if a2.is_cuda and m % 32:
        a2 = torch.cat([a2, a2.new_zeros((32 - m % 32, K))])
    return torch._int_mm(a2, b.contiguous())[:m].reshape(*a.shape[:-1], N)


def percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """``jnp.percentile(x.ravel(), p)`` with its linear interpolation, in
    the float32 arithmetic the JAX package's calibration runs on XLA: the
    index p * ((n - 1) * 0.01) in float32 (XLA folds the division by 100
    into the constant), the two order statistics around it, and
    v_lo * w_lo + v_hi * w_hi with the second product fused into the add.
    Works on any size (``torch.quantile`` refuses inputs above 2^24
    elements): the order statistics come from one ``topk`` of the
    n - floor(index) largest values. Returns a 0-d float32 tensor on x's
    device."""
    a = x.reshape(-1).to(F32)
    n = a.numel()
    pos = torch.tensor(p, dtype=F32) * (torch.tensor(n - 1, dtype=F32) * torch.tensor(0.01, dtype=F32))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = torch.tensor(1.0, dtype=F32) - w_hi
    lo_i = int(min(max(lo.item(), 0), n - 1))
    hi_i = int(min(max(hi.item(), 0), n - 1))
    top = torch.topk(a, n - lo_i, sorted=True).values  # descending: top[n - 1 - i] is the i-th smallest
    v_lo, v_hi = top[n - 1 - lo_i], top[n - 1 - hi_i]
    low = (v_lo * f32_scalar(w_lo, a)).double()
    return (v_hi.double() * float(w_hi) + low).to(F32)
