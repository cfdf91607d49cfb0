"""Fused softmax attention for the DCP pointer and the SVD head, one CUDA
kernel (``csrc/attention.cu``), counterpart of
``learning3d_tpu/kernels/attention.py::attention_pallas``.

    softmax(q k^T / sqrt(D)) v    q, k (B, H, N|M, D), v (B, H, M, Dv)

The kernel's rounding, which its plain version ``attention_reference``
repeats: bf16 operands, f32 scores scaled by the float ``1/sqrt(D)``, the
row max m and p = exp(s - m) in f32, l = sum(p) in f32, P rounded to bf16
*unnormalized*, O = (P_bf16 @ V) / l, in q's dtype. ``attention_oracle``
is the JAX package's oracle, which normalizes before the bf16 cast (another
rounding); it is the backward of ``attention_fused``.
"""

from __future__ import annotations

import ctypes

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.ops.int8 import f32_scalar

MAX_D, MAX_DV = 512, 512  # what the kernel's shared-memory tiles take (Dv in slabs)


def attention_reference(q, k, v):
    """The kernel's plain version (see the module docstring)."""
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.to(bf16).to(f32), k.to(bf16).to(f32).transpose(-1, -2)) * scale
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p.to(bf16).to(f32), v.to(bf16).to(f32))
    return (o / l).to(q.dtype)


def attention_oracle(q, k, v):
    """The JAX package's oracle: bf16 operands, f32 scores and softmax,
    P normalized before its bf16 cast."""
    f32, bf16 = torch.float32, torch.bfloat16
    s = torch.matmul(q.to(bf16).to(f32), k.to(bf16).to(f32).transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(bf16).to(f32), v.to(bf16).to(f32)).to(q.dtype)


def _aligned(t):
    """``t`` (contiguous), or a copy of it if its data is not 16-byte
    aligned: TMA reads a tensor only from a 16-byte aligned address."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_args(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, N|M, D|Dv)")
    B, H, N, D = q.shape
    M, Dv = v.shape[2], v.shape[3]
    if k.shape != (B, H, M, D) or v.shape[:2] != (B, H):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D % 16 or not 16 <= D <= MAX_D or not 1 <= Dv <= MAX_DV or N < 1 or M < 1:
        raise ValueError(f"the kernel takes D % 16 == 0, D <= {MAX_D}, Dv <= {MAX_DV}; "
                         f"got D={D}, Dv={Dv}, N={N}, M={M}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")


def attention_pallas(q, k, v):
    """softmax(q k^T / sqrt(D)) v. A CUDA tensor runs the CUDA kernel; a
    CPU tensor runs the plain version ``attention_reference``."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kernel_args(q, k, v)
    B, H, N, D = q.shape
    M, Dv = v.shape[2], v.shape[3]
    bf16 = torch.bfloat16
    qb, kb, vb = (_aligned(t.to(bf16).contiguous()) for t in (q, k, v))
    # the output in q's dtype, as the TPU kernel's: bf16 stored as such,
    # any other dtype from the kernel's f32 (so f32 is never rounded to bf16)
    out_f32 = q.dtype != bf16
    out = torch.empty((B, H, N, Dv), device=q.device, dtype=torch.float32 if out_f32 else bf16)
    _build.launch("attention_bf16", q.device, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
                  int(out_f32), B * H, N, M, D, Dv, ctypes.c_float(1.0 / D**0.5))
    LAUNCHES["attention_pallas"] += 1
    return out.to(q.dtype)


class _AttentionFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_pallas(q, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = attention_oracle(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def attention_fused(q, k, v):
    """Differentiable entry: the kernel forward; the backward recomputes
    through ``attention_oracle`` (the kernel has no backward)."""
    return _AttentionFused.apply(q, k, v)


def attention_pallas_ok(q, k, v):
    """Dispatch guard, the JAX package's without its platform test: the
    pointer and head shapes (D a multiple of 128 up to 512, 256 <= M <=
    4096, N >= 256), at any value width Dv. The kernel takes Dv <= MAX_DV;
    a caller past that on the card raises (``check_value_width``) rather
    than leave the kernel's path."""
    D, M, N = q.shape[-1], k.shape[2], q.shape[2]
    return D % 128 == 0 and D <= MAX_D and 256 <= M <= 4096 and N >= 256


def check_value_width(q, v):
    """Raise NotImplementedError for a tensor off the CPU whose value width
    the kernel does not take (Dv > MAX_DV), where the JAX package runs its
    kernel."""
    if q.device.type != "cpu" and v.shape[-1] > MAX_DV:
        raise NotImplementedError(f"K6 (attention_pallas) takes Dv <= {MAX_DV}, got Dv={v.shape[-1]}")


# --- int8 serving variant: K10 --------------------------------------------
#
# Counterpart of ``learning3d_tpu/kernels/attention.py::attention_int8``
# (body ``_attn_kernel_int8``, oracle ``attention_int8_oracle``): int8 q, k,
# v (B, H, N|M, D) with static dequantization scales; S = int32(q k^T) in
# f32 times s_q s_k / sqrt(D), p = exp(S - rowmax) left unnormalized (its
# row max is exactly 1), l = sum(p); with ``int8_pv`` O = int32(round(127 p)
# v) * (s_v / 127) / l, else ("hybrid") O = (bf16(p) @ v) * s_v / l, in
# bf16. ``csrc/attention_int8.cu``.

INT8_MAX_D = 512


def _f64_matmul(a, b):
    """An exact product of small integers (int8 sums up to 2^53) on any
    device, in float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv=False):
    """K10's plain version, a port of ``attention_int8_oracle``."""
    f32, bf16 = torch.float32, torch.bfloat16
    d = q.shape[-1]
    s = _f64_matmul(q, k.transpose(-1, -2)).to(f32) * f32_scalar(s_q * s_k / (d**0.5), q)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    l = torch.sum(p, dim=-1, keepdim=True)
    if int8_pv:
        o = _f64_matmul(torch.round(p * 127.0), v).to(f32)
        return (o * f32_scalar(s_v / 127.0, q) / l).to(bf16)
    o = torch.matmul(p.to(bf16).to(f32), v.to(bf16).to(f32))
    return (o * f32_scalar(s_v, q) / l).to(bf16)


def attention_int8_ok(q, k):
    """Dispatch guard, the JAX package's without its platform test: D a
    multiple of 128 up to 512 and 128 <= M <= 4096."""
    D, M = q.shape[-1], k.shape[2]
    return D % 128 == 0 and D <= INT8_MAX_D and 128 <= M <= 4096


def key_order(mp):
    """The key each position of K10's V^T holds, for ``mp`` keys (a
    multiple of 16): in every 16 keys, position 4t + i holds key 2t + i for
    i < 2 and key 8 + 2t + i - 2 for i >= 2. A thread's score accumulators
    hold keys 2t, 2t+1, 8+2t, 9+2t of each 16, and an int8 wgmma A fragment
    takes four consecutive k: stored in this order, a tile of V^T meets P
    in the order the accumulators hand it over in."""
    pos = torch.arange(mp)
    r = pos % 16
    t, i = r // 4, r % 4
    return pos - r + torch.where(i < 2, 2 * t + i, 6 + 2 * t + i)


PV_KEYS = 32  # K10's int8 V^T pads the keys to a multiple of this


def int8_pv_values(v):
    """(BH, M, D) int8 V -> (BH, D, Mp) V^T as K10's int8 P.V reads it: the
    keys zero-padded to Mp (a multiple of PV_KEYS) and in ``key_order``.
    Within 16 keys, key 8a + 2t + b goes to position 4t + 2a + b: a swap of
    the (a, t) axes. The plain version of ``attention_int8_values``, the
    port's kernel that makes it on the card in one coalesced pass (torch's
    strided copy took 0.114 ms at the pointer's shape on the H100)."""
    bh, m, d = v.shape
    mp = -(-m // PV_KEYS) * PV_KEYS
    if mp != m:
        v = torch.nn.functional.pad(v, (0, 0, 0, mp - m))
    return v.reshape(bh, mp // 16, 2, 4, 2, d).permute(0, 5, 1, 3, 2, 4).reshape(bh, d, mp)


def attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv=False):
    """int8 (B, H, N|M, D) q, k, v -> (B, H, N, D) bf16. A CUDA tensor runs
    K10; a CPU tensor runs the plain version ``attention_int8_reference``.

    The kernel reads V as its P.V product takes it, made first by the
    port's ``attention_int8_values`` kernel in one pass over V: with
    ``int8_pv`` V^T in ``key_order`` (its plain version ``int8_pv_values``),
    in the hybrid mode V widened to bf16."""
    if q.device.type == "cpu":
        return attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.ndim != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    if any(t.dtype != torch.int8 or t.device != q.device for t in (q, k, v)):
        raise ValueError("q, k, v must be int8 on one device")
    if D % 128 or not 128 <= D <= INT8_MAX_D or N < 1 or M < 1:
        raise ValueError(f"the kernel takes D % 128 == 0, D <= {INT8_MAX_D}; got D={D}, N={N}, M={M}")
    qc, kc, vc = (_aligned(t.reshape(B * H, -1, D).contiguous()) for t in (q, k, v))
    mp = -(-M // PV_KEYS) * PV_KEYS if int8_pv else M
    if int8_pv:
        vk = torch.empty((B * H, D, mp), device=q.device, dtype=torch.int8)
    else:
        vk = torch.empty((B * H, M, D), device=q.device, dtype=torch.bfloat16)
    out = torch.empty((B * H, N, D), device=q.device, dtype=torch.bfloat16)
    oscale = s_v / 127.0 if int8_pv else s_v
    _build.launch("attention_int8_values", q.device, vc.data_ptr(), vk.data_ptr(), B * H, M, mp, D,
                  int(bool(int8_pv)))
    _build.launch("attention_int8", q.device, qc.data_ptr(), kc.data_ptr(), vk.data_ptr(), out.data_ptr(), B * H, N,
                  M, mp, D, ctypes.c_float(s_q * s_k / (D**0.5)), ctypes.c_float(oscale), int(bool(int8_pv)))
    LAUNCHES["attention_int8"] += 1
    return out.reshape(B, H, N, D)


def attention_int8(q, k, v, s_q, s_k, s_v, int8_pv=False):
    """The JAX package's entry at its default ``out_dtype``, bf16 (the only
    one its callers use and the one the kernel writes): the kernel at the
    shapes of its guard, the plain chain elsewhere (the JAX package runs its
    oracle there)."""
    if attention_int8_ok(q, k):
        return attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv)
    return attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv)
