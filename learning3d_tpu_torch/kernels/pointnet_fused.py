"""Fused eval-mode PointNet encoder: the whole 3->64->64->64->128->emb conv
chain + BN fold + ReLU + max-pool in one CUDA kernel
(``csrc/pointnet_fused.cu``), counterpart of
``learning3d_tpu/kernels/pointnet_fused.py``.

The unfused eval path runs each 1x1 conv as a separate GEMM, so every
intermediate activation goes through device memory; the kernel reads the
(B, N, 3) cloud once, keeps the per-point chain on the SM and writes only
the pooled (B, emb) feature. Eval-mode BatchNorm is folded into each conv
outside the kernel (``fold_conv_bn``), and relu/max commute, so the pooled
feature is relu(max_n z_n).

Differentiation: ``pointnet_pooled_fused`` is an autograd Function whose
backward recomputes through ``oracle_chain``, the kernel's plain version,
so gradients through a frozen-BN encoder stay exact.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build

CHAIN = (3, 64, 64, 64, 128)  # the widths the kernel is written for, then emb


def fold_conv_bn(conv, bn):
    """Fold eval-mode BatchNorm into a biased conv: (W', b') f32 with W' in
    (in, out) layout and relu(x @ W' + b') == relu(bn(conv(x))) under
    running stats."""
    w = conv.weight.float().t()
    b = conv.bias.float() if conv.bias is not None else torch.zeros(w.shape[-1], device=w.device)
    if bn is None:
        return w.contiguous(), b
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return (w * s[None, :]).contiguous(), (b - bn.running_mean.float()) * s + bn.bias.float()


def oracle_chain(x, ws, bs, dot_dtype=torch.bfloat16):
    """The kernel's plain version: operands rounded to ``dot_dtype``, f32
    accumulation, f32 bias, ReLU, max over points. x (B, N, 3) ->
    (B, emb) in ``dot_dtype`` (or x's dtype for f32)."""
    f32 = torch.float32

    def dot(h, w):  # rounded operands, exact products, f32 sums
        return torch.matmul(h.to(f32), w.to(dot_dtype).to(f32))

    h = x.to(dot_dtype)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(dot(h, w) + b.to(f32)).to(dot_dtype)
    z = dot(h, ws[-1]) + bs[-1].to(f32)
    out_dtype = dot_dtype if dot_dtype != f32 else x.dtype
    return torch.relu(torch.amax(z, dim=-2)).to(out_dtype)


def _check_kernel_args(x, ws, bs, dot_dtype):
    if dot_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, not {dot_dtype}")
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[-1] != 3 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, N>=1, 3) float32, got {tuple(x.shape)} {x.dtype}")
    emb = ws[-1].shape[1]
    widths = [w.shape for w in ws]
    want = [(i, o) for i, o in zip(CHAIN, CHAIN[1:] + (emb,))]
    if len(ws) != len(CHAIN) or widths != want or emb % 64:
        raise ValueError(f"weights must be {want} with emb % 64 == 0, got {widths}")
    for w, b in zip(ws, bs):
        for t in (w, b):
            if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("weights and biases must be contiguous float32 on x's device")
        if b.shape != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} does not match weight {tuple(w.shape)}")


def pointnet_pooled_kernel(x, ws, bs, *, dot_dtype=torch.bfloat16):
    """x (B, N, 3) f32, folded weights (in, out) and biases f32 -> pooled
    (B, emb). A CUDA tensor runs the CUDA kernel (bf16 only); a CPU tensor
    runs the plain version ``oracle_chain``."""
    if x.device.type == "cpu":
        return oracle_chain(x, ws, bs, dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    _check_kernel_args(x, ws, bs, dot_dtype)
    B, N, _ = x.shape
    emb = ws[-1].shape[1]
    out = torch.empty((B, emb), device=x.device, dtype=torch.bfloat16)
    lib = _build.library()
    ptrs = [t.data_ptr() for pair in zip(ws, bs) for t in pair]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pointnet_pooled_bf16(x.data_ptr(), *ptrs, out.data_ptr(), B, N, emb, stream)
    _build.check(err, "pointnet_pooled_bf16")
    LAUNCHES["pointnet_pooled_kernel"] += 1
    return out


def pointnet_fused_ok(x, convs, bns):
    """Dispatch guard: eval-mode BN, bf16 compute, 3-channel clouds, and
    the widths the kernel takes."""
    if x.ndim != 3 or x.shape[-1] != 3 or convs[0].in_features != 3:
        return False
    if convs[0].dtype != torch.bfloat16 or convs[-1].out_features % 64:
        return False
    # train-mode BN needs batch statistics: the unfused path
    return not any(bn is not None and bn.training for bn in bns)


class _FusedBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *wb):
        n = len(wb) // 2
        ctx.save_for_backward(x, *wb)
        return pointnet_pooled_kernel(x, list(wb[:n]), list(wb[n:]))

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n = (len(saved) - 1) // 2
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
            out = oracle_chain(inputs[0], inputs[1 : 1 + n], inputs[1 + n :], torch.bfloat16)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def pointnet_pooled_fused(x, convs, bns):
    """Public entry: x (B, N, 3) -> pooled (B, emb) bf16, differentiable
    (backward recomputes through ``oracle_chain``)."""
    folded = [fold_conv_bn(c, bn) for c, bn in zip(convs, bns)]
    return _FusedBF16.apply(x.float(), *(w for w, _ in folded), *(b for _, b in folded))
