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

import ctypes

import torch
from torch import nn

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.kernels.dgcnn_fused import key_order, swizzle128
from learning3d_tpu_torch.ops.int8 import f32_scalar, int8_matmul, to_int8

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


SWIZZLE_ROW = 128  # bytes a row of the packed image: 64 bf16 of the contracted index
W234_BYTES = 32768  # W2^T, W3^T (64 x 64) and W4^T (128 x 64)


def _swizzle_rows(rows):
    """(R, 64) bf16 rows of 128 bytes -> the 128-byte swizzle: the 16-byte
    chunk c of row r stored at chunk c ^ (r % 8)."""
    R = rows.shape[0]
    phys = torch.arange(8)[None, :] ^ (torch.arange(R) % 8)[:, None]  # physical chunk p holds logical p ^ r%8
    return torch.gather(rows.reshape(R, 8, 8), 1, phys[..., None].expand(R, 8, 8)).reshape(R, 64)


def packed_weights(ws):
    """The bytes K1's weight pack writes (``csrc/pointnet_fused.cu``,
    ``pack_kernel``), stated in torch: W2^T, W3^T and W4^T (rows = output
    channels, each the 64 input channels in bf16, 128 bytes), then W5^T in
    blocks of 64 output channels, each two boxes of 64 rows (input channels
    0..63, then 64..127); every row with the 128-byte swizzle, the layout
    wgmma reads K-major operands in. -> uint8 (32768 + 256 emb,)."""
    parts = [_swizzle_rows(w.t().to(torch.bfloat16).cpu()) for w in ws[1:4]]
    w5t = ws[4].t().to(torch.bfloat16).cpu()  # (emb, 128)
    blocks = w5t.reshape(-1, 64, 2, 64).permute(0, 2, 1, 3).reshape(-1, 64)  # (block, box, row) x 64
    parts.append(_swizzle_rows(blocks))
    return torch.cat([part.reshape(-1) for part in parts]).view(torch.uint8)


def pointnet_pooled_kernel(x, ws, bs, *, dot_dtype=torch.bfloat16):
    """x (B, N, 3) f32, folded weights (in, out) and biases f32 -> pooled
    (B, emb). A CUDA tensor runs the CUDA kernel (bf16 only); a CPU tensor
    runs the plain version ``oracle_chain``. On the card the C entry packs
    the weights into a scratch image (``packed_weights``) with one small
    launch, then runs the chain: one kernel call, counted once."""
    if x.device.type == "cpu":
        return oracle_chain(x, ws, bs, dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    _check_kernel_args(x, ws, bs, dot_dtype)
    B, N, _ = x.shape
    emb = ws[-1].shape[1]
    out = torch.empty((B, emb), device=x.device, dtype=torch.bfloat16)
    img = torch.empty(W234_BYTES + 2 * CHAIN[-1] * emb, device=x.device, dtype=torch.uint8)
    ptrs = [t.data_ptr() for pair in zip(ws, bs) for t in pair]
    _build.launch("pointnet_pooled_bf16", x.device, x.data_ptr(), *ptrs, out.data_ptr(), img.data_ptr(), B, N, emb)
    LAUNCHES["pointnet_pooled_kernel"] += 1
    return out


def pointnet_fused_ok(x, convs, bns, use_running_average=None):
    """Dispatch guard: eval-mode BN (the module's mode, or
    ``use_running_average`` where given), bf16 compute, 3-channel clouds,
    and the widths the kernel takes."""
    if x.ndim != 3 or x.shape[-1] != 3 or convs[0].in_features != 3:
        return False
    if convs[0].dtype != torch.bfloat16 or convs[-1].out_features % 64:
        return False
    # train-mode BN needs batch statistics: the unfused path
    return all(bn is None or bn.use_running(use_running_average) for bn in bns)


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


# --- int8 serving variant: K2 ---------------------------------------------
#
# Counterpart of ``learning3d_tpu/kernels/pointnet_fused.py::
# pointnet_pooled_int8`` (body ``_pn_int8_kernel``): stage 1 (3 -> 64) on
# bf16-rounded operands with f32 sums, then conv2..conv5 as int8 x int8 ->
# int32 products with static activation scales; each epilogue is
# acc * swb[0] + swb[1] (swb[0] = s_w * s_x), ReLU (not after conv5), and
# the requantization round(h * (1 / s_x)) clamped to +-127; relu(max over
# points) of the conv5 output, in f32. ``csrc/pointnet_int8.cu``.

K2_W234_BYTES = 16384  # W4^T | W2^T, W3^T: 128 rows of 128 bytes
K2_MAX_GROUP = 1024  # W5 rows a block keeps resident
K2_STAGES14_COST = 0.5  # an item's stages 1-4 against a 1024-channel stage 5 (csrc: kStages14Cost)


def k2_image(wts):
    """K2's weight image from the int8 (out, in) weights of conv2..conv5, the
    bytes its wgmma products read (``csrc/pointnet_int8.cu``): 128 rows of
    128 bytes, each row's bytes 0..63 W4^T (rows 0..127), bytes 64..127 W2^T
    (rows 0..63) and W3^T (rows 64..127); then W5^T, one 128-byte row an
    output channel. W2's contracted index is in natural order (stage 1 forms
    its A fragments channel by channel), W3's, W4's and W5's in
    ``key_order``. Every row swizzled by ``swizzle128``. -> uint8 (16384 +
    128 emb,)."""
    w2t, w3t, w4t, w5t = (w.view(torch.uint8) for w in wts)
    dev = w2t.device
    rows = torch.empty((128, 128), dtype=torch.uint8, device=dev)
    rows[:, :64] = w4t[:, key_order(64).to(dev)]
    rows[:64, 64:] = w2t
    rows[64:, 64:] = w3t[:, key_order(64).to(dev)]
    return torch.cat([swizzle128(rows), swizzle128(w5t[:, key_order(128).to(dev)].contiguous())])


def k2_plan(batch, emb, sms=132):
    """K2's work split, the Python statement of ``plan`` in
    ``csrc/pointnet_int8.cu``: (group, groups, blocks a group) with the
    group count that minimizes (rounds of clouds a block) x (an item's
    cost), an item costing K2_STAGES14_COST for its stages 1-4 plus group /
    1024 for its stage 5."""
    best, best_cost = None, 0.0
    for ng in range(-(-emb // K2_MAX_GROUP), emb // 64 + 1):
        group = (-(-emb // ng) + 63) // 64 * 64
        groups = -(-emb // group)
        cpg = max(1, min(sms // groups, batch))
        cost = -(-batch // cpg) * (K2_STAGES14_COST + group / 1024.0)
        if best is None or cost < best_cost - 1e-9:
            best, best_cost = (group, groups, cpg), cost
    return best


class PointNetInt8Weights(nn.Module):
    """K2's operands, built once from ``w1``, ``b1`` (f32) and ``qlayers``
    = [(w_q int8 (in, out), s_w (out,), b (out,), s_x float)] for
    conv2..conv5: w_q transposed to (out, in) (the plain version multiplies
    by its transpose), swb = [s_w * s_x; b] (2, out) f32, and 1 / s_x as
    Python floats (the kernel multiplies by them in f32). The kernel reads
    the weights through ``img`` (``k2_image``), derived from ``wt*`` and
    kept out of the state dict: ``derive`` builds it at construction and
    again after every ``load_state_dict``; an in-place edit of ``wt*`` must
    call it too. Every buffer moves with ``.to()``."""

    def __init__(self, w1, b1, qlayers):
        super().__init__()
        f32 = torch.float32
        self.register_buffer("w1", w1.to(f32).contiguous())
        self.register_buffer("b1", b1.to(f32).contiguous())
        self.inv_s = tuple(1.0 / float(s_x) for *_, s_x in qlayers)
        for i, (w_q, s_w, b, s_x) in enumerate(qlayers):
            swb = torch.stack([s_w.to(f32) * f32_scalar(float(s_x), s_w), b.to(f32)])
            self.register_buffer(f"wt{i}", w_q.to(torch.int8).t().contiguous())
            self.register_buffer(f"swb{i}", swb.contiguous())
        self.register_buffer("img", None, persistent=False)
        self.derive()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.derive())

    @torch.no_grad()
    def derive(self):
        """Rebuild ``img`` from ``wt*``."""
        if [tuple(wt.shape) for wt, _ in self.stages()[:3]] == [(64, 64), (64, 64), (128, 64)] \
                and self.wt3.shape[1] == 128 and self.wt3.shape[0] % 64 == 0:
            self.img = k2_image([wt for wt, _ in self.stages()])
        else:  # widths the kernel does not take: the wrapper refuses them
            self.img = None

    def stages(self):
        """[(w_q^T (out, in), swb)] for conv2..conv5."""
        return [(getattr(self, f"wt{i}"), getattr(self, f"swb{i}")) for i in range(len(self.inv_s))]


def pn_int8_reference(x, pack):
    """K2's plain version, a literal port of ``_pn_int8_kernel``: x (B, N, 3)
    -> (B, emb) f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    h = torch.relu(torch.matmul(x.to(bf16).to(f32), pack.w1.to(bf16).to(f32)) + pack.b1)
    stages = pack.stages()
    for i, ((wt, swb), inv) in enumerate(zip(stages, pack.inv_s)):
        hq = to_int8(h * f32_scalar(inv, h))
        z = int8_matmul(hq, wt.t()).to(f32) * swb[0] + swb[1]
        h = torch.relu(z) if i < len(stages) - 1 else z
    return torch.relu(torch.amax(h, dim=-2))


def _check_int8_args(x, pack):
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[-1] != 3 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, N>=1, 3) float32, got {tuple(x.shape)} {x.dtype}")
    stages = pack.stages()
    emb = stages[-1][0].shape[0]
    widths = [tuple(pack.w1.shape)] + [tuple(wt.t().shape) for wt, _ in stages]
    want = [(i, o) for i, o in zip(CHAIN, CHAIN[1:] + (emb,))]
    if widths != want or emb % 64:
        raise ValueError(f"weights must be {want} with emb % 64 == 0, got {widths}")
    for t in (pack.w1, pack.b1, pack.img, *(t for s in stages for t in s)):
        if t.device != x.device:
            raise ValueError("the int8 weights must be on x's device")


def pointnet_pooled_int8_kernel(x, pack):
    """x (B, N, 3) f32 and a ``PointNetInt8Weights`` -> pooled (B, emb) f32.
    A CUDA tensor runs K2 on the pack's image; a CPU tensor runs the plain
    version ``pn_int8_reference``."""
    if x.device.type == "cpu":
        return pn_int8_reference(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    _check_int8_args(x, pack)
    B, N, _ = x.shape
    stages = pack.stages()
    emb = stages[-1][0].shape[0]
    out = torch.empty((B, emb), device=x.device, dtype=torch.float32)
    inv = [ctypes.c_float(s) for s in pack.inv_s]
    _build.launch("pointnet_pooled_int8", x.device, x.data_ptr(), pack.w1.data_ptr(), pack.b1.data_ptr(),
                  pack.img.data_ptr(), *(swb.data_ptr() for _, swb in stages), *inv, out.data_ptr(), B, N, emb)
    LAUNCHES["pointnet_pooled_int8"] += 1
    return out


def pointnet_pooled_int8(x, w1, b1, qlayers):
    """The JAX package's entry: x (B, N, 3), stage-1 weights f32 and
    ``qlayers`` [(w_q, s_w, b, s_x)] for conv2..conv5 -> (B, emb) f32."""
    return pointnet_pooled_int8_kernel(x.float(), PointNetInt8Weights(w1, b1, qlayers).to(x.device))
