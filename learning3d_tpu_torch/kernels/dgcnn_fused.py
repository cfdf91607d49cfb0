"""Fused eval-mode DGCNN encoder: exact kNN, the edge gather, all five
BN-folded conv stages and the per-stage max over neighbors in CUDA
(``csrc/dgcnn_fused.cu``, the selection in ``csrc/dgcnn_select.cu``),
counterpart of ``learning3d_tpu/kernels/dgcnn_fused.py::dgcnn_encode_fused``.

The unfused path materializes every (B, N, k, C) edge tensor in device
memory; the kernel keeps them on the SM and writes only the (B, N, emb)
result. Two tricks carry over from the TPU kernel:

* stage 1 is split as z1 = nbr @ Wn1 + (center @ Wc1 + b1): the per-point
  product ``xw1 = x @ Wn1`` is taken once, outside the kernel, and the
  kernel gathers its rows by neighbor index;
* eval-mode BatchNorm is folded into every conv outside the kernel
  (``fold_bn``), so the chain inside is matmul, bias and ReLU.

The folded weights go to the kernel as a pack (``DGCNNBf16Weights``: the
bf16 images wgmma reads, Wn1 with its columns in ``xw1_order``), built once
a model (``models.dgcnn.DGCNN.bf16_weights``, rebuilt when a conv or
BatchNorm tensor changes) and once a call by the functional entries.

Rounding, shared by the kernel and its plain version: kNN over exact f32
squared differences ``(d0*d0 + d1*d1) + d2*d2`` (no FMA), nearest first,
ties to the smaller index; bf16 operands with f32 sums; f32 bias; every
stage output rounded to bf16; conv5 on the bf16 concatenation of the four
k-maxes.

``approx_knn=True`` (K5 and K9) selects by the TPU kernel's quantized keys
instead (``approx_knn_indices``): key = int32(trunc(d * scale)) * Np + col, with one
scale per query tile of the TPU kernel, so that near ties inside one
distance bucket go to the smaller index. The keys are distinct, so kernel
and plain version pick the same neighbors.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.ops.int8 import div, f32_scalar, int8_matmul, quantize_weight, to_int8
from learning3d_tpu_torch.ops.int8 import percentile as int8_percentile

DIMS = ((6, 64), (64, 64), (64, 128), (128, 256))  # stages 1-4; conv5 is (512, emb)
MAX_K = 32
MAX_N = 4096  # the kernel keeps the cloud and one distance row per warp on the SM


def fold_bn(conv, bn):
    """Fold eval-mode BatchNorm into a bias-free conv: (W', b') f32, W' in
    (in, out) layout, with relu(x @ W' + b') == relu(bn(conv(x))) under
    running statistics."""
    w = conv.weight.float().t()
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    return (w * s[None, :]).contiguous(), b


def _xw1(x, wn1, dot_dtype):
    """Per-point stage-1 neighbor product, rounded to ``dot_dtype``."""
    f32 = torch.float32
    return torch.matmul(x.to(dot_dtype).to(f32), wn1.to(dot_dtype).to(f32)).to(dot_dtype)


def exact_knn(x, k):
    """(B, N, k) neighbor indices over exact f32 squared differences,
    nearest first, ties to the smaller index (the point itself included)."""
    x = x.float()
    return torch.sort(_sq_dist(x, x), dim=-1, stable=True)[1][..., :k]


def _sq_dist(q, p):
    """(B, S, N) exact f32 squared distances of queries q to points p."""
    d0 = q[:, :, None, 0] - p[:, None, :, 0]
    d1 = q[:, :, None, 1] - p[:, None, :, 1]
    d2 = q[:, :, None, 2] - p[:, None, :, 2]
    return (d0 * d0 + d1 * d1) + d2 * d2


def knn_tile(n_pts):
    """The TPU kernel's query tile and padded width: (tile_n, Np) with
    tile_n = min(256, round_up(N, 128)) and Np = round_up(N, tile_n)."""
    tile_n = min(256, -(-n_pts // 128) * 128)
    return tile_n, -(-n_pts // tile_n) * tile_n


def approx_knn_scale(x):
    """(B, Np / tile_n) f32: f32(levels) / max(maxd, 1e-20) per query tile,
    maxd over the tile's rows (rows past N are the origin, the TPU kernel's
    zero padding) and the N valid columns; levels = 2^(30 - bitlen(Np - 1))
    - 1."""
    x = x.float()
    B, N, _ = x.shape
    tile_n, Np = knn_tile(N)
    q = torch.nn.functional.pad(x, (0, 0, 0, Np - N))
    maxd = _sq_dist(q, x).reshape(B, Np // tile_n, tile_n * N).amax(-1)
    levels = (1 << (30 - (Np - 1).bit_length())) - 1
    return torch.tensor(float(levels), dtype=torch.float32) / torch.clamp_min(maxd, 1e-20)


def approx_knn_indices(x, k):
    """(B, N, k) neighbor indices by the TPU kernel's quantized keys
    trunc(d * scale) * Np + col, smallest key first (``approx_knn_scale``)."""
    x = x.float()
    B, N, _ = x.shape
    tile_n, Np = knn_tile(N)
    scale = approx_knn_scale(x).repeat_interleave(tile_n, dim=1)[:, :N, None]
    key = (_sq_dist(x, x) * scale).to(torch.int32).to(torch.int64) * Np + torch.arange(N, device=x.device)
    return torch.sort(key, dim=-1)[1][..., :k]


def knn_indices(x, k, approx=False):
    return approx_knn_indices(x, k) if approx else exact_knn(x, k)


def dgcnn_encode_reference(x, ws, bs, k, dot_dtype=torch.bfloat16, approx_knn=False):
    """The kernel's plain version. x (B, N, 3); folded weights (in, out) and
    biases f32 -> (B, N, emb) in ``dot_dtype`` (x's dtype for f32)."""
    f32 = torch.float32

    def dot(h, w):  # rounded operands, f32 sums
        return torch.matmul(h.to(f32), w.to(dot_dtype).to(f32))

    x = x.float()
    B, N, _ = x.shape
    idx = knn_indices(x, k, approx_knn)
    xw1 = _xw1(x, ws[0][:3], dot_dtype)  # (B, N, 64)
    c1 = dot(x.to(dot_dtype), ws[0][3:]) + bs[0]  # (B, N, 64) f32, the center half
    nbr = torch.gather(xw1, 1, idx.reshape(B, -1, 1).expand(-1, -1, xw1.shape[-1]))
    e = torch.relu(nbr.reshape(B, N, k, -1).to(f32) + c1[:, :, None]).to(dot_dtype)
    pooled = [torch.amax(e, dim=2)]
    for w, b in zip(ws[1:4], bs[1:4]):
        e = torch.relu(dot(e, w) + b).to(dot_dtype)
        pooled.append(torch.amax(e, dim=2))
    cat = torch.cat(pooled, dim=-1)  # (B, N, 512)
    out_dtype = dot_dtype if dot_dtype != f32 else x.dtype
    return torch.relu(dot(cat, ws[4]) + bs[4]).to(out_dtype)


def _check_kernel_args(x, ws, bs, k, dot_dtype):
    if dot_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, not {dot_dtype}")
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, N, 3) float32, got {tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= MAX_K or not k <= x.shape[1] <= MAX_N:
        raise ValueError(f"need 1 <= k <= {MAX_K} and k <= N <= {MAX_N}, got k={k}, N={x.shape[1]}")
    emb = ws[-1].shape[1]
    want = [*DIMS, (512, emb)]
    widths = [tuple(w.shape) for w in ws]
    if widths != want or emb % 64:
        raise ValueError(f"weights must be {want} with emb % 64 == 0, got {widths}")
    for w, b in zip(ws, bs):
        if w.device != x.device or b.device != x.device or b.dtype != torch.float32:
            raise ValueError("weights and biases must be float32 on x's device")
        if b.shape != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} does not match weight {tuple(w.shape)}")


def _knn_scale_kernel(x, approx):
    """The approx-kNN key scales on the device (``dgcnn_knn_scale``), with
    the tile they are per, or (None, 1) for exact kNN."""
    if not approx:
        return None, 1
    B, N, _ = x.shape
    tile_n, Np = knn_tile(N)
    scale = torch.empty((B, Np // tile_n), device=x.device, dtype=torch.float32)
    levels = (1 << (30 - (Np - 1).bit_length())) - 1
    _build.launch("dgcnn_knn_scale", x.device, x.data_ptr(), scale.data_ptr(), B, N, tile_n, ctypes.c_float(levels))
    return scale, tile_n


def xw1_order():
    """The order of xw1's 64 columns as K5 gathers them: position p holds
    channel ``xw1_order()[p]``. A quad's thread t reads positions 16t..16t+15
    (32 bytes) of a neighbor's row; its words w = 0..7 (positions 16t + 2w,
    + 1) hold channels 16 (w // 2) + 8 (w % 2) + 2t and + 1, which are its
    bf16 A-fragment pairs of the four k-steps of 16 channels."""
    p = torch.arange(64)
    t, r = p // 16, p % 16
    return 16 * (r // 4) + 8 * (r % 4 // 2) + 2 * t + r % 2


def bf16_image(wt, block_rows):
    """(R, K) bf16 rows (out, in), K % 64 == 0, R a multiple of block_rows,
    block_rows % 8 == 0 -> the uint8 bytes of wgmma's 128-byte-swizzled
    K-major image: blocks of ``block_rows`` rows one after the other, each
    as K / 64 boxes (64 contracted values, 128 bytes, a row), each box
    swizzled by ``swizzle128``."""
    R, K = wt.shape
    rows = wt.contiguous().view(torch.uint8)  # (R, 2K)
    boxes = rows.reshape(R // block_rows, block_rows, K // 64, 128).permute(0, 2, 1, 3).reshape(-1, 128)
    return swizzle128(boxes)


class DGCNNBf16Weights:
    """K5's operands, built once from the BN-folded convs (``fold_bn``): the
    folded weights (in, out) and biases f32 as the plain version takes them
    (``ws``, ``bs``); Wn1 with its columns in ``xw1_order`` (``wn1``), Wc1
    (``wc1``); the bf16 images (``bf16_image``) of W2^T, W3^T and W4^T one
    after the other (``img``: 8192 + 16384 + 65536 bytes, W4^T as two boxes
    of 256 rows) and of W5^T in slabs of 64 output channels (``img5``: 1024
    emb bytes). A plain object, not a module: the model keeps it beside its
    state (``models.dgcnn.DGCNN.bf16_weights``)."""

    def __init__(self, ws, bs):
        with torch.no_grad():
            bf16 = torch.bfloat16
            self.ws = [w.float().contiguous() for w in ws]
            self.bs = [b.float().contiguous() for b in bs]
            self.wn1 = self.ws[0][:3][:, xw1_order().to(self.ws[0].device)].contiguous()
            self.wc1 = self.ws[0][3:].contiguous()
            self.img = torch.cat([bf16_image(w.t().to(bf16), w.shape[1]) for w in self.ws[1:4]])
            self.img5 = bf16_image(self.ws[4].t().to(bf16), 64)

    @classmethod
    def from_modules(cls, convs, bns):
        with torch.no_grad():
            folded = [fold_bn(c, bn) for c, bn in zip(convs, bns)]
            return cls([w for w, _ in folded], [b for _, b in folded])


def pack_key(convs, bns):
    """What a ``DGCNNBf16Weights`` of these modules was built from: each
    conv weight's and BatchNorm tensor's identity, storage and version
    counter (an in-place update, an optimizer step and ``load_state_dict``
    bump it) and the BatchNorms' eps; None where a tensor is an inference
    tensor, which keeps no version counter (build the pack anew)."""
    tensors = [c.weight for c in convs] + [t for bn in bns
                                          for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var)]
    if any(t.is_inference() for t in tensors):
        return None
    return tuple((id(t), t.data_ptr(), t._version) for t in tensors) + tuple(float(bn.eps) for bn in bns)


def dgcnn_encode_packed(x, pack, k, *, dot_dtype=torch.bfloat16, approx_knn=False):
    """x (B, N, 3) f32 and a ``DGCNNBf16Weights`` -> (B, N, emb). A CUDA
    tensor runs K5 (bf16 only): the selection and the chain, two launches of
    one C call; a CPU tensor runs the plain version
    ``dgcnn_encode_reference``."""
    if x.device.type == "cpu":
        return dgcnn_encode_reference(x, pack.ws, pack.bs, k, dot_dtype, approx_knn)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    _check_kernel_args(x, pack.ws, pack.bs, k, dot_dtype)
    B, N, _ = x.shape
    emb = pack.ws[-1].shape[1]
    xw1 = _xw1(x, pack.wn1, torch.bfloat16).contiguous()  # columns in xw1_order
    out = torch.empty((B, N, emb), device=x.device, dtype=torch.bfloat16)
    nbrs = torch.empty((B, N, k), device=x.device, dtype=torch.int32)  # the selection's output, the chain's input
    ptrs = [x, xw1, pack.wc1, pack.bs[0], pack.img, pack.img5, *pack.bs[1:], out]
    scale, tile_n = _knn_scale_kernel(x, approx_knn)
    _build.launch("dgcnn_encode_bf16", x.device, *(t.data_ptr() for t in ptrs),
                  0 if scale is None else scale.data_ptr(), nbrs.data_ptr(), B, N, k, emb, tile_n)
    LAUNCHES["dgcnn_encode_fused"] += 1
    return out


def dgcnn_encode_kernel(x, ws, bs, k, *, dot_dtype=torch.bfloat16, approx_knn=False):
    """x (B, N, 3), folded weights (in, out) and biases f32 -> (B, N, emb).
    A CUDA tensor runs the CUDA kernel (bf16 only) on a pack built on this
    call; a CPU tensor runs the plain version ``dgcnn_encode_reference``."""
    if x.device.type == "cpu":
        return dgcnn_encode_reference(x, ws, bs, k, dot_dtype, approx_knn)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_kernel_args(x.contiguous(), ws, bs, k, dot_dtype)
    return dgcnn_encode_packed(x, DGCNNBf16Weights(ws, bs), k, dot_dtype=dot_dtype, approx_knn=approx_knn)


def dgcnn_encode_fused(x, convs, bns, k, *, dot_dtype=torch.bfloat16, approx_knn=False):
    """Eval-mode DGCNN encoder forward: x (B, N, 3) -> (B, N, emb).
    ``convs``/``bns`` are the module's bias-free Linear and BatchNorm
    stacks, BN under running statistics. ``approx_knn`` selects neighbors
    by quantized keys (the module docstring). The pack is built on this
    call (a module builds it once, ``DGCNN.bf16_weights``)."""
    return dgcnn_encode_packed(x.float(), DGCNNBf16Weights.from_modules(convs, bns), k, dot_dtype=dot_dtype,
                               approx_knn=approx_knn)


def kernel_limit(n_pts, k, emb):
    """The limit of K5 and K9 that (N, k, emb) breaks, as a message, or None
    where the kernels take the shape: 1 <= k <= MAX_K, k <= N <= MAX_N and
    emb % 64 == 0."""
    if not 1 <= k <= MAX_K:
        return f"k={k} is outside the kernels' 1 <= k <= {MAX_K}"
    if not k <= n_pts <= MAX_N:
        return f"N={n_pts} is outside the kernels' k <= N <= {MAX_N}"
    if emb % 64:
        return f"emb={emb} is not a multiple of 64"
    return None


def dgcnn_fused_ok(x, convs, bns, k):
    """Dispatch guard: eval-mode BN, bf16 convs, 3-channel clouds, the DGCNN
    widths, and the shapes the kernels take (``kernel_limit``), so that no
    shape the guard admits reaches the kernel's argument check."""
    return (
        x.ndim == 3
        and x.shape[-1] == 3
        and len(convs) == 5
        and convs[0].in_features == 6
        and all(bn is not None and not bn.training for bn in bns)
        and convs[0].dtype == torch.bfloat16
        and kernel_limit(x.shape[1], k, convs[-1].out_features) is None
    )


# --- int8 serving variant: K9 ---------------------------------------------
#
# Counterpart of ``learning3d_tpu/kernels/dgcnn_fused.py::
# dgcnn_encode_fused_int8`` (body ``_fused_kernel_int8``): K5's exact kNN;
# the per-point stage-1 product xw1 = bf16(x) . bf16(Wn1) in f32, quantized
# with a dynamic scale s_xw1 = max|xw1| / 127 over the WHOLE batch, so a
# neighbor's int8 row is gathered exactly; e1 = q1(relu(xw1q * s_xw1 + c1));
# stages 2-4 as int8 products with epilogue relu(acc * swb[0] + swb[1]) and
# requantization q_i(z) = round(z * (1 / s_i)) clamped to +-127; the max
# over neighbors on the int8 values (it commutes with the positive scale);
# conv5 as one int8 product against w5 whose rows carry the per-stage
# dequantization scales, relu(acc * s_w5 + b5) in bf16.
# ``csrc/dgcnn_int8.cu``.


def key_order(width):
    """The contracted-index order in which an int8 wgmma accumulator becomes
    the next product's A fragments in place (``csrc/attention_sm90.cuh``'s
    ``s8_pack_p``): position p of ``width`` (a multiple of 16) holds channel
    ``key_order(width)[p]``; in each 16-channel group, position 4t + i holds
    channel 2t + i for i < 2 and 8 + 2t + i - 2 for i >= 2."""
    p = torch.arange(width)
    grp, t, i = p // 16, p % 16 // 4, p % 4
    return 16 * grp + torch.where(i < 2, 2 * t + i, 6 + 2 * t + i)


def swizzle128(rows):
    """(R, 128) uint8 rows, R % 8 == 0 -> the R * 128 bytes of wgmma's
    128-byte-swizzled K-major image: 16-byte chunk c of row r at chunk
    c ^ (r % 8) of the row's 128 bytes, the rows in order (8-row atoms of
    1024 bytes)."""
    r = torch.arange(rows.shape[0], device=rows.device)[:, None]
    c = torch.arange(128, device=rows.device)[None, :]
    out = torch.empty(rows.numel(), dtype=torch.uint8, device=rows.device)
    out[(r * 128 + (c // 16 ^ r % 8) * 16 + c % 16).reshape(-1)] = rows.reshape(-1)
    return out


def k9_images(wts):
    """K9's weight images from the int8 (out, in) weights of conv2..conv5:
    ``w23`` (16384 bytes): 128 rows, bytes 0..63 W2^T (rows < 64, natural
    order: e1's fragments are formed in it), bytes 64..127 W3^T with its
    contracted index in ``key_order``; ``w4`` (32768): W4^T in
    ``key_order``; ``w5`` (512 emb): W5^T with the concatenation's index
    natural for e1 (0..63) and in ``key_order`` past it, in slabs of 32
    output channels, each four 128-byte boxes of k (4096 bytes). Each
    swizzled by ``swizzle128``."""
    w2t, w3t, w4t, w5t = (w.view(torch.uint8) for w in wts)
    dev = w2t.device
    rows = torch.zeros((128, 128), dtype=torch.uint8, device=dev)
    rows[:64, :64] = w2t
    rows[:, 64:] = w3t[:, key_order(64).to(dev)]
    emb = w5t.shape[0]
    cat = torch.where(torch.arange(512) < 64, torch.arange(512), key_order(512)).to(dev)
    slabs = w5t[:, cat].reshape(emb // 32, 32, 4, 128).permute(0, 2, 1, 3).reshape(-1, 128)
    return swizzle128(rows), swizzle128(w4t[:, key_order(128).to(dev)]), swizzle128(slabs)


class DGCNNInt8Weights(nn.Module):
    """K9's operands, built once from the BN-folded convs and the static
    scales (s1..s4) of ``calibrate_dgcnn_int8``: Wn1, Wc1, b1 f32; the int8
    weights of conv2..conv5 (conv5's rows pre-scaled by the stage scales of
    the concatenation they multiply) transposed to (out, in) (the plain
    version multiplies by their transpose); swb = [s_in * s_w; b] (conv5:
    [s_w5; b5]); 1 / s_i as Python floats. The kernel also reads buffers
    derived from these, kept out of the state dict: Wn1 rounded to bf16
    (``wn1_bf16``) and the swizzled images (``k9_images``: ``img23``,
    ``img4``, ``img5``). ``derive`` builds them at construction and again
    after every ``load_state_dict``; an in-place edit of ``wn1`` or ``wt*``
    must call it too."""

    def __init__(self, ws, bs, scales):
        super().__init__()
        f32 = torch.float32
        ws, bs = [w.to(f32) for w in ws], [b.to(f32) for b in bs]
        self.scales = tuple(float(s) for s in scales)
        self.inv_s = tuple(1.0 / s for s in self.scales)
        row_scales = torch.cat([torch.full((w.shape[1],), s, dtype=f32, device=w.device)
                                for w, s in zip(ws[:4], self.scales)])
        qs = [quantize_weight(w) for w in ws[1:4]] + [quantize_weight(ws[4] * row_scales[:, None])]
        self.register_buffer("wn1", ws[0][:3].contiguous())
        self.register_buffer("wc1", ws[0][3:].contiguous())
        self.register_buffer("b1", bs[0].contiguous())
        for i, ((w_q, s_w), b) in enumerate(zip(qs, bs[1:])):
            swb = torch.stack([torch.full_like(b, self.scales[i]) * s_w, b]) if i < 3 else torch.stack([s_w, b])
            self.register_buffer(f"wt{i}", w_q.t().contiguous())
            self.register_buffer(f"swb{i}", swb.contiguous())
        for name in ("wn1_bf16", "img23", "img4", "img5"):
            self.register_buffer(name, None, persistent=False)
        self.derive()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.derive())

    @torch.no_grad()
    def derive(self):
        """Rebuild ``wn1_bf16`` and the images from ``wn1`` and ``wt*``."""
        self.wn1_bf16 = self.wn1.to(torch.bfloat16).to(torch.float32).contiguous()
        self.img23, self.img4, self.img5 = k9_images([wt for wt, _ in self.stages()])

    def stages(self):
        """[(w_q^T (out, in), swb)] for conv2..conv5."""
        return [(getattr(self, f"wt{i}"), getattr(self, f"swb{i}")) for i in range(4)]

    @classmethod
    def from_modules(cls, convs, bns, scales):
        with torch.no_grad():
            folded = [fold_bn(c, bn) for c, bn in zip(convs, bns)]
            return cls([w for w, _ in folded], [b for _, b in folded], scales)


def _xw1_int8(x, wn1):
    """The int8 stage-1 neighbor product and its dynamic scale, a 0-d
    device tensor (no host sync): s = max(max|xw1|, 1e-6) / 127 over the
    whole batch."""
    f32, bf16 = torch.float32, torch.bfloat16
    xw1 = torch.matmul(x.to(bf16).to(f32), wn1.to(bf16).to(f32))
    s = div(torch.clamp_min(torch.amax(torch.abs(xw1)), 1e-6), 127.0)
    return to_int8(xw1 / s), s


def dgcnn_int8_reference(x, pack, k, approx_knn=False):
    """K9's plain version: x (B, N, 3) -> (B, N, emb) bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    x = x.float()
    B, N, _ = x.shape
    idx = knn_indices(x, k, approx_knn)
    xw1q, s_xw1 = _xw1_int8(x, pack.wn1)
    c1 = torch.matmul(x.to(bf16).to(f32), pack.wc1.to(bf16).to(f32)) + pack.b1
    nbr = torch.gather(xw1q, 1, idx.reshape(B, -1, 1).expand(-1, -1, xw1q.shape[-1])).reshape(B, N, k, -1)
    e = to_int8(torch.relu(nbr.to(f32) * s_xw1 + c1[:, :, None]) * f32_scalar(pack.inv_s[0], x))
    pooled = [torch.amax(e, dim=2)]
    stages = pack.stages()
    for (wt, swb), inv in zip(stages[:3], pack.inv_s[1:]):
        e = to_int8(torch.relu(int8_matmul(e, wt.t()).to(f32) * swb[0] + swb[1]) * f32_scalar(inv, x))
        pooled.append(torch.amax(e, dim=2))
    wt, swb = stages[3]
    return torch.relu(int8_matmul(torch.cat(pooled, dim=-1), wt.t()).to(f32) * swb[0] + swb[1]).to(bf16)


def dgcnn_encode_int8_kernel(x, pack, k, approx_knn=False):
    """x (B, N, 3) f32 and a ``DGCNNInt8Weights`` -> (B, N, emb) bf16. A
    CUDA tensor runs K9; a CPU tensor runs the plain version
    ``dgcnn_int8_reference``."""
    if x.device.type == "cpu":
        return dgcnn_int8_reference(x, pack, k, approx_knn)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.contiguous()
    stages = pack.stages()
    emb = stages[3][0].shape[0]
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, N, 3) float32, got {tuple(x.shape)} {x.dtype}")
    limit = kernel_limit(x.shape[1], k, emb)
    if limit is not None:
        raise ValueError(limit)
    widths = [tuple(wt.t().shape) for wt, _ in stages]
    if widths != [*DIMS[1:], (512, emb)] or pack.wn1.device != x.device:
        raise ValueError(f"int8 weights must be {[*DIMS[1:], (512, emb)]} on x's device, got {widths}")
    B, N, _ = x.shape
    # the plain version's xw1 product, its quantization in two kernels
    xw1 = torch.matmul(x.to(torch.bfloat16).to(torch.float32), pack.wn1_bf16)
    xw1q = torch.empty(xw1.shape, device=x.device, dtype=torch.int8)
    s_xw1 = torch.empty((), device=x.device, dtype=torch.float32)
    amax = torch.empty((), device=x.device, dtype=torch.int32)
    out = torch.empty((B, N, emb), device=x.device, dtype=torch.bfloat16)
    nbrs = torch.empty((B, N, k), device=x.device, dtype=torch.int32)  # the selection's output, the chain's input
    ptrs = [t.data_ptr() for t in (pack.img23, pack.img4, pack.img5)] + [swb.data_ptr() for _, swb in stages]
    inv = [ctypes.c_float(s) for s in pack.inv_s]
    _build.launch("dgcnn_quant_xw1", x.device, xw1.data_ptr(), xw1q.data_ptr(), s_xw1.data_ptr(), amax.data_ptr(),
                  xw1.numel())
    scale, tile_n = _knn_scale_kernel(x, approx_knn)
    _build.launch("dgcnn_encode_int8", x.device, x.data_ptr(), xw1q.data_ptr(), s_xw1.data_ptr(), pack.wc1.data_ptr(),
                  pack.b1.data_ptr(), *ptrs, *inv, out.data_ptr(), 0 if scale is None else scale.data_ptr(),
                  nbrs.data_ptr(), B, N, k, emb, tile_n)
    LAUNCHES["dgcnn_encode_fused_int8"] += 1
    return out


def dgcnn_encode_fused_int8(x, convs, bns, k, scales, *, approx_knn=False):
    """The JAX package's entry: x (B, N, 3) -> (B, N, emb) bf16 with the
    static scales (s1..s4) of ``calibrate_dgcnn_int8``; the int8 weights are
    built on this call (a module builds them once, ``DGCNN.int8_scales``)."""
    return dgcnn_encode_int8_kernel(x.float(), DGCNNInt8Weights.from_modules(convs, bns, scales), k, approx_knn)


def calibrate_dgcnn_int8(convs, bns, k, calib_x, percentile=99.9):
    """Static per-stage activation scales (s1..s4) from one unfused f32
    forward over ``calib_x`` (B, N, 3): the ``percentile`` of |h| after each
    of stages 1-4, the next stage fed the quantized value. Python floats
    (one host read a stage)."""
    from learning3d_tpu_torch.ops.geometry import get_graph_feature

    with torch.no_grad():
        folded = [fold_bn(c, bn) for c, bn in zip(convs, bns)]
        h = get_graph_feature(calib_x.float(), k=k)  # (B, N, k, 6)
        scales = []
        for w, b in folded[:4]:
            h = torch.relu(torch.matmul(h, w) + b)
            a = int8_percentile(torch.abs(h), percentile)
            scales.append(torch.clamp_min(a, 1e-6).item() / 127.0)
            s = f32_scalar(scales[-1], h)
            h = torch.clamp(torch.round(h / s), -127, 127) * s
    return tuple(scales)
