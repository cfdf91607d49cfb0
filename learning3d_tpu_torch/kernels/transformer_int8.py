"""Fused int8 pre-norm transformer layers for the DCP pointer, K11a and K11b
(``csrc/transformer_int8.cu``), counterparts of
``learning3d_tpu/kernels/transformer_int8.py::encoder_layer_int8`` and
``::decoder_layer_int8``.

One layer, per batch item:

    encoder  y = quant(LN1(x), s_y)
             x2 = x + WO(attend(Q(y), K(y), V(y)))
             out = x2 + W2(quant(relu(W1(quant(LN2(x2), s_ff))), s_h))
    decoder  the same, with x3 = x2 + XWO(attend(XQ(quant(LN2(x2), s_y2)),
             XK(m), XV(m))), m = quant(memory, s_mem), and LN3 before the
             feed-forward

with the residual stream in f32 inside the layer, cast to x's dtype at the
end. The plain versions ``encoder_layer_int8_reference`` /
``decoder_layer_int8_reference`` repeat the JAX package's references
(``*_reference`` there) in torch; the CUDA entries ``encoder_layer_int8`` /
``decoder_layer_int8`` take a ``FusedLayerWeights``, the layer's operands
packed once in the layout the kernels read. The ``.cu`` header states the
split of a layer into launches and the numeric traps both versions keep.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch import nn

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.kernels.attention import PV_KEYS
from learning3d_tpu_torch.ops.int8 import div, f32_scalar, to_int8

F32, BF16 = torch.float32, torch.bfloat16
LN_EPS = 1e-6
MAX_D = 1024  # what the kernels take: d % 128 == 0, d_k % 128 == 0, d <= MAX_D
SM90_MAX_DK = 256  # S3's wgmma instances; wider heads run its mma.sync instance
_REQUANT, _RELU_REQUANT, _RESIDUAL = 0, 1, 2  # the GEMM's epilogues (layer_gemm_s8's mode)


@dataclasses.dataclass(frozen=True)
class LayerScales:
    """Static activation scales of one quantized layer (Python floats)."""

    s_y: float      # post-LN1 input scale (self-attention input)
    s_q: float
    s_k: float
    s_v: float
    s_att: float    # attention-output scale (feeds the output projection)
    s_ff: float     # post-LN feed-forward input scale
    s_h: float      # post-ReLU hidden scale
    # decoder-only (cross-attention); unused for encoder layers
    s_y2: float = 1.0  # post-LN2 cross-attention query input scale
    s_mem: float = 1.0
    s_q2: float = 1.0
    s_k2: float = 1.0
    s_v2: float = 1.0
    s_att2: float = 1.0


ENC_NAMES = (
    "wq", "swq", "bq", "wk", "swk", "bk", "wv", "swv", "bv", "wo", "swo", "bo",
    "w1", "sw1", "b1", "w2", "sw2", "b2",
    "ln1a", "ln1b", "ln2a", "ln2b",
)
DEC_NAMES = (
    "wq", "swq", "bq", "wk", "swk", "bk", "wv", "swv", "bv", "wo", "swo", "bo",
    "xwq", "xswq", "xbq", "xwk", "xswk", "xbk", "xwv", "xswv", "xbv", "xwo", "xswo", "xbo",
    "w1", "sw1", "b1", "w2", "sw2", "b2",
    "ln1a", "ln1b", "ln2a", "ln2b", "ln3a", "ln3b",
)


def fused_layer_ok(N, d, n_heads):
    """Dispatch guard, the JAX package's (at its tile_n=256): DCP-scale
    shapes, d and the head width multiples of 128, 256 <= N <= 2048 in
    whole 256-row tiles, d <= 1024."""
    d_k = d // n_heads
    return d % 128 == 0 and d_k % 128 == 0 and N % 256 == 0 and 256 <= N <= 2048 and d <= 1024


def kernel_limit(d, n_heads):
    """The limit of K11 that (d, n_heads) breaks, as a message, or None.
    Every shape ``fused_layer_ok`` admits is inside it; N and the memory's
    length may be anything."""
    if d % n_heads or d % 128 or (d // n_heads) % 128 or d > MAX_D:
        return f"d={d} with {n_heads} heads: K11 takes d % 128 == 0, d / heads % 128 == 0, d <= {MAX_D}"
    return None


# --- the plain versions ----------------------------------------------------


def _ln(x32, a, b, eps=LN_EPS):
    """AnnotatedLayerNorm: a * (x - mean) / (unbiased std + eps) + b. The
    mean and the mean square of x - mean are summed in f64 and rounded to
    f32 once (the kernel sums them so; the sums' order then changes
    nothing)."""
    n = x32.shape[-1]
    mean = (x32.double().sum(-1, keepdim=True) / n).float()
    xc = x32 - mean
    var = ((xc.double() ** 2).sum(-1, keepdim=True) / n).float() * (n / (n - 1))
    return a * xc / (torch.sqrt(var) + eps) + b


def _quant(x32, s):
    return to_int8(div(x32, s))


def _gemm_i8(x_q, w_q):
    """int8 (..., K) @ int8 (K, N), exact (float64 sums of integers), as f32."""
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(F32)


def _proj(x_q, s_x, w_q, s_w, b, s_out):
    """int8 GEMM, dequantization and bias, requantized at s_out."""
    return _quant(_gemm_i8(x_q, w_q) * (f32_scalar(s_x, s_w) * s_w) + b, s_out)


def attend_heads(q, k, v, sscale, s_v, int8_pv):
    """int8 attention on (B, H, N|M, d_k) heads, the JAX layer's ``_attend``:
    S = int32(q k^T) * sscale, p = exp(S - rowmax), l = sum(p); int8 P.V:
    O = int32(round(127 p) v) * (s_v / 127); hybrid: O = (bf16(p) v) * s_v;
    bf16(O / l) as f32. l is summed in f64 and rounded once, and the hybrid
    P.V (exact f32 products) is summed in f32 in key order, as the kernel
    sums them, so that the two round alike."""
    f32 = F32
    s = _gemm_i8(q, k.transpose(-1, -2)) * f32_scalar(sscale, q)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    l = p.double().sum(-1, keepdim=True).float()
    if int8_pv:
        o = _gemm_i8(torch.round(p * 127.0), v) * f32_scalar(s_v / 127.0, q)
    else:
        pb, vf = p.to(BF16).to(f32), v.to(f32)
        o = torch.zeros(p.shape[:-1] + (v.shape[-1],), dtype=f32, device=q.device)
        for j in range(v.shape[-2]):
            o = o + pb[..., j : j + 1] * vf[..., j : j + 1, :]
        o = o * f32_scalar(s_v, q)
    return (o / l).to(BF16).to(f32)


def _attend(q, k, v, s_q, s_k, s_v, n_heads, int8_pv):
    """``attend_heads`` on (B, N, d) q and (B, M, d) k, v."""
    B, N, d = q.shape

    def split(t):
        return t.reshape(B, t.shape[1], n_heads, d // n_heads).transpose(1, 2)

    o = attend_heads(split(q), split(k), split(v), s_q * s_k / ((d // n_heads) ** 0.5), s_v, int8_pv)
    return o.transpose(1, 2).reshape(B, N, d)


def _mha_block(x32, y_q, s_y, kv_q, s_kv, w, sc, n_heads, int8_pv, prefix=""):
    """x32 + WO(attend(Q(y), K(kv), V(kv))), the residual added first."""
    p = prefix
    q = _proj(y_q, s_y, w[p + "wq"], w[p + "swq"], w[p + "bq"], sc[p + "s_q"])
    k = _proj(kv_q, s_kv, w[p + "wk"], w[p + "swk"], w[p + "bk"], sc[p + "s_k"])
    v = _proj(kv_q, s_kv, w[p + "wv"], w[p + "swv"], w[p + "bv"], sc[p + "s_v"])
    attn = _attend(q, k, v, sc[p + "s_q"], sc[p + "s_k"], sc[p + "s_v"], n_heads, int8_pv)
    o = _gemm_i8(_quant(attn, sc[p + "s_att"]), w[p + "wo"])
    return (x32 + o * (f32_scalar(sc[p + "s_att"], o) * w[p + "swo"])) + w[p + "bo"]


def _ff_block(x32, w, s_ff, s_h, ln_a, ln_b):
    """x + W2(quant(relu(W1(quant(LN(x), s_ff))), s_h))."""
    h = _gemm_i8(_quant(_ln(x32, ln_a, ln_b), s_ff), w["w1"])
    h = torch.relu(h * (f32_scalar(s_ff, h) * w["sw1"]) + w["b1"])
    o = _gemm_i8(_quant(h, s_h), w["w2"])
    return (x32 + o * (f32_scalar(s_h, o) * w["sw2"])) + w["b2"]


def _plain_weights(names, weights):
    w = {}
    for name in names:
        core = name[1:] if name.startswith("x") else name
        is_mat = core[0] == "w" and core[1] in "qkvo12"
        a = torch.as_tensor(weights[name])
        w[name] = a if is_mat else a.reshape(-1).to(F32)
    return w


def _scale_dict(sc: LayerScales):
    return {"s_q": sc.s_q, "s_k": sc.s_k, "s_v": sc.s_v, "s_att": sc.s_att,
            "xs_q": sc.s_q2, "xs_k": sc.s_k2, "xs_v": sc.s_v2, "xs_att": sc.s_att2}


def encoder_layer_int8_reference(x, weights, sc: LayerScales, *, n_heads=4, int8_pv=True):
    """K11a's plain version. x (B, N, d); ``weights`` maps ``ENC_NAMES`` to
    tensors (int8 (in, out) matrices, f32 vectors). The JAX reference's
    row tiles (``tile_n``) change nothing: the rows are independent."""
    w = _plain_weights(ENC_NAMES, weights)
    x32 = x.to(F32)
    y_q = _quant(_ln(x32, w["ln1a"], w["ln1b"]), sc.s_y)
    x2 = _mha_block(x32, y_q, sc.s_y, y_q, sc.s_y, w, _scale_dict(sc), n_heads, int8_pv)
    return _ff_block(x2, w, sc.s_ff, sc.s_h, w["ln2a"], w["ln2b"]).to(x.dtype)


def decoder_layer_int8_reference(x, memory, weights, sc: LayerScales, *, n_heads=4, int8_pv=True):
    """K11b's plain version (see the encoder's)."""
    w = _plain_weights(DEC_NAMES, weights)
    scd = _scale_dict(sc)
    x32 = x.to(F32)
    y_q = _quant(_ln(x32, w["ln1a"], w["ln1b"]), sc.s_y)
    x2 = _mha_block(x32, y_q, sc.s_y, y_q, sc.s_y, w, scd, n_heads, int8_pv)
    y2_q = _quant(_ln(x2, w["ln2a"], w["ln2b"]), sc.s_y2)
    mem_q = _quant(memory.to(F32), sc.s_mem)
    x3 = _mha_block(x2, y2_q, sc.s_y2, mem_q, sc.s_mem, w, scd, n_heads, int8_pv, prefix="x")
    return _ff_block(x3, w, sc.s_ff, sc.s_h, w["ln3a"], w["ln3b"]).to(x.dtype)


# --- the CUDA entries ------------------------------------------------------


def _round_up(v, m):
    return -(-v // m) * m


class FusedLayerWeights(nn.Module):
    """A layer's operands in the kernels' layout, built once from the weight
    dict of ``encoder_layer_int8_reference`` (or the decoder's) and the
    scales: each GEMM's int8 weight transposed to (out, in), with per-column
    f32(s_x) * s_w, bias, output scales and their f32 reciprocals; Q|K|V
    concatenated into one GEMM (K|V for the cross-attention); the
    feed-forward's hidden width padded to a multiple of 128 with zero
    weights (a padded hidden unit is 0)."""

    def __init__(self, weights, sc: LayerScales, n_heads: int, decoder: bool):
        super().__init__()
        w = _plain_weights(DEC_NAMES if decoder else ENC_NAMES, weights)
        d = w["wq"].shape[0]
        self.d, self.n_heads, self.decoder = d, n_heads, decoder
        self.d_k = d // n_heads

        def full(n, s):
            return torch.full((n,), s, dtype=F32, device=w["swq"].device)

        def gemm(name, mats, s_x, sws, biases, s_outs=None):
            wt = torch.cat([w[m] for m in mats], dim=1).t().contiguous()
            self.register_buffer(name + "_w", wt.to(torch.int8))
            sw = torch.cat([w[s] for s in sws])
            self.register_buffer(name + "_cs", (f32_scalar(s_x, sw) * sw).contiguous())
            self.register_buffer(name + "_b", torch.cat([w[b] for b in biases]).contiguous())
            if s_outs is not None:
                self.register_buffer(name + "_so", torch.cat([full(d, s) for s in s_outs]))
                self.register_buffer(name + "_sr", 1.0 / getattr(self, name + "_so"))

        gemm("qkv", ("wq", "wk", "wv"), sc.s_y, ("swq", "swk", "swv"), ("bq", "bk", "bv"), (sc.s_q, sc.s_k, sc.s_v))
        gemm("o", ("wo",), sc.s_att, ("swo",), ("bo",))
        self.att = (sc.s_q * sc.s_k / (self.d_k**0.5), sc.s_v, sc.s_att)
        lns = ("ln1", "ln2", "ln3") if decoder else ("ln1", "ln2")
        if decoder:
            gemm("xq", ("xwq",), sc.s_y2, ("xswq",), ("xbq",), (sc.s_q2,))
            gemm("xkv", ("xwk", "xwv"), sc.s_mem, ("xswk", "xswv"), ("xbk", "xbv"), (sc.s_k2, sc.s_v2))
            gemm("xo", ("xwo",), sc.s_att2, ("xswo",), ("xbo",))
            self.xatt = (sc.s_q2 * sc.s_k2 / (self.d_k**0.5), sc.s_v2, sc.s_att2)
        for ln in lns:
            self.register_buffer(ln + "a", w[ln + "a"].contiguous())
            self.register_buffer(ln + "b", w[ln + "b"].contiguous())
        # the feed-forward, its hidden width padded to a multiple of 128
        d_ff = w["w1"].shape[1]
        pad = _round_up(d_ff, 128) - d_ff
        w1t = nn.functional.pad(w["w1"].t(), (0, 0, 0, pad))
        self.register_buffer("ff1_w", w1t.contiguous().to(torch.int8))
        self.register_buffer("ff1_cs", nn.functional.pad(f32_scalar(sc.s_ff, w["sw1"]) * w["sw1"], (0, pad)))
        self.register_buffer("ff1_b", nn.functional.pad(w["b1"], (0, pad)))
        self.register_buffer("ff1_so", full(d_ff + pad, sc.s_h))
        self.register_buffer("ff1_sr", 1.0 / self.ff1_so)
        self.register_buffer("ff2_w", nn.functional.pad(w["w2"].t(), (0, pad)).contiguous().to(torch.int8))
        self.register_buffer("ff2_cs", f32_scalar(sc.s_h, w["sw2"]) * w["sw2"])
        self.register_buffer("ff2_b", w["b2"].contiguous())
        self.scales = sc


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _ln_quant(x, a, b, s, *, do_ln=True):
    rows, d = x.shape[0] * x.shape[1], x.shape[-1]
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _build.launch("layer_ln_quant", x.device, x.data_ptr(), _ptr(a), _ptr(b), out.data_ptr(), rows, d,
                  int(x.dtype == BF16), int(do_ln), ctypes.c_float(d / (d - 1)), ctypes.c_float(LN_EPS),
                  ctypes.c_float(s))
    return out


def _gemm(a, pack, name, mode, res=None, out_dtype=torch.int8):
    """int8 a (B, R, K) against the packed GEMM ``name`` -> (B, R, n)."""
    wt = getattr(pack, name + "_w")
    n, k = wt.shape
    out = torch.empty((*a.shape[:-1], n), dtype=out_dtype, device=a.device)
    so, sr = getattr(pack, name + "_so", None), getattr(pack, name + "_sr", None)
    _build.launch("layer_gemm_s8", a.device, a.data_ptr(), wt.data_ptr(), getattr(pack, name + "_cs").data_ptr(),
                  getattr(pack, name + "_b").data_ptr(), _ptr(so), _ptr(sr), _ptr(res), out.data_ptr(),
                  a.numel() // k, n, k, mode, int(res is not None and res.dtype == BF16), int(out_dtype == BF16))
    return out


def head_map(ld, rows, batch, heads, d_k, box_rows):
    """The head map S3 reads Q, K or V through in place (``HeadMap`` in
    ``csrc/attention_sm90.cuh``): a projection buffer (batch, rows, ld) int8
    whose head h lies at columns h d_k on from the map's base, as the 4-D
    tensor (columns d_k, head, rows, batch) with byte strides (d_k, ld,
    rows ld), read in boxes of 128 columns x ``box_rows`` rows of one head
    and item. Innermost first, as the TMA encoding takes them."""
    return {"dims": (d_k, heads, rows, batch), "strides": (d_k, ld, rows * ld), "box": (128, 1, box_rows, 1)}


def values_scratch_shape(batch, heads, m, d_k):
    """The V^T scratch of S3's wgmma int8 P.V instance: (batch * heads, d_k,
    Mp), Mp = M rounded up to PV_KEYS, the keys of each 32 in ``key_order``
    (``attention.int8_pv_values`` of each head's V), written by the call."""
    return (batch * heads, d_k, _round_up(m, PV_KEYS))


def attention_instance(d_k, int8_pv):
    """The S3 instance that runs at head width d_k (``.cu`` header)."""
    return _build.library().layer_attention_instance(d_k, int(bool(int8_pv))).decode()


def _attention(q, kv, d, k_off, v_off, n_heads, att, int8_pv):
    """Q at columns [0, d) of q (B, N, ldq); K and V at columns k_off and
    v_off of kv (B, M, ldkv) -> the attention output quantized at s_att,
    int8 (B, N, d). ``att`` = (sscale, s_v, s_att)."""
    B, N, ldq = q.shape
    M, ldkv = kv.shape[1], kv.shape[2]
    d_k = d // n_heads
    sscale, s_v, s_att = att
    out = torch.empty((B, N, d), dtype=torch.int8, device=q.device)
    vt = None
    if int8_pv and d_k <= SM90_MAX_DK:
        vt = torch.empty(values_scratch_shape(B, n_heads, M, d_k), dtype=torch.int8, device=q.device)
    base = kv.data_ptr()
    _build.launch("layer_attention_s8", q.device, q.data_ptr(), base + k_off, base + v_off, out.data_ptr(), _ptr(vt),
                  0 if vt is None else vt.shape[-1], B, n_heads, N, M, d_k, ldq, ldkv, d, ctypes.c_float(sscale),
                  ctypes.c_float(s_v / 127.0 if int8_pv else s_v), ctypes.c_float(s_att), int(bool(int8_pv)))
    return out


def _check(x, pack, kernel):
    if x.device.type != "cuda":
        raise NotImplementedError(f"{kernel} runs on a CUDA tensor, not on {x.device}")
    limit = kernel_limit(x.shape[-1], pack.n_heads)
    if x.ndim != 3 or x.shape[-1] != pack.d or limit is not None:
        raise NotImplementedError(f"{kernel}: x {tuple(x.shape)} for a layer of width {pack.d}; {limit or ''}")
    if x.dtype not in (F32, BF16) or pack.qkv_w.device != x.device:
        raise ValueError(f"{kernel} takes f32 or bf16 x on the weights' device, got {x.dtype} on {x.device}")
    return x.contiguous()


def _self_attention_block(x, pack, int8_pv):
    """LN1, Q|K|V, attention, Wo and the residual: x2 (B, N, d) f32."""
    d = pack.d
    qkv = _gemm(_ln_quant(x, pack.ln1a, pack.ln1b, pack.scales.s_y), pack, "qkv", _REQUANT)
    a = _attention(qkv, qkv, d, d, 2 * d, pack.n_heads, pack.att, int8_pv)
    return _gemm(a, pack, "o", _RESIDUAL, res=x, out_dtype=F32)


def _ff(x2, pack, ln, out_dtype):
    """LN, FF1 with ReLU and requantization, FF2 and the residual."""
    y = _ln_quant(x2, getattr(pack, ln + "a"), getattr(pack, ln + "b"), pack.scales.s_ff)
    h = _gemm(y, pack, "ff1", _RELU_REQUANT)
    return _gemm(h, pack, "ff2", _RESIDUAL, res=x2, out_dtype=out_dtype)


def encoder_layer_int8(x, pack: FusedLayerWeights, *, int8_pv=True):
    """x (B, N, d) f32 or bf16 on the card -> the layer's output in x's
    dtype, through K11a (7 launches, counted once). Off the card it raises."""
    x = _check(x, pack, "K11a (encoder_layer_int8)")
    out = _ff(_self_attention_block(x, pack, int8_pv), pack, "ln2", x.dtype)
    LAUNCHES["encoder_layer_int8"] += 1
    return out


def decoder_layer_int8(x, memory, pack: FusedLayerWeights, *, int8_pv=True):
    """x (B, N, d) and memory (B, M, d), f32 or bf16, on the card -> the
    layer's output in x's dtype, through K11b (13 launches, counted once)."""
    x = _check(x, pack, "K11b (decoder_layer_int8)")
    memory = _check(memory, pack, "K11b (decoder_layer_int8)")
    if memory.shape[0] != x.shape[0]:
        raise ValueError(f"memory {tuple(memory.shape)} does not match x {tuple(x.shape)}")
    d, sc = pack.d, pack.scales
    x2 = _self_attention_block(x, pack, int8_pv)
    q2 = _gemm(_ln_quant(x2, pack.ln2a, pack.ln2b, sc.s_y2), pack, "xq", _REQUANT)
    kv2 = _gemm(_ln_quant(memory, None, None, sc.s_mem, do_ln=False), pack, "xkv", _REQUANT)
    a2 = _attention(q2, kv2, d, 0, d, pack.n_heads, pack.xatt, int8_pv)
    x3 = _gemm(a2, pack, "xo", _RESIDUAL, res=x2, out_dtype=F32)
    out = _ff(x3, pack, "ln3", x.dtype)
    LAUNCHES["decoder_layer_int8"] += 1
    return out
