"""Post-training int8 quantization for serving, counterpart of
``learning3d_tpu/quant.py``.

The recipe is the JAX package's:

* symmetric per-output-channel int8 weights (s_w = max|W_col| / 127);
* static per-tensor activation scales calibrated from a batch (a
  percentile of |activation| for the classifier, abs-max for the pointer);
* eval-mode BatchNorm folded into the conv weights before quantization;
* the first conv (3 -> 64) and the logits layer stay bf16.

Every quantized model is an ``nn.Module``, so ``serve.InferenceEngine``
serves it as it is. On the card:

* ``make_fused_quant_forward(qm)`` runs the classifier's encoder and pool as
  the CUDA kernel K2 (``kernels.pointnet_fused.pointnet_pooled_int8``);
* ``quantize_dcp(..., fused_layers=False)`` runs DCP's encoder as K9
  (``DGCNN.int8_scales``) and the pointer's attention cores as K10
  (``kernels.attention.attention_int8``), with the projections and the
  feed-forwards as plain int8 products (``torch._int_mm``), as the JAX
  package leaves them to XLA;
* ``quantize_dcp(..., fused_layers=True)`` (the default) runs each pointer
  layer as one layer kernel, K11a or K11b
  (``kernels.transformer_int8``), at the shapes of the JAX package's gate.

Each epilogue repeats the JAX package's order of float32 operations, so the
integer tensors equal its own on the CPU wherever the two round alike.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from learning3d_tpu_torch.kernels.attention import attention_int8
from learning3d_tpu_torch.kernels.dgcnn_fused import calibrate_dgcnn_int8
from learning3d_tpu_torch.kernels.pointnet_fused import (
    PointNetInt8Weights,
    fold_conv_bn,
    pointnet_pooled_int8_kernel,
)
from learning3d_tpu_torch.kernels.transformer_int8 import (
    FusedLayerWeights,
    LayerScales,
    decoder_layer_int8,
    decoder_layer_int8_reference,
    encoder_layer_int8,
    encoder_layer_int8_reference,
    fused_layer_ok,
)
from learning3d_tpu_torch.ops.int8 import div, f32_scalar, int8_matmul, percentile, quantize_weight, to_int8
from learning3d_tpu_torch.utils.layers import to_bnc

F32, BF16 = torch.float32, torch.bfloat16


def quantize_activation(x, s_x):
    """round(x / s_x) clamped to +-127, int8."""
    return to_int8(div(x.to(F32), s_x))


def _requant(y, s):
    """f32 -> int8 at the static scale s."""
    return to_int8(div(y, s))


def _act_scale(x, percentile_=99.99):
    """Static symmetric activation scale, a 0-d f32 tensor: the
    ``percentile_`` of |x| over the whole tensor (at least 1e-6) / 127."""
    return div(torch.clamp_min(percentile(torch.abs(x.to(F32)), percentile_), 1e-6), 127.0)


def _folded_stack(convs, bns):
    return [fold_conv_bn(c, bn) for c, bn in zip(convs, bns)]


def _bias(lin):
    out = lin.weight.shape[0]
    return lin.bias.float() if lin.bias is not None else torch.zeros(out, device=lin.weight.device)


class QuantLinear(nn.Module):
    """One int8 GEMM layer: y = (x_q @ w_q) * (s_x * s_w) + b."""

    def __init__(self, w_q, s_w, b, s_x):
        super().__init__()
        self.register_buffer("w_q", w_q.to(torch.int8).contiguous())
        self.register_buffer("s_w", s_w.to(F32))
        self.register_buffer("b", b.to(F32))
        self.register_buffer("s_x", torch.as_tensor(s_x, dtype=F32, device=w_q.device).reshape(()))

    def forward(self, x, relu=True):
        acc = int8_matmul(quantize_activation(x, self.s_x), self.w_q)
        y = acc.to(F32) * (self.s_x * self.s_w) + self.b
        return torch.relu(y) if relu else y


def _bf16_linear(x, w, b):
    """bf16-rounded operands, exact products, f32 sums, f32 bias."""
    return torch.matmul(x.to(BF16).to(F32), w.to(BF16).to(F32)) + b


class QuantPointNetClassifier(nn.Module):
    """Quantized eval forward of Classifier(PointNet(global_feat=True)):
    conv1 in bf16 -> conv2..conv5 int8 -> ReLU and max over points (f32) ->
    head fc1/fc2 int8 -> the logits layer in bf16. x (B, N, 3) -> logits."""

    def __init__(self, w1, b1, enc, head, w_out, b_out):
        super().__init__()
        self.register_buffer("w1", w1.to(F32).contiguous())
        self.register_buffer("b1", b1.to(F32))
        self.enc = nn.ModuleList(enc)
        self.head = nn.ModuleList(head)
        self.register_buffer("w_out", w_out.to(F32).contiguous())
        self.register_buffer("b_out", b_out.to(F32))

    def forward(self, x):
        h = torch.relu(_bf16_linear(x, self.w1, self.b1))
        for i, q in enumerate(self.enc):
            h = q(h, relu=i < len(self.enc) - 1)
        g = torch.relu(torch.amax(h, dim=1))  # relu and max commute
        return self.logits(g)

    def logits(self, g):
        for q in self.head:
            g = q(g, relu=True)
        return _bf16_linear(g, self.w_out, self.b_out)


def quant_forward(qm, x):
    """The plain int8 forward (no kernel): the JAX package's jitted entry."""
    return qm(x)


class FusedQuantPointNetClassifier(nn.Module):
    """The classifier's int8 serving entry on the card: the encoder chain
    and the pool run as K2 (one launch a batch), the head as in
    ``QuantPointNetClassifier``. The activation scales are read from the
    device once, here."""

    def __init__(self, qm: QuantPointNetClassifier):
        super().__init__()
        self.qm = qm
        qlayers = [(q.w_q, q.s_w, q.b, float(q.s_x)) for q in qm.enc]
        self.pack = PointNetInt8Weights(qm.w1, qm.b1, qlayers)

    def forward(self, x):
        return self.qm.logits(pointnet_pooled_int8_kernel(x.float(), self.pack))


def make_fused_quant_forward(qm):
    """The serving entry through K2, as a module (the JAX package returns a
    jitted partial)."""
    return FusedQuantPointNetClassifier(qm)


def quantize_pointnet_classifier(model, calib_x, percentile=99.99):
    """PTQ a Classifier(PointNet) in eval mode into a
    QuantPointNetClassifier, calibrating the static activation scales on
    ``calib_x`` (B, N, 3) by replaying the f32 folded chain."""
    with torch.no_grad():
        pn = model.feature_model
        enc_folded = _folded_stack(pn.convs, pn.bns)
        w1, b1 = enc_folded[0]
        head_folded = [fold_conv_bn(model.linear1, model.bn1), fold_conv_bn(model.linear2, model.bn2)]
        w_out, b_out = model.linear3.weight.float().t().contiguous(), _bias(model.linear3)

        h = torch.relu(torch.matmul(calib_x.to(F32), w1) + b1)
        enc = []
        for i, (w, b) in enumerate(enc_folded[1:]):
            s_x = _act_scale(h, percentile)
            enc.append(QuantLinear(*quantize_weight(w), b, s_x))
            z = torch.matmul(h, w) + b
            h = z if i == len(enc_folded) - 2 else torch.relu(z)
        g = torch.relu(torch.amax(h, dim=1))
        head = []
        for w, b in head_folded:
            s_x = _act_scale(g, percentile)
            head.append(QuantLinear(*quantize_weight(w), b, s_x))
            g = torch.relu(torch.matmul(g, w) + b)
    return QuantPointNetClassifier(w1, b1, enc, head, w_out, b_out)


# ---------------------------------------------------------------- DCP ---


class _AmaxRecorder(nn.Module):
    """Wraps a Linear during the calibration pass, recording max|input|
    and max|output| as Python floats."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.amax = 0.0
        self.amax_out = 0.0

    def forward(self, x):
        self.amax = max(self.amax, float(torch.amax(torch.abs(x.to(F32)))))
        y = self.inner(x)
        self.amax_out = max(self.amax_out, float(torch.amax(torch.abs(y.to(F32)))))
        return y


def _scale(rec_amax):
    return max(rec_amax, 1e-6) / 127.0


MHA_SCALES = ("s_in_q", "s_in_kv", "s_q", "s_k", "s_v", "s_att")
FF_SCALES = ("s_in", "s_h")


class QuantMHA(nn.Module):
    """Serving-mode int8 multi-head attention (eval only), a drop-in for
    ``utils.transformer.MultiHeadedAttention``: one quantization of the
    block input feeds the Q projection and the merged K|V projection; each
    projection requantizes in its epilogue (K and V at their own scales), so
    the attention core K10 takes int8 q, k, v; the output projection reads
    the core's output as int8. Buffers carry the JAX package's variable
    names; the six activation scales are Python floats, as there."""

    def __init__(self, h, d_k, tensors, scales, int8_pv=False, out_dtype=None):
        super().__init__()
        self.h, self.d_k = h, d_k
        self.int8_pv = bool(int8_pv)
        self.out_dtype = out_dtype or F32
        for name in ("wq_q", "wkv_q", "wo_q"):
            self.register_buffer(name, torch.as_tensor(tensors[name]).to(torch.int8).contiguous())
        for name in ("s_wq", "bq", "s_wkv", "bkv", "s_wo", "bo"):
            self.register_buffer(name, torch.as_tensor(tensors[name]).to(F32))
        for name in MHA_SCALES:
            setattr(self, name, float(scales[name]))
        d = h * d_k
        s_kv = torch.cat([torch.full((d,), self.s_k, dtype=F32), torch.full((d,), self.s_v, dtype=F32)])
        self.register_buffer("s_kv", s_kv.to(self.bkv.device))

    @classmethod
    def from_float(cls, mha, rec_q, rec_k, rec_v, rec_o, int8_pv=False):
        w = {n: getattr(mha, n).weight.float().t() for n in ("wq", "wk", "wv", "wo")}
        wq_q, s_wq = quantize_weight(w["wq"])
        wkv_q, s_wkv = quantize_weight(torch.cat([w["wk"], w["wv"]], dim=1))
        wo_q, s_wo = quantize_weight(w["wo"])
        tensors = dict(wq_q=wq_q, s_wq=s_wq, bq=_bias(mha.wq), wkv_q=wkv_q, s_wkv=s_wkv,
                       bkv=torch.cat([_bias(mha.wk), _bias(mha.wv)]), wo_q=wo_q, s_wo=s_wo, bo=_bias(mha.wo))
        scales = dict(s_in_q=_scale(rec_q.amax), s_in_kv=_scale(rec_k.amax), s_q=_scale(rec_q.amax_out),
                      s_k=_scale(rec_k.amax_out), s_v=_scale(rec_v.amax_out), s_att=_scale(rec_o.amax))
        return cls(mha.h, mha.d_k, tensors, scales, int8_pv, mha.wo.dtype)

    def _project(self, x_q, s_in, w_q, s_w, b, s_out):
        acc = int8_matmul(x_q, w_q)
        return _requant(acc.to(F32) * (s_w * f32_scalar(s_in, s_w)) + b, s_out)

    def forward(self, query, key, value):
        B, N, _ = query.shape
        d = self.h * self.d_k
        x_q = quantize_activation(query, self.s_in_q)
        if key is query:  # self-attention: reuse the quantized input
            kv_src, s_in = x_q, self.s_in_q
        else:  # cross-attention: quantize the memory once for K and V
            kv_src, s_in = quantize_activation(key, self.s_in_kv), self.s_in_kv
        acc = int8_matmul(kv_src, self.wkv_q)
        kv = _requant((acc.to(F32) * (self.s_wkv * f32_scalar(s_in, acc)) + self.bkv) / self.s_kv, 1.0)
        q_i8 = self._project(x_q, self.s_in_q, self.wq_q, self.s_wq, self.bq, self.s_q)

        def split(t, n):
            return t.reshape(B, n, self.h, self.d_k).transpose(1, 2)

        M = key.shape[1]
        o = attention_int8(split(q_i8, N), split(kv[..., :d], M), split(kv[..., d:], M),
                           self.s_q, self.s_k, self.s_v, int8_pv=self.int8_pv)  # (B, h, N, d_k) bf16
        o_q = quantize_activation(o.transpose(1, 2).reshape(B, N, d), self.s_att)
        acc = int8_matmul(o_q, self.wo_q)
        out = acc.to(F32) * (self.s_wo * f32_scalar(self.s_att, acc)) + self.bo
        return out.to(self.out_dtype)


class QuantFF(nn.Module):
    """Serving-mode int8 feed-forward (eval only), a drop-in for
    ``utils.transformer.FeedForward``: quantize once -> int8 GEMM -> ReLU
    and requantization -> int8 GEMM -> the stream's dtype."""

    def __init__(self, tensors, scales, out_dtype=None):
        super().__init__()
        self.out_dtype = out_dtype or F32
        for name in ("w1_q", "w2_q"):
            self.register_buffer(name, torch.as_tensor(tensors[name]).to(torch.int8).contiguous())
        for name in ("s_w1", "b1", "s_w2", "b2"):
            self.register_buffer(name, torch.as_tensor(tensors[name]).to(F32))
        for name in FF_SCALES:
            setattr(self, name, float(scales[name]))

    @classmethod
    def from_float(cls, ff, rec1, rec2):
        w1_q, s_w1 = quantize_weight(ff.w1.weight.float().t())
        w2_q, s_w2 = quantize_weight(ff.w2.weight.float().t())
        tensors = dict(w1_q=w1_q, s_w1=s_w1, b1=_bias(ff.w1), w2_q=w2_q, s_w2=s_w2, b2=_bias(ff.w2))
        return cls(tensors, dict(s_in=_scale(rec1.amax), s_h=_scale(rec2.amax)), ff.w2.dtype)

    def forward(self, x):
        acc = int8_matmul(quantize_activation(x, self.s_in), self.w1_q)
        h = torch.relu(acc.to(F32) * (self.s_w1 * f32_scalar(self.s_in, acc)) + self.b1)
        acc = int8_matmul(_requant(h, self.s_h), self.w2_q)
        out = acc.to(F32) * (self.s_w2 * f32_scalar(self.s_h, acc)) + self.b2
        return out.to(self.out_dtype)


_LINEARS = {"mha": ("wq", "wk", "wv", "wo"), "ff": ("w1", "w2")}


def _record(inner, kind):
    recs = {a: _AmaxRecorder(getattr(inner, a)) for a in _LINEARS[kind]}
    for a, rec in recs.items():
        setattr(inner, a, rec)
    return recs


def _swap_in(owner, attr, kind, recs, int8_pv):
    """Restore the recorded Linears and replace the block by its int8 twin."""
    inner = getattr(owner, attr)
    for a, rec in recs.items():
        setattr(inner, a, rec.inner)
    if kind == "mha":
        q = QuantMHA.from_float(inner, recs["wq"], recs["wk"], recs["wv"], recs["wo"], int8_pv=int8_pv)
    else:
        q = QuantFF.from_float(inner, recs["w1"], recs["w2"])
    setattr(owner, attr, q)


def quantize_transformer_layer(layer, calib_fn, int8_pv=False):
    """Per-layer PTQ on ONE encoder or decoder layer: record the activation
    amax on a calibration pass (``calib_fn(layer)`` runs one forward), then
    swap the layer's attention blocks for QuantMHA and its feed-forward for
    QuantFF."""
    sites = [("self_attn", "mha"), ("ff", "ff")]
    if hasattr(layer, "cross_attn"):
        sites.insert(1, ("cross_attn", "mha"))
    recs = {attr: _record(getattr(layer, attr), kind) for attr, kind in sites}
    with torch.no_grad():
        calib_fn(layer)
    for attr, kind in sites:
        _swap_in(layer, attr, kind, recs[attr], int8_pv)
    return layer


def _pointer_blocks(pointer):
    """(owner, attr, kind, path) of every MHA/FF block in the pointer; the
    path is the block's dotted name under the DCP model."""
    out = []
    for i, layer in enumerate(pointer.enc_layers):
        p = f"pointer.enc_layers.{i}"
        out += [(layer, "self_attn", "mha", f"{p}.self_attn"), (layer, "ff", "ff", f"{p}.ff")]
    for i, layer in enumerate(pointer.dec_layers):
        p = f"pointer.dec_layers.{i}"
        out += [(layer, "self_attn", "mha", f"{p}.self_attn"), (layer, "cross_attn", "mha", f"{p}.cross_attn"),
                (layer, "ff", "ff", f"{p}.ff")]
    return out


def _fused_weights_mha(qmha, prefix=""):
    """Weight-dict entries of one QuantMHA for the fused layer: its merged
    K|V GEMM splits back exactly (per-output-channel scales)."""
    d = qmha.h * qmha.d_k
    p = prefix
    return {
        p + "wq": qmha.wq_q, p + "swq": qmha.s_wq, p + "bq": qmha.bq,
        p + "wk": qmha.wkv_q[:, :d], p + "swk": qmha.s_wkv[:d], p + "bk": qmha.bkv[:d],
        p + "wv": qmha.wkv_q[:, d:], p + "swv": qmha.s_wkv[d:], p + "bv": qmha.bkv[d:],
        p + "wo": qmha.wo_q, p + "swo": qmha.s_wo, p + "bo": qmha.bo,
    }


def _fused_weights_ff(qff):
    return {"w1": qff.w1_q, "sw1": qff.s_w1, "b1": qff.b1, "w2": qff.w2_q, "sw2": qff.s_w2, "b2": qff.b2}


class _FusedInt8Layer(nn.Module):
    """A pointer layer whose quantized blocks run as ONE layer kernel, K11a
    or K11b (``kernels/transformer_int8.py``), where the JAX package's gate
    ``fused_layer_ok`` holds: a CUDA tensor launches the kernel, a CPU tensor
    runs its plain version (the JAX package composes the blocks off its
    accelerator; ROADMAP Queue 3 records the departure), any other device
    raises. Off the gate the layer composes its blocks, on every device, as
    the JAX package does. The kernel's operands are packed once, here."""

    def __init__(self, layer, int8_pv=True):
        super().__init__()
        self.inner = layer
        self.int8_pv = bool(int8_pv)
        self.n_heads = layer.self_attn.h
        self.scales = self._scales()
        with torch.no_grad():
            self.pack = FusedLayerWeights(self.weights(), self.scales, self.n_heads, self.decoder)

    def weights(self):
        """The JAX package's weight dict of the layer (views of the blocks'
        buffers), as the plain versions take it."""
        lyr = self.inner
        w = _fused_weights_mha(lyr.self_attn)
        if self.decoder:
            w.update(_fused_weights_mha(lyr.cross_attn, prefix="x"))
        w.update(_fused_weights_ff(lyr.ff))
        for i in (1, 2, 3) if self.decoder else (1, 2):
            norm = getattr(lyr, f"norm{i}")
            w[f"ln{i}a"], w[f"ln{i}b"] = norm.a.detach(), norm.b.detach()
        return w

    def _on_gate(self, x):
        return fused_layer_ok(x.shape[1], x.shape[2], self.n_heads)

    @property
    def self_attn(self):
        return self.inner.self_attn

    @property
    def ff(self):
        return self.inner.ff


class QuantEncoderLayerFused(_FusedInt8Layer):
    decoder = False

    def _scales(self):
        m, f = self.inner.self_attn, self.inner.ff
        return LayerScales(s_y=m.s_in_q, s_q=m.s_q, s_k=m.s_k, s_v=m.s_v, s_att=m.s_att, s_ff=f.s_in, s_h=f.s_h)

    def forward(self, x):
        if not self._on_gate(x):
            return self.inner(x)
        if x.device.type == "cpu":
            return encoder_layer_int8_reference(x, self.weights(), self.scales, n_heads=self.n_heads,
                                                int8_pv=self.int8_pv)
        return encoder_layer_int8(x, self.pack, int8_pv=self.int8_pv)


class QuantDecoderLayerFused(_FusedInt8Layer):
    decoder = True

    def _scales(self):
        m, c, f = self.inner.self_attn, self.inner.cross_attn, self.inner.ff
        return LayerScales(s_y=m.s_in_q, s_q=m.s_q, s_k=m.s_k, s_v=m.s_v, s_att=m.s_att, s_ff=f.s_in, s_h=f.s_h,
                           s_y2=c.s_in_q, s_mem=c.s_in_kv, s_q2=c.s_q, s_k2=c.s_k, s_v2=c.s_v, s_att2=c.s_att)

    @property
    def cross_attn(self):
        return self.inner.cross_attn

    def forward(self, x, memory):
        if not (self._on_gate(x) and memory.shape[1] == x.shape[1]):
            return self.inner(x, memory)
        if x.device.type == "cpu":
            return decoder_layer_int8_reference(x, memory, self.weights(), self.scales, n_heads=self.n_heads,
                                                int8_pv=self.int8_pv)
        return decoder_layer_int8(x, memory, self.pack, int8_pv=self.int8_pv)


def _fuse_layers(pointer, int8_pv):
    for i, layer in enumerate(list(pointer.enc_layers)):
        pointer.enc_layers[i] = QuantEncoderLayerFused(layer, int8_pv=int8_pv)
    for i, layer in enumerate(list(pointer.dec_layers)):
        pointer.dec_layers[i] = QuantDecoderLayerFused(layer, int8_pv=int8_pv)


def quantize_dcp_pointer(model, calib_template, calib_source, int8_pv=False, fused_layers=True):
    """Serving-mode DCP with an int8 co-attention pointer: a CLONE of
    ``model`` (eval mode) whose pointer attention blocks are QuantMHA and
    whose feed-forwards are QuantFF, calibrated on one pass of the pointer
    over the encoder features of the calibration clouds. LayerNorms and the
    SVD head keep their dtypes."""
    clone = copy.deepcopy(model).eval()
    sites = _pointer_blocks(clone.pointer)
    recs = [_record(getattr(owner, attr), kind) for owner, attr, kind, _ in sites]
    with torch.no_grad():
        tgt_emb = clone.emb_nn(to_bnc(calib_template, clone.input_shape))
        src_emb = clone.emb_nn(to_bnc(calib_source, clone.input_shape))
        clone.pointer(src_emb, tgt_emb)  # what DCP._register feeds the pointer
    for (owner, attr, kind, _), r in zip(sites, recs):
        _swap_in(owner, attr, kind, r, int8_pv)
    if fused_layers:
        _fuse_layers(clone.pointer, int8_pv)
    return clone


def quantize_dcp(model, calib_template, calib_source, int8_pv=False, fused_layers=True):
    """Full int8 DCP serving: the int8 pointer (``quantize_dcp_pointer``)
    and, for a DGCNN encoder, the static scales that route its eval forward
    to K9 (``DGCNN.int8_scales``; its int8 weights are built once, here).
    Returns a clone; ``model`` is untouched."""
    from learning3d_tpu_torch.models.dgcnn import DGCNN

    clone = quantize_dcp_pointer(model, calib_template, calib_source, int8_pv=int8_pv,
                                 fused_layers=fused_layers)
    if isinstance(clone.emb_nn, DGCNN):
        calib = torch.cat([calib_template, calib_source], dim=0)
        enc = clone.emb_nn
        enc.int8_scales = calibrate_dgcnn_int8(enc.convs, enc.bns, enc.k, calib)
    return clone
