"""DGCNN encoder, counterpart of ``learning3d_tpu/models/dgcnn.py``.

Edge features come from kNN (k=20) with (neighbor, center) concatenation;
four 1x1-conv stages, each max-pooled over the neighbors, are concatenated
(64+64+128+256=512) into the final embedding conv. Convs are bias-free with
BatchNorm. In eval mode with bf16 convs the whole encoder is one CUDA
kernel call, K5 (``kernels.dgcnn_fused``), on a weight pack the module
builds once and rebuilds whenever a conv or BatchNorm tensor changes
(``bf16_weights``); once ``int8_scales`` is set
(``quant.quantize_dcp``) it is the int8 kernel K9 instead. Everywhere else
(train mode, f32, shapes past K5's limit) the encoder is the unfused chain,
whose edge features come from K7 (``kernels.edgeconv``). On a CPU tensor
each kernel's plain version runs.

``approx_knn=True`` makes K5 and K9 select neighbors by quantized keys
(the TPU kernel's ``approx_knn``). The JAX package reads that switch from
the ``L3D_APPROX_KNN`` environment variable when it traces; here it is a
constructor flag, kept by ``quant.quantize_dcp``'s clone. The unfused path
has no approximate mode in either package.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.kernels.dgcnn_fused import (
    DGCNNBf16Weights,
    DGCNNInt8Weights,
    dgcnn_encode_int8_kernel,
    dgcnn_encode_packed,
    dgcnn_fused_ok,
    pack_key,
)
from learning3d_tpu_torch.kernels.edgeconv import get_graph_feature_fused
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, to_bnc, validate_input_shape


class DGCNN(nn.Module):
    def __init__(self, emb_dims: int = 1024, input_shape: str = "bnc", k: int = 20, *, approx_knn: bool = False,
                 dtype=None, generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.emb_dims = emb_dims
        self.k = k
        self.approx_knn = bool(approx_knn)
        dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb_dims)]
        self.convs = nn.ModuleList(
            Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device) for i, o in dims
        )
        self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for _, o in dims)
        self._int8_scales = None
        self.int8_weights = None
        self._bf16_pack, self._bf16_key = None, None  # bf16_weights(): kept beside the state, not in it

    def bf16_weights(self) -> DGCNNBf16Weights:
        """K5's weight pack of the current BN-folded convs, built on first
        use and again whenever a conv weight or a BatchNorm parameter,
        buffer or eps differs from what it was built from (``pack_key``:
        in-place edits, optimizer steps and ``load_state_dict`` bump the
        tensors' version counters; a moved or replaced tensor changes
        storage)."""
        key = pack_key(self.convs, self.bns)
        if self._bf16_pack is None or key is None or key != self._bf16_key:
            self._bf16_pack = DGCNNBf16Weights.from_modules(self.convs, self.bns)
            self._bf16_key = key
        return self._bf16_pack

    @property
    def int8_scales(self):
        """The static per-stage activation scales (s1..s4) of int8 serving,
        or None. Setting them (``quant.quantize_dcp``) builds K9's int8
        weights from the current BN-folded convs, once, and routes the eval
        forward to K9."""
        return self._int8_scales

    @int8_scales.setter
    def int8_scales(self, scales):
        self._int8_scales = None if scales is None else tuple(float(s) for s in scales)
        self.int8_weights = None if scales is None else DGCNNInt8Weights.from_modules(
            self.convs, self.bns, self._int8_scales)

    def forward(self, input_data):
        """-> (B, N, emb_dims) per-point features."""
        x = to_bnc(input_data, self.input_shape)
        if x.shape[-1] != 3:
            raise RuntimeError("expected 3-channel point clouds")
        if dgcnn_fused_ok(x, self.convs, self.bns, self.k):
            if self.int8_scales is not None:
                return dgcnn_encode_int8_kernel(x.float(), self.int8_weights, self.k, approx_knn=self.approx_knn)
            return dgcnn_encode_packed(x.float(), self.bf16_weights(), self.k, approx_knn=self.approx_knn)
        e = get_graph_feature_fused(x, k=self.k)  # (B, N, k, 6); K7 on the card
        stage_outputs = []
        for conv, bn in zip(self.convs[:4], self.bns[:4]):
            e = torch.relu(bn(conv(e)))  # (B, N, k, C)
            stage_outputs.append(torch.amax(e, dim=2))  # (B, N, C)
        cat = torch.cat(stage_outputs, dim=-1)  # (B, N, 512)
        return torch.relu(self.bns[4](self.convs[4](cat)))
