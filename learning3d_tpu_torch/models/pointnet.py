"""PointNet encoder, counterpart of ``learning3d_tpu/models/pointnet.py``.

Five 1x1-conv blocks 3->64->64->64->128->emb_dims (optional BatchNorm),
returning per-point features; with ``global_feat=False`` the pooled global
vector is tiled and concatenated with the first-block point features.
Features are channel-last (B, N, C); ``input_shape`` only describes the
input layout.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.kernels.pointnet_fused import pointnet_fused_ok, pointnet_pooled_fused
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, fused_bn_relu_maxpool


class PointNet(nn.Module):
    def __init__(
        self,
        emb_dims: int = 1024,
        input_shape: str = "bnc",
        use_bn: bool = False,
        global_feat: bool = True,
        *,
        channels: int = 3,
        dtype=None,
        generator: torch.Generator | None = None,
        device=DEFAULT_DEVICE,
    ):
        super().__init__()
        if input_shape not in ("bnc", "bcn"):
            raise ValueError("Allowed shapes are 'bcn' and 'bnc'.")
        self.input_shape = input_shape
        self.emb_dims = emb_dims
        self.use_bn = use_bn
        self.global_feat = global_feat
        self.pooling = Pooling("max")

        dims = [channels, 64, 64, 64, 128, emb_dims]
        self.convs = nn.ModuleList(
            Linear(i, o, dtype=dtype, generator=generator, device=device)
            for i, o in zip(dims[:-1], dims[1:])
        )
        if use_bn:
            self.bns = nn.ModuleList(BatchNorm(o, dtype=dtype, device=device) for o in dims[1:])
        else:
            self.bns = [None] * 5

    def _bnc(self, x):
        if self.input_shape == "bcn":
            x = x.transpose(1, 2)
        if x.shape[-1] not in (3, self.convs[0].in_features):
            raise RuntimeError("expected 3-channel point clouds")
        return x

    def forward(self, input_data):
        """-> (B, N, emb_dims), or (B, N, emb_dims + 64) if not global_feat."""
        x = self._bnc(input_data)
        point_feature = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = conv(x)
            if bn is not None:
                x = bn(x)
                if i == 0 and not self.global_feat:
                    point_feature = x  # post-norm, pre-relu (reference idx==1 capture)
            x = torch.relu(x)
            if i == 0 and not self.global_feat and point_feature is None:
                point_feature = x

        if self.global_feat:
            return x
        g = self.pooling(x)  # (B, emb)
        g = g[:, None, :].expand(x.shape[0], x.shape[1], self.emb_dims)
        return torch.cat([g, point_feature], dim=-1)

    def pooled_features(self, input_data):
        """Max-pooled global feature (B, emb_dims): the same values as
        ``max(relu(bn(conv(x))), dim=-2)``. In eval mode with bf16 compute
        the whole chain and the pool run as one CUDA kernel
        (``kernels.pointnet_fused``); otherwise the last stage's BN + ReLU
        + max-pool are fused on the pooled values."""
        if not self.global_feat:
            raise ValueError("pooled_features requires global_feat=True")
        x = self._bnc(input_data)
        if pointnet_fused_ok(x, self.convs, self.bns):
            return pointnet_pooled_fused(x, list(self.convs), list(self.bns))
        for conv, bn in zip(self.convs[:-1], self.bns[:-1]):
            x = conv(x)
            if bn is not None:
                x = bn(x)
            x = torch.relu(x)
        if self.bns[-1] is not None:
            return fused_bn_relu_maxpool(self.convs[-1](x), self.bns[-1])
        return torch.amax(torch.relu(self.convs[-1](x)), dim=-2)
