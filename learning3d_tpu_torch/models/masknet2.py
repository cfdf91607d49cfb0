"""MaskNet2 (MaskNet++), inlier masks for both clouds, counterpart of
``learning3d_tpu/models/masknet2.py``: a self-attention PointNet
(``AttnPointNet``: five ``SelfAttn`` stages of bias-free Linear, BatchNorm
and Mish, each followed by a residual beta-gated N x N attention, their
outputs concatenated into 512 channels), max and mean pools of both clouds
coupled by three ``SelfAttentionFC`` blocks, and one mask head shared by both
clouds -> (template_mask, source_mask), soft probabilities (B, N).

The attentions' beta starts at 0, as in the JAX package, so an untrained
model's attention outputs are not used until beta moves. The coupled
blocks normalise (B, 1, C) vectors, so in train mode their BatchNorm
statistics are the batch's alone. Mish is x tanh(softplus(x)) with the JAX
package's softplus, log(1 + e^x) as ``logaddexp(x, 0)`` (torch's
``softplus`` returns x past 20). No kernel: the JAX package reaches none.
Binarizing by a threshold is ``models.masknet.select_by_threshold``. The
JAX signature's ``is_training`` and ``mask_threshold``, which nothing there
reads, are not taken.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, to_bnc, validate_input_shape


def mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


class BasicConv1D(nn.Module):
    """A bias-free per-point Linear, BatchNorm and (``active``) Mish."""

    def __init__(self, in_ch, out_ch, active=True, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.conv = Linear(in_ch, out_ch, use_bias=False, dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(out_ch, dtype=dtype, device=device)
        self.active = active

    def forward(self, x):
        x = self.bn(self.conv(x))
        return mish(x) if self.active else x


class SelfAttn(nn.Module):
    """q = BasicConv1D(x); q + beta * softmax(q q^T) q, channel-last (B, N,
    C) -> (B, N, out)."""

    def __init__(self, in_dim, out_dim, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.query_conv = BasicConv1D(in_dim, out_dim, dtype=dtype, generator=generator, device=device)
        self.beta = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        q = self.query_conv(x)
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, q), -1)
        return self.beta.to(q.dtype) * torch.einsum("bnm,bmc->bnc", attn, q) + q


class AttnPointNet(nn.Module):
    """Five SelfAttn stages (3 -> 32 -> 64 -> 64, 64 -> 128 on the sum of
    stages 2 and 3, -> emb_dims), concatenated: (B, N, 288 + emb_dims)."""

    def __init__(self, emb_dims=224, input_shape="bnc", *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = input_shape
        self.emb_dims = emb_dims
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.conv1 = SelfAttn(3, 32, **kw)
        self.conv2 = SelfAttn(32, 64, **kw)
        self.conv3 = SelfAttn(64, 64, **kw)
        self.conv4 = SelfAttn(64, 128, **kw)
        self.conv5 = SelfAttn(128, emb_dims, **kw)

    def forward(self, x):
        if self.input_shape == "bcn":
            x = x.transpose(1, 2)
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(x3 + x2)
        x5 = self.conv5(x4)
        return torch.cat([x1, x2, x3, x4, x5], -1)


class SelfAttentionFC(nn.Module):
    """Coupled attention between two global vectors (B, C) -> a pair (B,
    out), through one shared query conv. As in the JAX package (and the
    reference), each side's softmax weights multiply its own query."""

    def __init__(self, in_dim, out_dim, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.query_conv = BasicConv1D(in_dim, out_dim, dtype=dtype, generator=generator, device=device)
        self.beta = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x, y):
        qx = self.query_conv(x[:, None, :])[:, 0]
        qy = self.query_conv(y[:, None, :])[:, 0]
        energy = qx[:, :, None] * qy[:, None, :]  # (B, out, out)
        attn_xy = torch.softmax(energy, -1)
        attn_yx = torch.softmax(energy.transpose(-1, -2), -1)
        out_x = torch.sum(attn_xy * qx[:, None, :], -1)
        out_y = torch.sum(attn_yx * qy[:, None, :], -1)
        beta = self.beta.to(qx.dtype)
        return beta * out_x + qx, beta * out_y + qy


class PointNetMask2(nn.Module):
    def __init__(self, feature_model=None, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.feature_model = feature_model if feature_model is not None else AttnPointNet(**kw)
        self.pooling_max = Pooling("max")
        self.pooling_avg = Pooling("avg")
        self.global_feat_1 = SelfAttentionFC(1024, 512, **kw)
        self.global_feat_2 = SelfAttentionFC(512, 256, **kw)
        self.global_feat_3 = SelfAttentionFC(256, 512, **kw)
        dims = [1024, 512, 256, 128]
        self.h3 = nn.ModuleList(BasicConv1D(i, o, **kw) for i, o in zip(dims[:-1], dims[1:]))
        self.out = Linear(128, 1, **kw)

    def _head(self, point_feats, global_feats):
        g = global_feats[:, None, :].expand(point_feats.shape[:2] + global_feats.shape[-1:])
        x = torch.cat([point_feats, g], -1)
        for blk in self.h3:
            x = blk(x)
        return torch.sigmoid(self.out(x))[..., 0]

    def forward(self, template, source):
        sf = self.feature_model(source)
        tf = self.feature_model(template)
        gs = torch.cat([self.pooling_max(sf), self.pooling_avg(sf)], -1)
        gt = torch.cat([self.pooling_max(tf), self.pooling_avg(tf)], -1)
        s1, s2 = self.global_feat_1(gs, gt)
        s1, s2 = self.global_feat_2(s1, s2)
        s1, s2 = self.global_feat_3(s1, s2)
        return self._head(tf, s1), self._head(sf, s2)


class MaskNet2(nn.Module):
    def __init__(self, feature_model=None, input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.maskNet = PointNetMask2(feature_model, dtype=dtype, generator=generator, device=device)

    def forward(self, template, source):
        """-> (template_mask (B, N_t), source_mask (B, N_s)), soft inlier
        probabilities."""
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        return self.maskNet(template, source)
