"""FlowNet3D, scene-flow estimation, counterpart of
``learning3d_tpu/models/flownet3d.py``: four set-abstraction layers (FPS,
ball query, a shared MLP, max pool), a flow embedding between the two
clouds' second levels, three set-upconv layers and a three-NN feature
propagation back to the first cloud's points, then a per-point head.
Channel-last (B, N, C), the JAX package's parameter names.

On the card a forward samples on K14 six times and groups on K15 six times
(sa1 and sa2 on each cloud, sa3 and sa4 on the first) and interpolates on
K8 once (``three_nn`` of N points among sa1's samples, where those are >=
512); the flow embedding's and the set-upconv layers' kNN search clouds of
at most 256 points, below K8's gate, and take the plain path. The
selections (FPS, ball query, kNN) are made on detached operands and their
indices carry no gradient, as in the JAX package; the gathered coordinates
and features do.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops.geometry import (farthest_point_sample, index_points, knn_point, query_ball_point,
                                               three_interpolate, three_interpolate_weights, three_nn)
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear


class _ConvBN2d(nn.Module):
    """relu(bn(x @ W)) over the last axis, the reference's Conv2d(1x1) +
    BatchNorm2d + ReLU."""

    def __init__(self, i, o, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.lin = Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(o, dtype=dtype, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.lin(x)))


def _blocks(dims, **kw):
    return nn.ModuleList(_ConvBN2d(i, o, **kw) for i, o in zip(dims[:-1], dims[1:]))


class PointNetSetAbstraction(nn.Module):
    """FPS + ball-query grouping + shared MLP + max pool."""

    def __init__(self, npoint, radius, nsample, in_channel, mlp, group_all, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all
        self.blocks = _blocks([in_channel + 3, *mlp], dtype=dtype, generator=generator, device=device)

    def forward(self, xyz, points):
        """xyz (B, N, 3), points (B, N, D) or None -> (new_xyz (B, S, 3),
        features (B, S, mlp[-1])); with ``group_all`` new_xyz is xyz and the
        features (B, 1, mlp[-1]), as in the JAX package."""
        if self.group_all:
            new_xyz = xyz
            grouped = xyz[:, None, :, :]
            if points is not None:
                grouped = torch.cat([grouped, points[:, None, :, :]], -1)
        else:
            new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([grouped, index_points(points, idx)], -1)
        h = grouped
        for blk in self.blocks:
            h = blk(h)
        return new_xyz, torch.amax(h, dim=2)


class FlowEmbedding(nn.Module):
    """Cross-cloud kNN correlation: for each point of the first cloud its
    nsample nearest of the second, their offsets and features beside its
    own, a shared MLP and a max pool. ``approx_knn`` is kept for the JAX
    signature; the port selects exactly (``ops.geometry``)."""

    def __init__(self, radius, nsample, in_channel, mlp, approx_knn=False, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.nsample = nsample
        self.approx_knn = approx_knn
        self.blocks = _blocks([in_channel * 2 + 3, *mlp], dtype=dtype, generator=generator, device=device)

    def forward(self, pos1, pos2, feat1, feat2):
        _, idx = knn_point(self.nsample, pos2, pos1, approx=self.approx_knn)
        pos_diff = index_points(pos2, idx) - pos1[:, :, None, :]  # (B, N, S, 3)
        feat2_grouped = index_points(feat2, idx)  # (B, N, S, C)
        feat1_tiled = feat1[:, :, None, :].expand(feat2_grouped.shape)
        h = torch.cat([pos_diff, feat2_grouped, feat1_tiled], dim=-1)
        for blk in self.blocks:
            h = blk(h)
        return pos1, torch.amax(h, dim=2)


class PointNetSetUpConv(nn.Module):
    """Upsampling by kNN grouping of the coarse level, a shared MLP, a max
    pool, the skip features concatenated, a second MLP."""

    def __init__(self, nsample, radius, f1_channel, f2_channel, mlp, mlp2, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.nsample = nsample
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.blocks1 = _blocks([f2_channel + 3, *mlp], **kw)
        last = (mlp[-1] if mlp else f2_channel + 3) + f1_channel
        self.blocks2 = _blocks([last, *mlp2], **kw)

    def forward(self, pos1, pos2, feat1, feat2):
        """pos1 fine (B, N, 3), pos2 coarse (B, S, 3) -> (B, N, C')."""
        _, idx = knn_point(self.nsample, pos2, pos1)
        pos_diff = index_points(pos2, idx) - pos1[:, :, None, :]
        h = torch.cat([index_points(feat2, idx), pos_diff], dim=-1)
        for blk in self.blocks1:
            h = blk(h)
        h = torch.amax(h, dim=2)  # (B, N, C)
        if feat1 is not None:
            h = torch.cat([h, feat1], dim=-1)
        for blk in self.blocks2:
            h = blk(h)
        return h


class PointNetFeaturePropogation(nn.Module):
    """Three-NN inverse-distance interpolation + MLP (the reference's
    spelling)."""

    def __init__(self, in_channel, mlp, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.blocks = _blocks([in_channel, *mlp], dtype=dtype, generator=generator, device=device)

    def forward(self, pos1, pos2, feat1, feat2):
        dists, idx = three_nn(pos1, pos2)
        weight = three_interpolate_weights(torch.clamp(dists, min=1e-10), eps=0.0)
        h = three_interpolate(feat2, idx, weight)
        if feat1 is not None:
            h = torch.cat([h, feat1], -1)
        for blk in self.blocks:
            h = blk(h)
        return h


class FlowNet3D(nn.Module):
    def __init__(self, *, dtype=None, generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.sa1 = PointNetSetAbstraction(1024, 0.5, 16, 3, [32, 32, 64], False, **kw)
        self.sa2 = PointNetSetAbstraction(256, 1.0, 16, 64, [64, 64, 128], False, **kw)
        self.sa3 = PointNetSetAbstraction(64, 2.0, 8, 128, [128, 128, 256], False, **kw)
        self.sa4 = PointNetSetAbstraction(16, 4.0, 8, 256, [256, 256, 512], False, **kw)
        self.fe_layer = FlowEmbedding(10.0, 64, 128, [128, 128, 128], **kw)
        self.su1 = PointNetSetUpConv(8, 2.4, 256, 512, [], [256, 256], **kw)
        self.su2 = PointNetSetUpConv(8, 1.2, 128 + 128, 256, [128, 128, 256], [256], **kw)
        self.su3 = PointNetSetUpConv(8, 0.6, 64, 256, [128, 128, 256], [256], **kw)
        self.fp = PointNetFeaturePropogation(256 + 3, [256, 256], **kw)
        self.conv1 = Linear(256, 128, use_bias=False, **kw)
        self.bn1 = BatchNorm(128, dtype=dtype, device=device)
        self.conv2 = Linear(128, 3, **kw)

    def forward(self, pc1, pc2, feature1, feature2):
        """pc1, pc2 (B, N, 3), feature1, feature2 (B, N, 3) -> flow (B, N, 3)."""
        l1_pc1, l1_f1 = self.sa1(pc1, feature1)
        l2_pc1, l2_f1 = self.sa2(l1_pc1, l1_f1)
        l1_pc2, l1_f2 = self.sa1(pc2, feature2)
        l2_pc2, l2_f2 = self.sa2(l1_pc2, l1_f2)

        _, l2_f1_new = self.fe_layer(l2_pc1, l2_pc2, l2_f1, l2_f2)

        l3_pc1, l3_f1 = self.sa3(l2_pc1, l2_f1_new)
        l4_pc1, l4_f1 = self.sa4(l3_pc1, l3_f1)

        l3_fnew1 = self.su1(l3_pc1, l4_pc1, l3_f1, l4_f1)
        l2_fnew1 = self.su2(l2_pc1, l3_pc1, torch.cat([l2_f1, l2_f1_new], -1), l3_fnew1)
        l1_fnew1 = self.su3(l1_pc1, l2_pc1, l1_f1, l2_fnew1)
        l0_fnew1 = self.fp(pc1, l1_pc1, feature1, l1_fnew1)

        x = torch.relu(self.bn1(self.conv1(l0_fnew1)))
        return self.conv2(x)
