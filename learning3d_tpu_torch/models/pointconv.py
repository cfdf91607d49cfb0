"""PointConv, the density-reweighted point-convolution classifier,
counterpart of ``learning3d_tpu/models/pointconv.py``: DensityNet,
WeightNet, PointConvDensitySetAbstraction (kNN grouping and a weighted
matmul over each neighbourhood) and the three-stage SSG classifier.
Channel-last (B, N, C), the JAX package's parameter names.

As in the JAX package (and the reference): DensityNet applies ReLU after
every layer, FPS starts at point 0, and the classifier returns
``log_softmax`` of its logits (``train.tasks.classification`` applies
``log_softmax`` again, as the JAX task does).

On the card a forward samples on K14 twice (1024 -> 512 -> 128 at the
architecture's npoints) and selects neighbours on K8 twice (k 32 among N
for 512 queries, k 64 among 512 for 128 queries), on detached operands; the
gathered offsets, features and densities carry the gradient. The kernel
density holds a (B, N, N) matrix a stage.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.ops.grouping import compute_density, sample_and_group_all, sample_and_group_knn
from learning3d_tpu_torch.utils.layers import BatchNorm, Dropout, Linear, to_bnc, validate_input_shape


class _Conv2dBN(nn.Module):
    """relu(bn(x @ W + b)) over the last axis."""

    def __init__(self, i, o, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.lin = Linear(i, o, dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(o, dtype=dtype, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.lin(x)))


def _stack(dims, **kw):
    return nn.ModuleList(_Conv2dBN(i, o, **kw) for i, o in zip(dims[:-1], dims[1:]))


class DensityNet(nn.Module):
    def __init__(self, hidden=(16, 8), *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.blocks = _stack([1, *hidden, 1], dtype=dtype, generator=generator, device=device)

    def forward(self, scale):
        for blk in self.blocks:
            scale = blk(scale)
        return scale


class WeightNet(nn.Module):
    def __init__(self, in_ch=3, out_ch=16, hidden=(8, 8), *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.blocks = _stack([in_ch, *hidden, out_ch], dtype=dtype, generator=generator, device=device)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class PointConvDensitySetAbstraction(nn.Module):
    def __init__(self, npoint, nsample, in_channel, mlp, bandwidth, group_all, *, dtype=None, generator=None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.npoint = npoint
        self.nsample = nsample
        self.bandwidth = bandwidth
        self.group_all = group_all
        self.mlp_blocks = _stack([in_channel, *mlp], **kw)
        self.weightnet = WeightNet(3, 16, **kw)
        self.linear = Linear(16 * mlp[-1], mlp[-1], **kw)
        self.bn_linear = BatchNorm(mlp[-1], dtype=dtype, device=device)
        self.densitynet = DensityNet(**kw)

    def forward(self, xyz, points):
        """xyz (B, N, 3), points (B, N, D) or None -> (new_xyz (B, S, 3),
        features (B, S, mlp[-1]))."""
        B = xyz.shape[0]
        inverse_density = 1.0 / compute_density(xyz, self.bandwidth)  # (B, N)
        if self.group_all:
            new_xyz, new_points = sample_and_group_all(xyz, points)
            grouped_norm = xyz[:, None, :, :]
            grouped_density = inverse_density[:, None, :, None]
            S = 1
        else:
            new_xyz, new_points, grouped_norm, grouped_density = sample_and_group_knn(
                self.npoint, self.nsample, xyz, points, density_scale=inverse_density)
            S = self.npoint
        h = new_points
        for blk in self.mlp_blocks:
            h = blk(h)  # (B, S, K, C')
        inv_max = torch.amax(grouped_density, dim=2, keepdim=True)
        h = h * self.densitynet(grouped_density / inv_max)  # (B, S, K, 1) density scale
        weights = self.weightnet(grouped_norm)  # (B, S, K, 16)
        out = torch.einsum("bskc,bskw->bscw", h, weights).reshape(B, S, -1)
        return new_xyz, torch.relu(self.bn_linear(self.linear(out)))


class PointConvDensityClsSsg(nn.Module):
    """Three set abstractions (npoint 512 and 128, then one group of all)
    -> (B, emb_dims) features, or with ``classifier`` the log-softmax of 40
    (``num_classes``) logits after fc 512 -> 256 with BatchNorm and dropout
    0.7, whose masks come from ``dropout_generator`` (a new generator seeded
    with 0 by default)."""

    def __init__(self, emb_dims: int = 1024, input_shape: str = "bnc", input_channel_dim: int = 3,
                 classifier: bool = False, num_classes: int = 40, pretrained=None, *, dtype=None,
                 generator: torch.Generator | None = None, dropout_generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if pretrained is not None:
            raise NotImplementedError("pretrained: the reference's torch weights do not load here; use "
                                      "utils.jax_import.load_nnx_state or a Trainer checkpoint")
        self.input_shape = validate_input_shape(input_shape)
        self.emb_dims = emb_dims
        self.classifier = classifier
        self.input_channel_dim = input_channel_dim
        kw = dict(dtype=dtype, generator=generator, device=device)
        extra = input_channel_dim - 3
        self.sa1 = PointConvDensitySetAbstraction(512, 32, 3 + extra, [64, 64, 128], 0.1, False, **kw)
        self.sa2 = PointConvDensitySetAbstraction(128, 64, 128 + 3, [128, 128, 256], 0.2, False, **kw)
        self.sa3 = PointConvDensitySetAbstraction(1, None, 256 + 3, [256, 512, emb_dims], 0.4, True, **kw)
        if classifier:
            if dropout_generator is None:
                dropout_generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
            self.fc1 = Linear(emb_dims, 512, **kw)
            self.bn1 = BatchNorm(512, dtype=dtype, device=device)
            self.drop1 = Dropout(0.7, generator=dropout_generator)
            self.fc2 = Linear(512, 256, **kw)
            self.bn2 = BatchNorm(256, dtype=dtype, device=device)
            self.drop2 = Dropout(0.7, generator=dropout_generator)
            self.fc3 = Linear(256, num_classes, **kw)

    def forward(self, input_data):
        x = to_bnc(input_data, self.input_shape)
        xyz, feats = x[..., :3], (x[..., 3:] if x.shape[-1] > 3 else None)
        l1_xyz, l1_feats = self.sa1(xyz, feats)
        l2_xyz, l2_feats = self.sa2(l1_xyz, l1_feats)
        _, l3_feats = self.sa3(l2_xyz, l2_feats)
        features = l3_feats[:, 0, :]  # (B, emb)
        if not self.classifier:
            return features
        h = self.drop1(torch.relu(self.bn1(self.fc1(features))))
        h = self.drop2(torch.relu(self.bn2(self.fc2(h))))
        return torch.log_softmax(self.fc3(h), dim=-1)


def create_pointconv(classifier=False, pretrained=None):
    """The reference's factory: returns the class (its torch weights do not
    load here; use ``utils.jax_import.load_nnx_state`` or a Trainer
    checkpoint)."""
    return PointConvDensityClsSsg
