"""CurveNet, classification by guided curve walks, counterpart of
``learning3d_tpu/models/curvenet.py``: LPFA lifts the coordinates to 32
channels, eight CIC blocks run at 1024, 256 and 64 points (the curves in
the first four), then a conv to 1024 channels, max and mean pools and the
classifier. Channel-last (B, N, C), the JAX package's parameter names.

The npoints are the architecture's (1024 -> 256 -> 64), so a whole model
runs on clouds of 1024 points. One self-inclusive kNN a resolution serves
LPFA and every CIC block at that resolution, as in the JAX package: on the
card a forward runs K8 once (21 nearest of 1024, in the gate), K14 twice
and K15 twice (the masked max pools to 256 and 64 points); the kNN at 256
and 64 points lies below K8's gate (N >= 512, as the JAX package's) and
takes the plain path. The dropout mask comes from ``dropout_generator`` (a
new generator seeded with 0 by default).
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.ops.geometry import knn
from learning3d_tpu_torch.utils.curvenet_blocks import CIC, LPFA
from learning3d_tpu_torch.utils.layers import BatchNorm, Dropout, Linear, to_bnc, validate_input_shape

curve_config = {
    "default": [[100, 5], [100, 5], None, None],
    "long": [[10, 30], None, None, None],
}


class CurveNet(nn.Module):
    def __init__(self, num_classes: int = 40, k: int = 20, setting: str = "default", input_shape: str = "bnc", *,
                 dtype=None, generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        if setting not in curve_config:
            raise ValueError(setting)
        if dropout_generator is None:
            dropout_generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
        self.emb_dims = 1024
        kw = dict(dtype=dtype, generator=generator, device=device)
        cc = curve_config[setting]
        additional = 32
        self.lpfa = LPFA(9, additional, k=k, mlp_num=1, initial=True, **kw)

        def mk(npoint, radius, ic, oc, br, conf):
            return CIC(npoint=npoint, radius=radius, k=k, in_channels=ic, output_channels=oc, bottleneck_ratio=br,
                       mlp_num=1, curve_config=conf, **kw)

        self.cic11 = mk(1024, 0.05, additional, 64, 2, cc[0])
        self.cic12 = mk(1024, 0.05, 64, 64, 4, cc[0])
        self.cic21 = mk(1024, 0.05, 64, 128, 2, cc[1])
        self.cic22 = mk(1024, 0.1, 128, 128, 4, cc[1])
        self.cic31 = mk(256, 0.1, 128, 256, 2, cc[2])
        self.cic32 = mk(256, 0.2, 256, 256, 4, cc[2])
        self.cic41 = mk(64, 0.2, 256, 512, 2, cc[3])
        self.cic42 = mk(64, 0.4, 512, 512, 4, cc[3])
        self.conv0_lin = Linear(512, 1024, use_bias=False, **kw)
        self.conv0_bn = BatchNorm(1024, dtype=dtype, device=device)
        self.conv1 = Linear(1024 * 2, 512, use_bias=False, **kw)
        self.bn1 = BatchNorm(512, dtype=dtype, device=device)
        self.dp1 = Dropout(0.5, generator=dropout_generator)
        self.conv2 = Linear(512, num_classes, **kw)

    def forward(self, xyz):
        """xyz (B, N, 3) -> logits (B, num_classes)."""
        xyz = to_bnc(xyz, self.input_shape)
        idx0 = knn(xyz, self.lpfa.k + 1)  # one kNN for every block at the input's resolution
        l0 = self.lpfa(xyz, xyz, idx=idx0[..., : self.lpfa.k])
        x1, p1, i1 = self.cic11(xyz, l0, idx=idx0)
        x1, p1, i1 = self.cic12(x1, p1, idx=i1)
        x2, p2, i2 = self.cic21(x1, p1, idx=i1)
        x2, p2, i2 = self.cic22(x2, p2, idx=i2)
        x3, p3, i3 = self.cic31(x2, p2)
        x3, p3, i3 = self.cic32(x3, p3, idx=i3)
        x4, p4, i4 = self.cic41(x3, p3)
        x4, p4, i4 = self.cic42(x4, p4, idx=i4)
        h = torch.relu(self.conv0_bn(self.conv0_lin(p4)))  # (B, 64, 1024)
        h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        h = self.dp1(torch.relu(self.bn1(self.conv1(h))))
        return self.conv2(h)
