"""Per-point segmentation head, counterpart of
``learning3d_tpu/models/segmentation.py``: a PointNet with
``global_feat=False`` (the global feature tiled beside the first block's
point features, emb + 64 channels), then per-point Linear + BatchNorm + ReLU
layers (emb + 64) -> 512 -> 256 -> 128 and a Linear to ``num_classes``
logits, (B, N, num_classes). The head's BatchNorms follow the module's
train or eval mode (momentum 0.9, as every BatchNorm of the port). No
kernel runs here in either package: the encoder's features are per point.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear


class Segmentation(nn.Module):
    def __init__(self, feature_model: nn.Module, num_classes: int = 40, *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.feature_model = feature_model
        self.num_classes = num_classes
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.conv1 = Linear(feature_model.emb_dims + 64, 512, **kw)
        self.conv2 = Linear(512, 256, **kw)
        self.conv3 = Linear(256, 128, **kw)
        self.conv4 = Linear(128, num_classes, **kw)
        self.bn1 = BatchNorm(512, dtype=dtype, device=device)
        self.bn2 = BatchNorm(256, dtype=dtype, device=device)
        self.bn3 = BatchNorm(128, dtype=dtype, device=device)

    def forward(self, input_data):
        x = self.feature_model(input_data)  # (B, N, emb + 64)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = torch.relu(self.bn3(self.conv3(x)))
        return self.conv4(x)  # (B, N, num_classes)
