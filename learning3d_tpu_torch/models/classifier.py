"""Classification head, counterpart of ``learning3d_tpu/models/classifier.py``:
pooled encoder features -> Linear 512 -> 256 -> num_classes with BatchNorm
and dropout 0.7 (inert in eval). Returns logits. Both dropouts draw from one
``torch.Generator`` on the model's device: ``dropout_generator``, or a new
one seeded with 0."""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.utils.layers import BatchNorm, Dropout, Linear


class Classifier(nn.Module):
    def __init__(self, feature_model: nn.Module, num_classes: int = 40, *, dtype=None,
                 generator: torch.Generator | None = None, dropout_generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        if dropout_generator is None:
            dropout_generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
        self.feature_model = feature_model
        self.num_classes = num_classes
        emb = feature_model.emb_dims
        self.linear1 = Linear(emb, 512, dtype=dtype, generator=generator, device=device)
        self.bn1 = BatchNorm(512, dtype=dtype, device=device)
        self.dropout1 = Dropout(0.7, generator=dropout_generator)
        self.linear2 = Linear(512, 256, dtype=dtype, generator=generator, device=device)
        self.bn2 = BatchNorm(256, dtype=dtype, device=device)
        self.dropout2 = Dropout(0.7, generator=dropout_generator)
        self.linear3 = Linear(256, num_classes, dtype=dtype, generator=generator, device=device)
        self.pooling = Pooling("max")

    def forward(self, input_data):
        if hasattr(self.feature_model, "pooled_features"):
            x = self.feature_model.pooled_features(input_data)
        else:
            x = self.pooling(self.feature_model(input_data))
        return self.head(x)

    def head(self, x):
        """Logits from pooled features (B, emb)."""
        x = self.dropout1(torch.relu(self.bn1(self.linear1(x))))
        x = self.dropout2(torch.relu(self.bn2(self.linear2(x))))
        return self.linear3(x)
