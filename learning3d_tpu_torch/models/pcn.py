"""PCN, point-cloud completion, counterpart of ``learning3d_tpu/models/pcn.py``:
a two-stage shared-MLP encoder (3 -> 128 -> 256, the pooled 256 tiled and
concatenated, 512 -> 512 -> emb, max-pooled), a fully connected coarse
decoder (emb -> 1024 -> 1024 -> 3 * num_coarse) and, with
``detailed_output``, the folding decoder: a g x g grid (np.linspace(-0.05,
0.05, g), "ij" order) around every coarse point, num_coarse * g^2 fine
points.

The folding decoder's first layer, conv5 over concat(grid, center, global),
is split by linearity as in the JAX package: its 5 local input channels run
per fine point, its emb global ones once per cloud, so the (B, F, emb + 5)
tensor never exists. conv5 stays one ``Linear(emb + 5, 512)``, so its
weight crosses from the JAX package as one kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.utils.layers import Linear, _compute_dtype, validate_input_shape


class PCN(nn.Module):
    def __init__(self, emb_dims: int = 1024, input_shape: str = "bnc", num_coarse: int = 1024, grid_size: int = 4,
                 detailed_output: bool = False, *, dtype=None, generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.emb_dims = emb_dims
        self.num_coarse = num_coarse
        self.grid_size = grid_size
        self.detailed_output = detailed_output
        self.num_fine = grid_size**2 * num_coarse
        self.pooling = Pooling("max")

        def linear(i, o):
            return Linear(i, o, dtype=dtype, generator=generator, device=device)

        # encoder stages 1 and 2 (no norms, as in the reference)
        self.conv1 = linear(3, 128)
        self.conv2 = linear(128, 256)
        self.conv3 = linear(512, 512)
        self.conv4 = linear(512, emb_dims)
        # coarse decoder
        self.linear1 = linear(emb_dims, 1024)
        self.linear2 = linear(1024, 1024)
        self.linear3 = linear(1024, num_coarse * 3)
        if detailed_output:
            self.conv5 = linear(emb_dims + 5, 512)
            self.conv6 = linear(512, 512)
            self.conv7 = linear(512, 3)

    def _encode(self, x):
        h = self.conv2(torch.relu(self.conv1(x)))  # (B, N, 256)
        g = self.pooling(h)  # (B, 256)
        h = torch.cat([h, g[:, None, :].expand(h.shape)], dim=-1)  # (B, N, 512)
        h = self.conv4(torch.relu(self.conv3(h)))
        return self.pooling(h)  # (B, emb)

    def _decode(self, v):
        h = torch.relu(self.linear1(v))
        h = torch.relu(self.linear2(h))
        return self.linear3(h).reshape(v.shape[0], self.num_coarse, 3)

    def _fine(self, coarse, v):
        B = coarse.shape[0]
        g = self.grid_size
        lin = np.linspace(-0.05, 0.05, g, dtype=np.float32)
        grid = np.stack(np.meshgrid(lin, lin, indexing="ij"), axis=2).reshape(-1, 2)
        grid_feat = torch.from_numpy(grid).to(coarse.device).repeat(self.num_coarse, 1).expand(B, -1, -1)  # (B, F, 2)
        center = torch.repeat_interleave(coarse, g * g, dim=1)  # (B, F, 3)
        local = torch.cat([grid_feat.to(center.dtype), center], dim=-1)  # (B, F, 5)
        # conv5 on concat(grid, center, global) split by linearity: the
        # global part runs once a cloud, in conv5's compute dtype
        dt = _compute_dtype(self.conv5.dtype, local, self.conv5.weight)
        w = self.conv5.weight.to(dt)  # (512, 5 + emb)
        h_local = F.linear(local.to(dt), w[:, :5])
        h_glob = F.linear(v.to(dt), w[:, 5:], self.conv5.bias.to(dt))  # (B, 512)
        h = torch.relu(h_local + h_glob[:, None, :])
        h = torch.relu(self.conv6(h))
        return self.conv7(h) + center

    def forward(self, input_data):
        x = input_data
        if self.input_shape == "bcn":
            x = x.transpose(1, 2)
        if x.shape[-1] != 3:
            raise RuntimeError("expected 3-channel point clouds")
        v = self._encode(x)
        coarse = self._decode(v)
        result = {"coarse_output": coarse}
        if self.detailed_output:
            result["fine_output"] = self._fine(coarse, v)
        return result
