"""PPFNet feature extractor, counterpart of
``learning3d_tpu/models/ppfnet.py``: for every point, its neighbours within
the radius (the point itself left out, short neighbourhoods padded with the
center) give hybrid features {ppf, dxyz, xyz}, which a shared Linear +
GroupNorm + ReLU stack maps before a max over the neighbours, a second
stack and a last Linear after it; the features are L2-normalised, (B, N,
emb_dims). Channel-last, the JAX package's parameter names.

On the card a forward groups through K16 once (``ops.grouping``); the
grouped geometry carries no gradient (it comes from the data), the layers
do.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops.grouping import sample_and_group_multi
from learning3d_tpu_torch.utils.layers import GroupNorm, Linear, to_bnc, validate_input_shape

_RAW_SIZES = {"xyz": 3, "dxyz": 3, "ppf": 4}
_RAW_ORDER = {"xyz": 0, "dxyz": 1, "ppf": 2}


class _ConvGN(nn.Module):
    """gn(x @ W + b), with a ReLU unless ``act`` is False: the reference's
    Conv(1x1) + GroupNorm + ReLU over the last axis."""

    def __init__(self, i, o, groups=8, act=True, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.lin = Linear(i, o, dtype=dtype, generator=generator, device=device)
        self.gn = GroupNorm(o, groups, dtype=dtype, device=device)
        self.act = act

    def forward(self, x):
        x = self.gn(self.lin(x))
        return torch.relu(x) if self.act else x


class PPFNet(nn.Module):
    def __init__(self, features=("ppf", "dxyz", "xyz"), emb_dims: int = 96, radius: float = 0.3,
                 num_neighbors: int = 64, input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.emb_dims = emb_dims
        self.radius = radius
        self.n_sample = num_neighbors
        self.features = sorted(features, key=lambda f: _RAW_ORDER[f])
        raw_dim = sum(_RAW_SIZES[f] for f in self.features)
        mid = emb_dims
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.prepool = nn.ModuleList([_ConvGN(raw_dim, mid, **kw), _ConvGN(mid, mid, **kw),
                                      _ConvGN(mid, emb_dims * 2, **kw)])
        self.postpool = nn.ModuleList([_ConvGN(emb_dims * 2, emb_dims * 2, **kw), _ConvGN(emb_dims * 2, emb_dims, **kw)])
        self.post_final = Linear(emb_dims, emb_dims, **kw)

    def forward(self, xyz, normals):
        """xyz, normals (B, N, 3) -> (B, N, emb_dims) unit features."""
        xyz = to_bnc(xyz, self.input_shape)
        normals = to_bnc(normals, self.input_shape)
        feats = sample_and_group_multi(-1, self.radius, self.n_sample, xyz, normals)
        feats["xyz"] = feats["xyz"][:, :, None, :].expand(feats["dxyz"].shape)
        x = torch.cat([feats[f] for f in self.features], dim=-1)  # (B, N, n_sample, raw)
        for blk in self.prepool:
            x = blk(x)
        x = torch.amax(x, dim=2)  # (B, N, 2 emb)
        for blk in self.postpool:
            x = blk(x)
        x = self.post_final(x)
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
