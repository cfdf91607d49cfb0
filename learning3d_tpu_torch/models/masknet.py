"""MaskNet, inlier mask estimation, counterpart of
``learning3d_tpu/models/masknet.py``: a shared PointNet embeds both clouds,
the source's max-pooled global feature is tiled over the template's point
features, and a per-point MLP 2 emb -> 1024 -> 512 -> 256 -> 128 -> 1 with a
sigmoid scores each template point.

The source goes through ``PointNet.pooled_features``: in bf16 eval on the
card that is one K1 launch a forward; in train mode the fused tail's K3 and,
in the backward, K4 (inside the JAX package's gate, emb % 128 == 0). The
template goes through the per-point encoder.

``MaskNet`` keeps the N_source best-scoring template points, in the order
``lax.top_k`` gives: descending, the lower index first among equal scores
(a stable sort; ``torch.topk`` promises no order among ties, and a trained
MaskNet's sigmoid saturates to exactly 1.0 on many points).
``select_by_threshold`` is the reference's ragged single-pair selection,
on the host. The JAX signature's ``is_training`` and ``point_selection``,
which nothing there reads, are not taken.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.ops.geometry import index_points
from learning3d_tpu_torch.utils.layers import Linear, to_bnc, validate_input_shape


class PointNetMask(nn.Module):
    def __init__(self, template_feature_size: int = 1024, source_feature_size: int = 1024,
                 feature_model: nn.Module = None, *, dtype=None, generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.feature_model = feature_model
        self.pooling = Pooling("max")
        dims = [template_feature_size + source_feature_size, 1024, 512, 256, 128]
        self.h3 = nn.ModuleList(Linear(i, o, dtype=dtype, generator=generator, device=device)
                                for i, o in zip(dims[:-1], dims[1:]))
        self.out = Linear(128, 1, dtype=dtype, generator=generator, device=device)

    def forward(self, template, source):
        """-> per-template-point inlier probability (B, N_t)."""
        template_features = self.feature_model(template)
        if hasattr(self.feature_model, "pooled_features"):
            g = self.feature_model.pooled_features(source)  # (B, C)
        else:
            g = self.pooling(self.feature_model(source))
        g = g[:, None, :].expand(template_features.shape[:2] + g.shape[-1:])
        x = torch.cat([template_features, g], dim=-1)
        for lin in self.h3:
            x = torch.relu(lin(x))
        return torch.sigmoid(self.out(x))[..., 0]


def top_indices(scores, k):
    """The indices of the k largest scores of each row (B, N) -> (B, k), in
    ``lax.top_k``'s order: descending, the lower index first among equals."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


class MaskNet(nn.Module):
    def __init__(self, feature_model: nn.Module, input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        emb = feature_model.emb_dims
        self.maskNet = PointNetMask(template_feature_size=emb, source_feature_size=emb, feature_model=feature_model,
                                    dtype=dtype, generator=generator, device=device)

    def forward(self, template, source):
        """-> (masked_template (B, N_s, 3), mask (B, N_t)): the N_s = N_source
        best-scoring template points. For the reference's ragged threshold
        selection use ``select_by_threshold``."""
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        mask = self.maskNet(template, source)
        return index_points(template, top_indices(mask, source.shape[1])), mask


def select_by_threshold(template, mask, threshold=0.5):
    """The template points of the first pair whose score exceeds
    ``threshold`` -> numpy ((1, n, 3) points, (1, N_t) bool mask)."""
    def host(a):
        return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    m = host(mask)[0] > threshold
    return host(template)[0][m][None], m[None]
