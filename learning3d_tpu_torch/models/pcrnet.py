"""iPCRNet, iterative single-pass-alignment registration, counterpart of
``learning3d_tpu/models/pcrnet.py``: pooled PointNet features of the
template and of the current source -> MLP 2*emb -> 1024 -> 1024 -> 512 ->
512 -> 256 -> 7, a pose (unit quaternion, translation) composed over
``max_iteration`` refinement steps (``default_iterations`` = 8).

The pooled features go through ``PointNet.pooled_features``, so in bf16
eval on the card every pooling is one launch of K1: 1 + max_iteration a
forward. The pose's composition and the moved source are computed in the
promoted type of the step and the state (f32 for an f32 input, whatever
the model's compute dtype), as products summed elementwise (no TF32).
Dropout, where ``droput`` > 0, draws from a generator the model owns.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.ops import quaternion as quat
from learning3d_tpu_torch.ops import se3
from learning3d_tpu_torch.ops.transforms import transform_point_cloud
from learning3d_tpu_torch.utils.layers import Dropout, Linear, to_bnc, validate_input_shape


class iPCRNet(nn.Module):
    def __init__(self, feature_model: nn.Module, droput: float = 0.0, pooling: str = "max",  # (sic) reference spelling
                 input_shape: str = "bnc", *, dtype=None, generator: torch.Generator | None = None,
                 dropout_generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.feature_model = feature_model
        self.pooling = Pooling(pooling)
        # serving-time default for forward's max_iteration (the reference
        # forward's 8); evaluate.py's --num_iters overrides it
        self.default_iterations = 8
        emb = feature_model.emb_dims
        dims = [emb * 2, 1024, 1024, 512, 512, 256]
        self.linears = nn.ModuleList(Linear(i, o, dtype=dtype, generator=generator, device=device)
                                     for i, o in zip(dims[:-1], dims[1:]))
        self.dropout = Dropout(droput, generator=dropout_generator, device=device) if droput > 0.0 else None
        self.head = Linear(256, 7, dtype=dtype, generator=generator, device=device)

    def _pool_feat(self, points):
        if self.pooling.pool_type == "max" and hasattr(self.feature_model, "pooled_features"):
            return self.feature_model.pooled_features(points)
        return self.pooling(self.feature_model(points))

    def _spam(self, template_features, source, est_R, est_t):
        source_features = self._pool_feat(source)
        y = torch.cat([template_features, source_features], dim=-1)
        for lin in self.linears:
            y = torch.relu(lin(y))
        if self.dropout is not None:
            y = self.dropout(y)
        pose = self.head(y)  # (B, 7)
        q = quat.qnormalize(pose[:, :4])
        t = pose[:, 4:]
        R_step = quat.quat2mat(q)
        R = R_step.to(torch.promote_types(R_step.dtype, est_t.dtype))
        # compose: new = step o old (reference models/pcrnet.py:42-46)
        est_t = (R * est_t[:, None, :]).sum(-1) + t
        est_R = (R[:, :, :, None] * est_R[:, None, :, :]).sum(-2)
        source = transform_point_cloud(source, R.to(torch.promote_types(R.dtype, source.dtype)), t)
        return est_R, est_t, source, source_features

    def forward(self, template, source, max_iteration: int | None = None):
        if max_iteration is None:
            max_iteration = self.default_iterations
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        B = template.shape[0]
        est_R = torch.eye(3, dtype=template.dtype, device=template.device).expand(B, 3, 3)
        est_t = torch.zeros((B, 3), dtype=template.dtype, device=template.device)
        template_features = self._pool_feat(template)

        source_features = None
        for _ in range(max_iteration):
            est_R, est_t, source, source_features = self._spam(template_features, source, est_R, est_t)

        return {
            "est_R": est_R,  # source -> template
            "est_t": est_t,
            "est_T": se3.from_rt(est_R, est_t),
            "r": template_features - source_features,
            "transformed_source": source,
        }
