"""PointNetLK, inverse-compositional Lucas-Kanade registration on PointNet
features, counterpart of ``learning3d_tpu/models/pointnetlk.py``.

The Jacobian of the template's pooled feature with respect to a twist is
taken by finite differences: the template moved by each of the six twists
exp(-dt_i e_i), embedded as one batch of B * 6 clouds. Its damped normal
equations give the pseudo-inverse once, and each iteration moves the source
by the current estimate, embeds it, and composes the update
exp(-pinv r). The loop has a fixed trip count: a pair whose update falls
below ``xtol`` keeps its estimate and its residual from then on (the JAX
package's ``lax.scan`` with a converged mask), with no early exit and no
read of the card's values on the host.

BatchNorm: when an encoder BatchNorm is in train mode, the template and the
source are embedded once in train mode first, which updates the running
statistics (the outputs are discarded); every embedding used afterwards
reads the running statistics (``pooled_features(use_running_average=True)``).
With a 1024-wide encoder in f32 train mode those two warm-up passes are K3
launches; the frozen f32 embeddings take the plain path, as in the JAX
package (K1 is a bf16 kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE, resolve_device
from learning3d_tpu_torch.models.pooling import Pooling
from learning3d_tpu_torch.ops import invmat, mean_shift, se3
from learning3d_tpu_torch.ops.so3 import matvec3
from learning3d_tpu_torch.utils.layers import to_bnc, validate_input_shape


class PointNetLK(nn.Module):
    def __init__(self, feature_model: nn.Module, delta: float = 1.0e-2, learn_delta: bool = False,
                 xtol: float = 1.0e-7, p0_zero_mean: bool = True, p1_zero_mean: bool = True, pooling: str = "max",
                 damping: float = 1e-6, input_shape: str = "bnc", *, device=DEFAULT_DEVICE):
        # damping: Tikhonov term on J^T J, where the reference returns the
        # identity on a singular matrix (pointnetlk.py:138-156)
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.feature_model = feature_model
        self.pooling = Pooling(pooling)
        dt = torch.full((1, 6), delta, dtype=torch.float32, device=resolve_device(device))
        if learn_delta:
            self.dt = nn.Parameter(dt)
        else:
            self.register_buffer("dt", dt)
        self.xtol = xtol
        self.p0_zero_mean = p0_zero_mean
        self.p1_zero_mean = p1_zero_mean
        self.damping = damping

    def _embed(self, points, frozen=True):
        ura = True if frozen else None
        if self.pooling.pool_type == "max" and hasattr(self.feature_model, "pooled_features"):
            return self.feature_model.pooled_features(points, use_running_average=ura)
        return self.pooling(self.feature_model(points, use_running_average=ura))

    def _approx_jac(self, template, template_features):
        """J[b, k, i] = (f0 - f(exp(-dt_i e_i) p0))_k / dt_i -> (B, K, 6)."""
        B, N, _ = template.shape
        dt = self.dt[0]  # (6,)
        transf = se3.exp(-torch.diag(dt))  # (6, 4, 4), shared across the batch
        p = se3.transform(transf[None, :, None], template[:, None])  # (B, 6, N, 3)
        f = self._embed(p.reshape(B * 6, N, 3)).reshape(B, 6, -1)
        df = template_features[:, None, :] - f  # (B, 6, K)
        return df.transpose(1, 2) / dt

    def forward(self, template, source, maxiter: int = 10):
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        a0 = a1 = None
        t0, s0 = template, source
        if self.p0_zero_mean or self.p1_zero_mean:
            c0, c1, a0, a1 = mean_shift.mean_shift(template, source)
            eye = torch.eye(4, dtype=template.dtype, device=template.device).expand(a0.shape)
            t0, a0 = (c0, a0) if self.p0_zero_mean else (template, eye)
            s0, a1 = (c1, a1) if self.p1_zero_mean else (source, eye)

        est_T, r, series = self._iclk(t0, s0, maxiter)
        if a0 is not None:
            est_T = mean_shift.postprocess(est_T, a0, a1)
            series = mean_shift.postprocess(series, a0, a1)
        return {
            "est_R": est_T[:, :3, :3],
            "est_t": est_T[:, :3, 3],
            "est_T": est_T,
            "r": r,
            "transformed_source": se3.transform(est_T[:, None], source),
            "est_T_series": series,  # (maxiter + 1, B, 4, 4)
        }

    def _iclk(self, template, source, maxiter):
        B = template.shape[0]
        bns = [b for b in getattr(self.feature_model, "bns", []) if b is not None]
        if any(not b.use_running() for b in bns):
            with torch.no_grad():  # the running statistics' update only
                self._embed(template, frozen=False)
                self._embed(source, frozen=False)
        f0 = self._embed(template)
        pinv = invmat.pinv_via_normal_eqs(self._approx_jac(template, f0), self.damping)  # (B, 6, K)

        eye = torch.eye(4, dtype=template.dtype, device=template.device).expand(B, 4, 4)
        est_T = eye
        r = torch.zeros((B, f0.shape[-1]), dtype=f0.dtype, device=f0.device)
        done = torch.zeros(B, dtype=torch.bool, device=template.device)
        series = [eye]
        for _ in range(maxiter):
            r_new = self._embed(se3.transform(est_T[:, None], source)) - f0  # (B, K)
            pose = -matvec3(pinv, r_new)  # (B, 6)
            done_now = done | (torch.linalg.vector_norm(pose, dim=-1) < self.xtol)
            est_T = torch.where(done_now[:, None, None], est_T, se3.compose(se3.exp(pose), est_T))
            r = torch.where(done[:, None], r, r_new)
            done = done_now
            series.append(est_T)
        return est_T, r, torch.stack(series)
