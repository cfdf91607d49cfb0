"""RPMNet, robust point matching registration, counterpart of
``learning3d_tpu/models/rpmnet.py``: a parameter network predicts the
annealing parameters (beta, alpha) from both clouds, PPFNet features give a
hybrid affinity, the slack log-domain Sinkhorn turns it into soft
correspondences, and a weighted Kabsch solve gives the transform; iterated
with the transform detached between iterations, each solve against the
original source. The template's features are computed once, outside the
loop. Channel-last (B, N, 6) clouds (xyz and normals), the JAX package's
parameter names and output dict.

On the card a forward of ``default_iterations`` = 2 launches K16 three
times (PPFNet on the template once and on the source each iteration) and
K17 twice (once an iteration); K17's gradient recomputes through its plain
version. The feature distances are a matmul expansion (``torch.matmul``, full
f32 unless TF32 is switched on).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.models.ppfnet import PPFNet, _ConvGN
from learning3d_tpu_torch.utils.layers import Linear, to_bnc, validate_input_shape
from learning3d_tpu_torch.utils.rigid import rotate, se3_transform_34, sinkhorn_log, weighted_kabsch

_EPS = 1e-5


def _softplus(x):
    """softplus, log(1 + exp(x)), as logaddexp(x, 0): no threshold, as the
    JAX package computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


class ParameterPredictionNet(nn.Module):
    """(beta, alpha) from both clouds: each tagged with a 0/1 indicator
    channel, concatenated along the points, a shared Linear + GroupNorm +
    ReLU stack, a max over the points, two more such layers and a head;
    softplus of its two outputs."""

    def __init__(self, weights_dim=(0,), *, dtype=None, generator: torch.Generator | None = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.weights_dim = tuple(weights_dim)
        extra = int(np.prod(self.weights_dim)) if self.weights_dim else 0
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.prepool = nn.ModuleList([_ConvGN(4, 64, 8, **kw), _ConvGN(64, 64, 8, **kw), _ConvGN(64, 64, 8, **kw),
                                      _ConvGN(64, 128, 8, **kw), _ConvGN(128, 1024, 16, **kw)])
        self.post1 = _ConvGN(1024, 512, 16, **kw)
        self.post2 = _ConvGN(512, 256, 16, **kw)
        self.head = Linear(256, 2 + extra, **kw)

    def forward(self, src, ref):
        x = torch.cat([F.pad(src, (0, 1), value=0.0), F.pad(ref, (0, 1), value=1.0)], dim=1)  # (B, J+K, 4)
        for blk in self.prepool:
            x = blk(x)
        pooled = torch.amax(x, dim=1)  # (B, 1024)
        raw = self.head(self.post2(self.post1(pooled)))
        return _softplus(raw[:, 0]), _softplus(raw[:, 1])


def match_features(feat_src, feat_ref):
    """Squared-L2 feature distances (B, J, K), the matmul expansion in the
    JAX package's order: (-2 src ref^T + |src|^2) + |ref|^2. One matmul, not
    ``ops.geometry.square_distance``'s per-channel chain (made for the
    selections' C = 3): at PPFNet's 96 channels that chain is 96 passes over
    the (B, J, K) matrix, and as many again in the backward."""
    d = -2.0 * torch.matmul(feat_src, feat_ref.transpose(-1, -2))
    d = d + torch.sum(feat_src * feat_src, dim=-1)[..., :, None]
    return d + torch.sum(feat_ref * feat_ref, dim=-1)[..., None, :]


class RPMNet(nn.Module):
    def __init__(self, feature_model: nn.Module | None = None, input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.add_slack = True
        self.num_sk_iter = 5
        # the forward's iterations unless the call says otherwise, in
        # serving and in training alike (the JAX package's recipe default;
        # the reference forward takes 1)
        self.default_iterations = 2
        self.weights_net = ParameterPredictionNet((0,), dtype=dtype, generator=generator, device=device)
        self.feat_extractor = feature_model or PPFNet(dtype=dtype, generator=generator, device=device)

    @staticmethod
    def compute_affinity(beta, feat_distance, alpha):
        return -beta[:, None, None] * (feat_distance - alpha[:, None, None])

    @staticmethod
    def split_normals(data):
        if data.shape[2] == 6:
            return data[..., :3], data[..., 3:6]
        return data, torch.zeros_like(data)

    def _spam(self, xyz_template, xyz_source, norm_source, feat_template):
        beta, alpha = self.weights_net(xyz_source, xyz_template)
        feat_source = self.feat_extractor(xyz_source, norm_source)
        affinity = self.compute_affinity(beta, match_features(feat_source, feat_template), alpha)
        perm = torch.exp(sinkhorn_log(affinity, n_iters=self.num_sk_iter, slack=self.add_slack))  # (B, J, K)
        weighted_template = torch.matmul(perm, xyz_template) / (torch.sum(perm, dim=2, keepdim=True) + _EPS)
        return weighted_template, perm, affinity, beta, alpha, feat_template - feat_source

    def forward(self, template, source, max_iterations: int | None = None):
        """template (B, K, 6), source (B, J, 6) (or xyz only, (B, *, 3), with
        zero normals) -> dict: est_R, est_t, est_T (B, 4, 4) mapping source
        onto template, r (the last iteration's feature residual),
        transformed_source, and per iteration perm_matrices_init (exp of the
        affinity), perm_matrices, weighted_template, transforms; beta and
        alpha stacked (iterations, B)."""
        if max_iterations is None:
            max_iterations = self.default_iterations
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        xyz_template, norm_template = self.split_normals(template)
        xyz_source, norm_source = self.split_normals(source)
        xyz_source_t, norm_source_t = xyz_source, norm_source

        transforms_hist, perms, gammas, weighted_hist, betas, alphas = [], [], [], [], [], []
        transform = r = None
        feat_template = self.feat_extractor(xyz_template, norm_template)
        for _ in range(max_iterations):
            weighted_template, perm, affinity, beta, alpha, r = self._spam(xyz_template, xyz_source_t,
                                                                           norm_source_t, feat_template)
            transform = weighted_kabsch(xyz_source, weighted_template, torch.sum(perm, dim=2))
            cut = transform.detach()  # no gradient between iterations
            xyz_source_t = se3_transform_34(cut, xyz_source)
            norm_source_t = rotate(cut[:, :, :3], norm_source)

            transforms_hist.append(transform)
            perms.append(perm)
            gammas.append(torch.exp(affinity))
            weighted_hist.append(weighted_template)
            betas.append(beta)
            alphas.append(alpha)

        R = transform[:, :3, :3]
        t = transform[:, :3, 3]
        bottom = torch.zeros((R.shape[0], 1, 4), dtype=R.dtype, device=R.device)
        bottom[:, 0, 3] = 1.0
        est_T = torch.cat([transform, bottom], dim=1)
        return {
            "est_R": R,
            "est_t": t,
            "est_T": est_T,
            "r": r,
            "transformed_source": se3_transform_34(transform, source[..., :3]),
            "perm_matrices_init": gammas,
            "perm_matrices": perms,
            "weighted_template": weighted_hist,
            "beta": torch.stack(betas),
            "alpha": torch.stack(alphas),
            "transforms": transforms_hist,
        }
