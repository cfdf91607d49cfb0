"""DeepGMR, registration by Gaussian mixtures in closed form, counterpart of
``learning3d_tpu/models/deepgmr.py``: ClusterNet (a PointNet whose per-point
features are concatenated with their max pool and decoded to the logits of
``n_clusters`` components) softly assigns each point of both clouds, the
mixtures' weights, means and isotropic covariances follow (``gmm_params``),
and a weighted Kabsch solve between the two mixtures' means gives the
transform each way (``gmm_register``, on ``utils/svd3``).

With ``use_rri`` the backbone reads the rotation-invariant representation
(``ops.geometry.get_rri``, 4k channels of the k nearest neighbours): given
clouds of 3 channels the forward computes it on the device from each cloud
centred, as the JAX package does; clouds of 3 + 4k channels (the
dataloader's ``nearest_neighbors``) carry it already. Without RRI the
backbone reads the centred coordinates. No kernel: the JAX package reaches
none on this path.

The casts of the JAX package stay: the inverse covariances and the Kabsch
input are float32 whatever the clouds' type, and the translation is taken in
the clouds' type.
"""

from __future__ import annotations

import torch
from torch import nn

from learning3d_tpu_torch import DEFAULT_DEVICE
from learning3d_tpu_torch.ops import se3
from learning3d_tpu_torch.ops.geometry import get_rri
from learning3d_tpu_torch.ops.so3 import matvec3
from learning3d_tpu_torch.utils.layers import BatchNorm, Linear, to_bnc, validate_input_shape
from learning3d_tpu_torch.utils.svd3 import kabsch_rotation_3x3


def gmm_params(gamma, pts):
    """Soft-assignment mixture statistics: gamma (B, N, J), pts (B, N, 3) ->
    pi (B, J), mu (B, J, 3), sigma (B, J, 3, 3) (isotropic)."""
    n = gamma.shape[1]
    pi = torch.mean(gamma, 1)
    npi = pi * n
    mu = torch.einsum("bnj,bnc->bjc", gamma, pts) / npi[..., None]
    diff = pts[:, :, None, :] - mu[:, None, :, :]  # (B, N, J, 3)
    var = torch.einsum("bnjc,bnjc,bnj->bj", diff, diff, gamma) / npi
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    return pi, mu, var[..., None, None] * eye


def gmm_register(pi_s, mu_s, mu_t, sigma_t):
    """The weighted closed-form registration of mixture s onto mixture t ->
    (B, 4, 4)."""
    c_s = torch.einsum("bj,bjc->bc", pi_s, mu_s)[:, None, :]  # (B, 1, 3)
    c_t = torch.einsum("bj,bjc->bc", pi_s, mu_t)[:, None, :]
    sigma_inv = torch.linalg.inv(sigma_t.float())
    dt = torch.promote_types(mu_s.dtype, sigma_inv.dtype)
    a = (pi_s[..., None] * (mu_s - c_s)).to(dt)  # (B, J, 3)
    wb = torch.sum((mu_t - c_t).to(dt)[..., :, None] * sigma_inv.to(dt), -2)  # (B, J, 3): b^T sigma_inv
    ms = torch.sum(a[..., :, None] * wb[..., None, :], 1)  # (B, 3, 3)
    R = kabsch_rotation_3x3(ms.float())
    t = c_t[:, 0, :] - matvec3(R.to(c_s.dtype), c_s[:, 0, :])
    return se3.from_rt(R.to(t.dtype), t)


class Conv1dBNReLU(nn.Module):
    """A bias-free per-point Linear, BatchNorm, ReLU."""

    def __init__(self, i, o, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        self.lin = Linear(i, o, use_bias=False, dtype=dtype, generator=generator, device=device)
        self.bn = BatchNorm(o, dtype=dtype, device=device)

    def forward(self, x):
        return torch.relu(self.bn(self.lin(x)))


class TNet(nn.Module):
    """A rotation from 6 regressed numbers by Gram-Schmidt, applied to the
    points."""

    def __init__(self, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.encoder = nn.ModuleList([Conv1dBNReLU(3, 64, **kw), Conv1dBNReLU(64, 128, **kw),
                                      Conv1dBNReLU(128, 256, **kw)])
        self.fc1 = Conv1dBNReLU(256, 128, **kw)
        self.fc2 = Conv1dBNReLU(128, 64, **kw)
        self.head = Linear(64, 6, **kw)

    @staticmethod
    def f2R(f):
        def normalize(v):
            return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)), min=1e-8)

        r1 = normalize(f[:, :3])
        proj = torch.sum(r1 * f[:, 3:], -1, keepdim=True)
        r2 = normalize(f[:, 3:] - proj * r1)
        r3 = torch.linalg.cross(r1, r2, dim=-1)
        return torch.stack([r1, r2, r3], dim=2)

    def forward(self, pts):
        f = pts
        for blk in self.encoder:
            f = blk(f)
        f = torch.amax(f, 1)
        R = self.f2R(self.head(self.fc2(self.fc1(f))))
        return matvec3(R[:, None], pts)


class ClusterNet(nn.Module):
    """PointNet with a global-local decoder: features (B, N, d_input) ->
    cluster logits (B, N, n_clusters); d_input is 4 * nearest_neighbors with
    RRI, else 3."""

    def __init__(self, use_rri: bool = True, use_tnet: bool = False, nearest_neighbors: int = 20,
                 d_model: int = 1024, n_clusters: int = 16, *, dtype=None, generator=None, device=DEFAULT_DEVICE):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.use_tnet = use_tnet
        self.tnet = TNet(**kw) if use_tnet else None
        d_input = nearest_neighbors * 4 if use_rri else 3
        dims = [d_input, 64, 128, 256, d_model]
        self.encoder = nn.ModuleList([Conv1dBNReLU(i, o, **kw) for i, o in zip(dims[:-1], dims[1:])])
        dims = [d_model * 2, 512, 256, 128]
        self.decoder = nn.ModuleList([Conv1dBNReLU(i, o, **kw) for i, o in zip(dims[:-1], dims[1:])])
        self.head = Linear(128, n_clusters, **kw)

    def forward(self, feats):
        x = self.tnet(feats) if self.use_tnet else feats
        for blk in self.encoder:
            x = blk(x)
        g = torch.amax(x, 1, keepdim=True)
        y = torch.cat([x, g.expand(x.shape)], -1)
        for blk in self.decoder:
            y = blk(y)
        return self.head(y)


class DeepGMR(nn.Module):
    def __init__(self, use_rri: bool = True, feature_model: nn.Module | None = None, nearest_neighbors: int = 20,
                 d_model: int = 1024, n_clusters: int = 16, input_shape: str = "bnc", *, dtype=None,
                 generator: torch.Generator | None = None, device=DEFAULT_DEVICE):
        super().__init__()
        self.input_shape = validate_input_shape(input_shape)
        self.use_rri = use_rri
        self.nearest_neighbors = nearest_neighbors
        if feature_model is None:
            feature_model = ClusterNet(use_rri=use_rri, nearest_neighbors=nearest_neighbors, d_model=d_model,
                                       n_clusters=n_clusters, dtype=dtype, generator=generator, device=device)
        self.backbone = feature_model

    def forward(self, template, source):
        """Clouds (B, N, 3), or (B, N, 3 + 4k) with the RRI features appended
        -> a dict of est_R, est_t, est_T (source -> template), their inverses
        (template -> source), r (the backbone's inputs' difference) and the
        transformed source."""
        template = to_bnc(template, self.input_shape)
        source = to_bnc(source, self.input_shape)
        if self.use_rri and template.shape[-1] == 3:
            k = self.nearest_neighbors
            template = torch.cat([template, get_rri(template - template.mean(1, keepdim=True), k)], -1)
            source = torch.cat([source, get_rri(source - source.mean(1, keepdim=True), k)], -1)
        if self.use_rri:
            template_xyz, template_feats = template[..., :3], template[..., 3:]
            source_xyz, source_feats = source[..., :3], source[..., 3:]
        else:
            template_xyz, source_xyz = template, source
            template_feats = template - template.mean(1, keepdim=True)
            source_feats = source - source.mean(1, keepdim=True)

        template_gamma = torch.softmax(self.backbone(template_feats), -1)
        source_gamma = torch.softmax(self.backbone(source_feats), -1)
        t_pi, t_mu, t_sigma = gmm_params(template_gamma, template_xyz)
        s_pi, s_mu, s_sigma = gmm_params(source_gamma, source_xyz)
        est_T_inverse = gmm_register(t_pi, t_mu, s_mu, s_sigma)
        est_T = gmm_register(s_pi, s_mu, t_mu, t_sigma)
        return {
            "est_R": est_T[:, :3, :3],
            "est_t": est_T[:, :3, 3],
            "est_R_inverse": est_T_inverse[:, :3, :3],
            "est_t_inverse": est_T_inverse[:, :3, 3],
            "est_T": est_T,
            "est_T_inverse": est_T_inverse,
            "r": template_feats - source_feats,
            "transformed_source": se3.transform(est_T, source_xyz),
        }
