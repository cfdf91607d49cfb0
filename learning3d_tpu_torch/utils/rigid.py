"""Sinkhorn normalisation and (weighted) Kabsch rigid solvers, counterpart
of ``learning3d_tpu/utils/rigid.py`` (RPMNet's helpers): the fixed-count
log-domain Sinkhorn, with or without RPMNet's slack row and column, and
the batched weighted Kabsch solver on ``utils/svd3.kabsch_rotation_3x3``
(proper rotations, reflections resolved by construction). (B, 3, 4)
transforms [R | t] throughout.

The slack Sinkhorn goes through K17 (``kernels.sinkhorn``) on the card at
every shape, where the JAX package sends to its TPU kernel only a matrix
that fits VMEM; a CPU tensor takes the plain version, the JAX package's XLA
oracle in torch. The no-slack form has no kernel in either package. Every
small product (3x3, 3x4, the (B, M, 3) centroids and covariances) is
written as elementwise products and sums, so that no TF32 setting reaches
it.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import sinkhorn as _sinkhorn
from learning3d_tpu_torch.utils.svd3 import kabsch_rotation_3x3

_EPS = 1e-5


def sinkhorn_log(log_alpha, n_iters: int = 5, slack: bool = True):
    """Log-domain Sinkhorn: (B, J, K) -> the log of a near-doubly-stochastic
    (B, J, K) matrix. With ``slack`` a zero extra row and column absorb the
    unmatched mass and are left out of their own normalisation (RPMNet)."""
    if slack:
        return _sinkhorn.sinkhorn_log_pallas(log_alpha, n_iters)
    la = log_alpha
    for _ in range(n_iters):
        la = la - torch.logsumexp(la, dim=2, keepdim=True)
        la = la - torch.logsumexp(la, dim=1, keepdim=True)
    return la


def weighted_kabsch(a, b, weights):
    """The rigid transform (B, 3, 4) that maps a onto b: a, b (B, M, 3)
    row-paired, weights (B, M) >= 0 (normalised to sum 1 + eps)."""
    w = weights[..., None] / (torch.sum(weights[..., None], dim=1, keepdim=True) + _EPS)
    centroid_a = torch.sum(a * w, dim=1)
    centroid_b = torch.sum(b * w, dim=1)
    a_c = a - centroid_a[:, None, :]
    b_c = b - centroid_b[:, None, :]
    cov = torch.sum(a_c[..., :, None] * (b_c * w)[..., None, :], dim=1).float()  # (B, 3, 3)
    rot = kabsch_rotation_3x3(cov).to(a.dtype)
    t = centroid_b - torch.sum(rot * centroid_a[:, None, :], dim=-1)
    return torch.cat([rot, t[..., None]], dim=-1)


def kabsch(a, b):
    """Unweighted rigid a -> b (row-paired)."""
    return weighted_kabsch(a, b, torch.ones(a.shape[:2], dtype=a.dtype, device=a.device))


def rotate(R, points):
    """(B, 3, 3) rotations applied to (B, N, 3) points: R p for every p."""
    return torch.sum(R[:, None, :, :] * points[:, :, None, :], dim=-1)


def se3_transform_34(T, points):
    """A (B, 3, 4) transform applied to (B, N, 3) points."""
    return rotate(T[:, :, :3], points) + T[:, None, :, 3]


def concat_se3_34(T_new, T_old):
    """Composition of (B, 3, 4) transforms: T_new after T_old."""
    R_new = T_new[:, :, :3]
    R = torch.sum(R_new[..., :, :, None] * T_old[:, None, :, :3], dim=-2)
    t = torch.sum(R_new * T_old[:, None, :, 3], dim=-1) + T_new[:, :, 3]
    return torch.cat([R, t[..., None]], dim=-1)
