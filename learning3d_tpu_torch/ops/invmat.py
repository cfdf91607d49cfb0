"""Batched matrix inverse and pseudo-inverse, counterpart of
``learning3d_tpu/ops/invmat.py``: thin wrappers over ``torch.linalg``,
which batches and differentiates these natively."""

from __future__ import annotations

import torch


def batch_inverse(x):
    """(..., N, N) -> (..., N, N), batched, differentiable."""
    return torch.linalg.inv(x)


def batch_pinv(x, rcond=1e-6):
    """Moore-Penrose pseudo-inverse, batched, differentiable; singular
    values below ``rcond`` times the largest count as 0."""
    return torch.linalg.pinv(x, rtol=rcond)


def pinv_via_normal_eqs(J, eps=0.0):
    """(J^T J)^-1 J^T for (..., M, K) with M >= K, the construction
    PointNetLK uses; ``eps`` adds Tikhonov damping eps * I to J^T J. J^T J
    is summed elementwise (no TF32), and the solve is ``solve_ex``, whose
    check of a singular matrix does not wait for the card."""
    JtJ = (J[..., :, :, None] * J[..., :, None, :]).sum(-3)  # sum_m J[m, k] J[m, l]
    if eps:
        JtJ = JtJ + eps * torch.eye(JtJ.shape[-1], dtype=J.dtype, device=J.device)
    return torch.linalg.solve_ex(JtJ, J.transpose(-1, -2))[0]
