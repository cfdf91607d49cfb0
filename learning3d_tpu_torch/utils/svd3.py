"""Batched 3x3 special-orthogonal Procrustes (Kabsch) solver, counterpart
of ``learning3d_tpu/utils/svd3.py``:

1. eigendecompose A = H^T H with a fixed-sweep cyclic Jacobi (6 sweeps of
   3 Givens rotations, branch-free);
2. build proper right and left singular bases with cross-product third
   columns (V and U both det +1 by construction);
3. R = V U^T is then the Kabsch optimum V diag(1, 1, det) U^T, reflections
   handled without a sign branch.

Plain torch ops on (B, 3, 3) stacks in f32. Every 3x3 product is written as
elementwise products and sums (``_mm``), so it runs in full f32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says: TF32 rounding would cost
about 1e-3 of orthonormality per sweep, visible in det(R).
"""

from __future__ import annotations

import torch

_JACOBI_SWEEPS = 6


def _mm(a, b):
    """(..., i, j) @ (..., j, k) in full f32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a, v):
    """(..., i, j) @ (..., j) in full f32."""
    return (a * v[..., None, :]).sum(-1)


def _jacobi_rotation(A, V, p, q):
    """One (p, q) Givens rotation annihilating A[p, q], batched (..., 3, 3)."""
    apq, app, aqq = A[..., p, q], A[..., p, p], A[..., q, q]
    # theta = 0.5 * atan2(2 apq, aqq - app) zeroes A[p, q]. A degenerate
    # pair (equal diagonal, zero off-diagonal) is pinned to (y, x) = (0, 1):
    # the same theta (0), and a finite gradient.
    y = 2.0 * apq
    x = aqq - app
    degen = (y * y + x * x) < 1e-18
    y = torch.where(degen, torch.zeros_like(y), y)
    x = torch.where(degen, torch.ones_like(x), x)
    theta = 0.5 * torch.atan2(y, x)
    c, s = torch.cos(theta), torch.sin(theta)
    G = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    G[..., p, p] = c
    G[..., q, q] = c
    G[..., p, q] = s
    G[..., q, p] = -s
    return _mm(_mm(G.transpose(-1, -2), A), G), _mm(V, G)


def eigh3x3(A, sweeps=_JACOBI_SWEEPS):
    """Symmetric (..., 3, 3) -> (eigenvalues descending (..., 3),
    eigenvectors as columns (..., 3, 3)), fixed-trip Jacobi."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rotation(A, V, p, q)
    lam = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(-lam, dim=-1, stable=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return lam, V


def _normalize(v, eps=1e-12):
    # rsqrt(|v|^2 + eps^2): 1/|v| for |v| >> eps, finite gradient at v = 0
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(n2 + eps * eps)


def kabsch_rotation_3x3(H):
    """The proper rotation R maximizing tr(R H) for (..., 3, 3) H: the
    Kabsch solution R = V diag(1, 1, det(V U^T)) U^T for H = U S V^T,
    without a general SVD. H = sum_n src_c[n] corr_c[n]^T (source index on
    rows) gives the rotation mapping src -> corr."""
    H = H.float()
    A = _mm(H.transpose(-1, -2), H)  # H^T H, PSD
    _, V = eigh3x3(A)
    v1, v2 = V[..., :, 0], V[..., :, 1]
    v3 = torch.linalg.cross(v1, v2)  # proper right basis
    U0 = _mv(H, v1)
    u1 = _normalize(U0)
    U1 = _mv(H, v2)
    u2 = _normalize(U1 - torch.sum(u1 * U1, -1, keepdim=True) * u1)
    # Degenerate guards: sigma_1 ~ 0 (H ~ 0) or sigma_2 ~ 0 (rank 1) leave
    # the frame arbitrary; these fallbacks keep it orthonormal.
    bad1 = torch.linalg.vector_norm(U0, dim=-1, keepdim=True) < 1e-9
    u1 = torch.where(bad1, torch.tensor([1.0, 0.0, 0.0], dtype=H.dtype, device=H.device), u1)
    resid = U1 - torch.sum(u1 * U1, -1, keepdim=True) * u1
    bad2 = torch.linalg.vector_norm(resid, dim=-1, keepdim=True) < 1e-9
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=H.dtype, device=H.device).expand(u1.shape)
    alt = _normalize(torch.linalg.cross(u1, e2) + 1e-6)
    u2 = torch.where(bad2, alt, u2)
    u3 = torch.linalg.cross(u1, u2)  # proper left basis
    Vp = torch.stack([v1, v2, v3], dim=-1)
    Up = torch.stack([u1, u2, u3], dim=-1)
    return _mm(Vp, Up.transpose(-1, -2))
