"""SO(3) Lie-group ops, counterpart of ``learning3d_tpu/ops/so3.py``,
batched over any leading axes. Rotation vectors w (..., 3) are axis *
angle; matrices R (..., 3, 3).

The exponential and the Jacobians are written in s = |w|^2 (``ops.sinc``'s
squared forms), so every autodiff order is finite at the identity; the log
goes through the branchless quaternion extraction, which holds near pi.
Every 3x3 product is summed elementwise (``matmul3``), so that a result
does not depend on the TF32 setting of the card's matrix products.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.ops import quaternion as quat
from learning3d_tpu_torch.ops.sinc import sinc1_sq, sinc2_sq, sinc3_sq


def matmul3(a, b):
    """a @ b for (..., n, k) x (..., k, m) small matrices, broadcast over the
    leading axes, as elementwise products and a sum (full f32 whatever the
    TF32 setting)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec3(a, v):
    """a @ v for (..., n, k) x (..., k), elementwise."""
    return (a * v[..., None, :]).sum(-1)


def mat(w):
    """hat: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    W = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return W.reshape(w.shape[:-1] + (3, 3))


def vec(W):
    """vee: (..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def genvec(dtype=torch.float32):
    """The 3 generator vectors e_i: the (3, 3) identity."""
    return torch.eye(3, dtype=dtype)


def genmat(dtype=torch.float32):
    """The 3 so(3) generator matrices (3, 3, 3)."""
    return mat(genvec(dtype))


def _series(w, c1, c2):
    """I + c1 W + c2 W^2 with c1, c2 functions of s = |w|^2."""
    s = torch.sum(w * w, dim=-1)
    W = mat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + c1(s)[..., None, None] * W + c2(s)[..., None, None] * matmul3(W, W)


def exp(w):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix,
    R = I + sinc1(t) W + sinc2(t) W^2."""
    return _series(w, sinc1_sq, sinc2_sq)


def log(R):
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector, |w| in
    [0, pi], through the quaternion."""
    return quat.quat_to_axis_angle(quat.mat2quat(R))


def transform(R, p):
    """Apply rotations to points. R: (..., 3, 3); p: (..., N, 3), or (...,
    3) with one vector a rotation (when p has one axis fewer than R)."""
    if p.ndim == R.ndim - 1:
        return matvec3(R, p)
    return matvec3(R[..., None, :, :], p)


def btrace(M):
    """Batched trace."""
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def inverse(R):
    return R.transpose(-1, -2)


def left_jacobian(w):
    """J_l(w), the V matrix of the SE(3) exponential: I + sinc2(t) W +
    sinc3(t) W^2."""
    return _series(w, sinc2_sq, sinc3_sq)


def _inv_left_c(s):
    """c(s) = (1 - sinc1 / (2 sinc2)) / s, whose numerator is O(s): its
    Taylor series 1/12 + s/720 + ... below s = 1, the closed form (on a safe
    s, the double ``where``) above."""
    s_safe = torch.where(s < 1.0, torch.ones_like(s), s)
    c_exact = (1.0 - sinc1_sq(s_safe) / (2.0 * sinc2_sq(s_safe))) / s_safe
    c_taylor = 1.0 / 12.0 + s / 720.0 + s * s / 30240.0 + s * s * s / 1209600.0
    return torch.where(s < 1.0, c_taylor, c_exact)


def inv_left_jacobian(w):
    """J_l(w)^-1 = I - W/2 + c(t) W^2."""
    return _series(w, lambda s: torch.full_like(s, -0.5), _inv_left_c)
