"""SE(3) Lie-group ops, counterpart of ``learning3d_tpu/ops/se3.py``,
batched. Twists xi (..., 6) are ordered (w0, w1, w2, v0, v1, v2), rotation
first (PointNetLK's convention); transforms are homogeneous (..., 4, 4).
Every product is summed elementwise (``so3.matmul3``), so a registration
result does not depend on the TF32 setting."""

from __future__ import annotations

import torch

from learning3d_tpu_torch.ops import so3
from learning3d_tpu_torch.ops.so3 import matmul3, matvec3
from learning3d_tpu_torch.ops.transforms import transform_point_cloud


def from_rt(R, t):
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def to_rt(g):
    return g[..., :3, :3], g[..., :3, 3]


def mat(x):
    """hat: (..., 6) twist -> (..., 4, 4) se(3) matrix."""
    top = torch.cat([so3.mat(x[..., :3]), x[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros(x.shape[:-1] + (1, 4), dtype=x.dtype, device=x.device)], dim=-2)


def vec(X):
    """vee: (..., 4, 4) se(3) matrix -> (..., 6) twist."""
    return torch.cat([so3.vec(X[..., :3, :3]), X[..., :3, 3]], dim=-1)


def exp(x):
    """(..., 6) twist -> (..., 4, 4) rigid transform [[R, V v], [0, 1]], R =
    so3.exp(w), V its left Jacobian."""
    w, v = x[..., :3], x[..., 3:]
    return from_rt(so3.exp(w), matvec3(so3.left_jacobian(w), v))


def log(g):
    """(..., 4, 4) rigid transform -> (..., 6) twist."""
    w = so3.log(g[..., :3, :3])
    return torch.cat([w, matvec3(so3.inv_left_jacobian(w), g[..., :3, 3])], dim=-1)


def inverse(g):
    """Inverse rigid transform: [[R^T, -R^T t], [0, 1]] (the last row is
    g's own)."""
    R = g[..., :3, :3].transpose(-1, -2)
    top = torch.cat([R, -matvec3(R, g[..., :3, 3])[..., :, None]], dim=-1)
    return torch.cat([top, g[..., 3:4, :]], dim=-2)


def transform(g, p):
    """Apply rigid transforms to points. g: (..., 4, 4); p: (..., N, 3), or
    one vector a transform where p has one axis fewer than g. The leading
    axes broadcast: PointNetLK moves (B, 1, N, 3) clouds by (1, 6, 1, 4, 4)
    transforms."""
    R, t = to_rt(g)
    if p.ndim == R.ndim - 1:
        return matvec3(R, p) + t
    return transform_point_cloud(p, R, t)


def compose(a, b):
    """a o b for (..., 4, 4)."""
    return matmul3(a, b)
