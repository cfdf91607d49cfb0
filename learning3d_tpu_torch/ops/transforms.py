"""Rigid-transform utilities, counterpart of
``learning3d_tpu/ops/transforms.py``. Ported so far: what DCP needs."""

from __future__ import annotations


def transform_point_cloud(points, R, t):
    """points (..., N, 3) @ R^T + t, R (..., 3, 3), t (..., 3). Elementwise
    products and sums, so the product is full f32 whatever the TF32
    setting."""
    return (R[..., None, :, :] * points[..., :, None, :]).sum(-1) + t[..., None, :]
