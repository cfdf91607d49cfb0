"""Quaternions, counterpart of ``learning3d_tpu/ops/quaternion.py``.
Ported so far: what iPCRNet needs (``qnormalize``, ``quat2mat``); the rest
follows with ROADMAP Queue 1 item 5. Quaternions are (w, x, y, z)."""

from __future__ import annotations

import torch


def qnormalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat2mat(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))
