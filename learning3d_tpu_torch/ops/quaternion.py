"""Quaternion algebra, counterpart of ``learning3d_tpu/ops/quaternion.py``.
Quaternions are (w, x, y, z), batched over the leading axes: the Hamilton
product, inverse and rotation, the matrix conversions both ways (the
branchless Shepperd extraction), rotation vectors, Euler angles in all six
orders, sign continuity of a sequence, and numpy twins of these."""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch.ops.sinc import sinc1_sq


def qmul(q, r):
    """Hamilton product q*r. q, r: (..., 4) in (w,x,y,z)."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qinv(q):
    """Inverse of a unit quaternion = conjugate. (..., 4)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qrot(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), in the
    expanded cross-product form (no matmul): v' = v + 2 w (u x v) + 2 u x
    (u x v)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


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


def _sign_w(q):
    """q with its sign chosen so that w >= 0."""
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def mat2quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branchless Shepperd method: all four candidate quaternions (each
    accurate in its own region) are computed, and the largest of (trace,
    R00, R11, R22) picks one by nested ``where``s, so that angles near pi
    are as accurate as small ones. ``safe_sqrt`` keeps the candidates that
    are not picked finite (and their gradients with them)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    sw = safe_sqrt(1.0 + tr) * 2.0  # 4w
    qw_a = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0  # 4x
    qx_a = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0  # 4y
    qy_a = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0  # 4z
    qz_a = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1)

    cond_tr = (tr > m00) & (tr > m11) & (tr > m22)
    cond_x = (m00 >= m11) & (m00 >= m22)
    cond_y = m11 >= m22
    q = torch.where(cond_tr[..., None], qw_a,
                    torch.where(cond_x[..., None], qx_a, torch.where(cond_y[..., None], qy_a, qz_a)))
    return qnormalize(_sign_w(q))


def axis_angle_to_quat(w):
    """Rotation vector (..., 3) -> unit quaternion, from s = |w|^2 so that
    every autodiff order is finite at w = 0."""
    s = torch.sum(w * w, dim=-1, keepdim=True)  # t^2
    s_safe = torch.where(s < 0.01, torch.ones_like(s), s)
    cos_taylor = 1.0 - s / 8.0 * (1.0 - s / 48.0 * (1.0 - s / 120.0))  # cos(t/2)
    qw = torch.where(s < 0.01, cos_taylor, torch.cos(0.5 * torch.sqrt(s_safe)))
    qv = 0.5 * sinc1_sq(0.25 * s) * w  # sin(t/2) u = (t/2) sinc1(t/2) u
    return torch.cat([qw, qv], dim=-1)


def quat_to_axis_angle(q):
    """Unit quaternion -> rotation vector (..., 3), |w| in [0, pi]: 2 v g(s)
    with s = |v|^2 and g(s) = atan2(sqrt(s), qw) / sqrt(s) on the w >= 0
    sign, a Taylor branch below s = 0.01 keeping the gradients finite at the
    identity."""
    q = _sign_w(q)
    qw = q[..., :1]
    v = q[..., 1:]
    s = torch.sum(v * v, dim=-1, keepdim=True)
    s_safe = torch.where(s < 0.01, torch.ones_like(s), s)
    r = torch.sqrt(s_safe)
    g_exact = torch.atan2(r, qw) / r
    g_taylor = 1.0 + s / 6.0 + 3.0 * s * s / 40.0 + 15.0 * s * s * s / 336.0
    g = torch.where(s < 0.01, g_taylor, g_exact)
    return 2.0 * v * g


_AXIS = {"x": 0, "y": 1, "z": 2}


def euler_to_quat(e, order="zyx"):
    """Intrinsic Euler angles (..., 3) in the given axis order -> quaternion.
    Positional convention (scipy's): e[..., i] is the angle of the i-th
    rotation in ``order``. For the axis-name convention of the reference's
    quaternion module, use :func:`euler_to_quaternion`."""
    q = None
    for i, ax in enumerate(order):
        half = 0.5 * e[..., i : i + 1]
        axis = torch.zeros(3, dtype=e.dtype, device=e.device)
        axis[_AXIS[ax]] = 1.0
        qi = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
        q = qi if q is None else qmul(q, qi)
    return q


def euler_to_quaternion(e, order="zyx"):
    """The reference's euler -> quaternion (transform_functions.py:62-106):
    e[..., 0]/[1]/[2] are always the x/y/z angles, composed intrinsically
    in ``order``; the even permutations (xyz, yzx, zxy) come back negated,
    as the reference returns them."""
    perm = [_AXIS[c] for c in order]
    q = euler_to_quat(e[..., perm], order)
    if order in ("xyz", "yzx", "zxy"):
        q = -q
    return q


def qeuler(q, order="zyx", epsilon=0.0):
    """Unit quaternion -> intrinsic Tait-Bryan angles, stacked as (x, y, z)
    angles whatever ``order`` (R = R_o0 R_o1 R_o2); ``epsilon`` narrows the
    asin clamp. For R = R_i(a) R_j(b) R_k(c) with permutation sign s (+1
    for xyz/yzx/zxy): b = asin(s m[i,k]), a = atan2(-s m[j,k], m[k,k]), c =
    atan2(-s m[i,j], m[i,i])."""
    if sorted(order) != ["x", "y", "z"]:
        raise ValueError(f"unsupported euler order {order!r}")
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    m = [
        [1 - 2 * (yy + zz), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (xx + zz), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (xx + yy)],
    ]
    i, j, k = (_AXIS[c] for c in order)
    s = 1.0 if (j - i) % 3 == 1 else -1.0
    beta = torch.asin(torch.clamp(s * m[i][k], -1 + epsilon, 1 - epsilon))
    alpha = torch.atan2(-s * m[j][k], m[k][k])
    gamma = torch.atan2(-s * m[i][j], m[i][i])
    out = [None, None, None]
    out[i], out[j], out[k] = alpha, beta, gamma
    return torch.stack(out, dim=-1)


def qfix(q):
    """Sign continuity along axis 0 of a quaternion sequence: each
    quaternion is flipped where its dot product with the previous (already
    fixed) one would be negative."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)
    flips = torch.cumprod(torch.where(dots < 0, -1.0, 1.0).to(q.dtype), dim=0)
    signs = torch.cat([torch.ones_like(flips[:1]), flips], dim=0)
    return q * signs[..., None]


# -- numpy twins: numpy in, numpy out, computed on the CPU ----------------


def _np(fn, *args, **kw):
    args = [torch.from_numpy(np.asarray(a)) for a in args]
    return fn(*args, **kw).numpy()


def qmul_np(q, r):
    return _np(qmul, q, r)


def qrot_np(q, v):
    return _np(qrot, q, v)


def qeuler_np(q, order="zyx", epsilon=0.0, use_gpu=False):  # use_gpu kept for the reference's signature
    return _np(qeuler, q, order=order, epsilon=epsilon)


def qfix_np(q):
    return _np(qfix, q)


def expmap_to_quaternion_np(e):
    return _np(axis_angle_to_quat, e)
