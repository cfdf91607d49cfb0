"""Farthest-point sampling (K14), ball query (K15) and the self-excluding
ball grouping (K16): three CUDA kernels (``csrc/fps.cu``,
``csrc/ball_query.cu``, ``csrc/ball_group.cu``), counterparts of
``learning3d_tpu/kernels/sampling.py::fps_pallas``, ``::ball_query_pallas``
and ``::ball_group_pallas``.

``fps_pallas(xyz, npoint, start=None)``: xyz (B, N, 3) -> idx (B, npoint)
int32. The first pick is ``start`` (point 0 for None), each next one the
argmax of the running min-distance to the picks so far, the first of equal
maxima; the distance starts at 1e10 and is ``((x-cx)^2 + (y-cy)^2) +
(z-cz)^2``, every operation rounded in f32. Once every point is picked the
distances are all 0 and the picks repeat the first such index. Any N and
npoint: the TPU kernel's npoint <= 1024 is a limit of its VMEM that the
CUDA kernel does not share. ``start`` must lie in [0, N).

``ball_query_pallas(radius, nsample, xyz, new_xyz, dtype=torch.int32)``:
xyz (B, N, 3), new_xyz (B, S, 3) -> idx (B, S, nsample) int32 (int64 for
``dtype=torch.int64``, written so by the kernel: ``ops.geometry`` takes its
int64 indices without a conversion pass): the first nsample indices
with ``(d0*d0 + d1*d1) + d2*d2 <= r2`` (exact per-coordinate differences),
ascending, a short row padded with its first index, a row with no point in
the ball N everywhere. ``r2`` is the Python float ``radius ** 2`` rounded
once to f32, as the JAX package hands it to its kernel. Any N, S and
nsample (the TPU kernel's nsample <= 128 is a limit of its VMEM).

``ball_group_pallas(radius, nsample, xyz, new_xyz, itself_idx, values)``:
xyz (B, N, 3), new_xyz (B, S, 3), itself_idx (B, S) int, values (B, N, C)
-> (B, S, nsample, C) f32, PPFNet's grouping: the same in-ball test as the
ball query, with column ``itself_idx[b, s]`` left out; slot j holds the
values of the j-th in-ball column in ascending index order, and the slots
past the count hold the values of column ``itself_idx[b, s]`` (zeros where
that index lies outside [0, N), as the TPU kernel's one-hot gather gives).
The values are gathered exactly: the TPU kernel gathers through a bf16
hi/lo split on its matrix unit, which is off by up to ~2^-17 of a value;
the JAX package's oracle ``index_points`` is exact, and so are this kernel
and its plain version. Any nsample and C: the TPU kernel's ``nsample * C %
128 == 0`` is a limit of its lanes.

A CUDA tensor launches the kernel, or raises NotImplementedError naming the
limit it breaks (``fps_kernel_limit``, ``ball_query_kernel_limit``,
``ball_group_kernel_limit``: the indices and counts are int32); a CPU
tensor runs the plain version (``fps_reference``, ``ball_query_reference``,
``ball_group_reference``), the same arithmetic with torch ops, which the
kernels match index for index (value for value for K16). None of the
kernels has a backward: the indices carry no gradient, K16's operands are
geometry from the data, and the callers detach the operands.
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.kernels.knn import _sq_dist

INT32_MAX = 2**31 - 1
CHUNK_BYTES = 1 << 28  # the ball query's plain version keeps its (b, S, N) intermediates under 256 MiB a chunk


def fps_kernel_limit(n, npoint):
    """The limit of K14 that N or ``npoint`` breaks, as a message, or None:
    both are int32 in the kernel."""
    if not (1 <= n <= INT32_MAX and 1 <= npoint <= INT32_MAX):
        return f"K14 (fps_pallas) takes 1 <= N, npoint <= 2**31 - 1 (int32), got N={n}, npoint={npoint}"
    return None


def ball_query_kernel_limit(n, nsample):
    """The limit of K15 that N or ``nsample`` breaks, as a message, or None:
    both are int32 in the kernel (N is also the index of an empty ball)."""
    if not (1 <= n <= INT32_MAX and 1 <= nsample <= INT32_MAX):
        return f"K15 (ball_query_pallas) takes 1 <= N, nsample <= 2**31 - 1 (int32), got N={n}, nsample={nsample}"
    return None


def ball_group_kernel_limit(n, nsample, c):
    """The limit of K16 that N, ``nsample`` or C breaks, as a message, or
    None: each is int32 in the kernel."""
    if not (1 <= n <= INT32_MAX and 1 <= nsample <= INT32_MAX and 1 <= c <= INT32_MAX):
        return (f"K16 (ball_group_pallas) takes 1 <= N, nsample, C <= 2**31 - 1 (int32), got N={n}, "
                f"nsample={nsample}, C={c}")
    return None


# K16's schedule (``csrc/ball_group.cu``): queries a block (at most), slots
# of a warp's index list, 32-point rounds an iteration of the scan, the
# widest C written float by float (wider: slot by slot), and the
# shared-memory budget of a chunk of the cloud
BALL_GROUP_QUERIES = 32
BALL_GROUP_LIST = 256
BALL_GROUP_ROUNDS = 4
BALL_GROUP_GATHER_C = 32
BALL_GROUP_CLOUD_BYTES = 40960


def ball_group_chunk(n, c):
    """(points, values): how many of a cloud's N points K16 stages in shared
    memory at once, and whether their C values are staged with their
    coordinates (12 bytes a point, and 4 C where 32 points' worth fit the
    budget); the Python statement of ``chunk_of`` in ``csrc/ball_group.cu``."""
    values = 32 * (12 + 4 * c) <= BALL_GROUP_CLOUD_BYTES
    per = 12 + (4 * c if values else 0)
    return min(BALL_GROUP_CLOUD_BYTES // per // 32 * 32, n), values


def ball_group_queries(batch, s, sms=132):
    """The queries a K16 block takes: BALL_GROUP_QUERIES, halved down to one
    a warp (8) while batch * ceil(S / queries) blocks would not fill every
    SM's four resident blocks; the Python statement of ``queries_of`` in
    ``csrc/ball_group.cu``."""
    nq = BALL_GROUP_QUERIES
    while nq > 8 and batch * -(-s // nq) < 4 * sms:
        nq //= 2
    return nq


# K15's scan (``csrc/ball_query.cu``): 32-point rounds a warp loads before
# it tests any of them
BALL_QUERY_ROUNDS = 4


def squared_radius(radius) -> np.float32:
    """The Python float ``radius ** 2`` rounded once to f32 (``f32(r) *
    f32(r)`` can differ from it by an ulp)."""
    return np.float32(float(radius) ** 2)


def _start(xyz, start):
    """(B,) int32 starts on xyz's device: zeros for None, else ``start``
    checked to lie in [0, N) (on the card one min/max, read back)."""
    B, N = xyz.shape[0], xyz.shape[1]
    if start is None:
        return torch.zeros(B, dtype=torch.int32, device=xyz.device)
    start = torch.as_tensor(start, device=xyz.device).reshape(-1)
    if start.shape[0] != B:
        raise ValueError(f"start must hold one index per batch item ({B}), got {tuple(start.shape)}")
    if B:
        lo, hi = torch.stack(torch.aminmax(start)).tolist()
        if lo < 0 or hi >= N:
            raise ValueError(f"start must lie in [0, {N}), got values in [{lo}, {hi}]")
    return start.to(torch.int32)


def fps_reference(xyz, npoint, start=None):
    """The kernel's plain version, and the JAX package's scan oracle
    (``learning3d_tpu/ops/geometry.py:161-171``): (B, npoint) int32. The
    argmax is the max, then the smallest index holding it."""
    x = xyz.float()
    B, N, _ = x.shape
    cur = _start(x, start).long()
    rows = torch.arange(B, device=x.device)
    cols = torch.arange(N, device=x.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=x.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=x.device)
    for i in range(npoint):
        out[:, i] = cur
        c = x[rows, cur]  # (B, 3)
        d = None
        for k in range(3):
            t = x[..., k] - c[:, k : k + 1]
            t = t * t
            d = t if d is None else d + t
        dist = torch.minimum(dist, d)
        m = dist.amax(-1, keepdim=True)
        cur = torch.where(dist == m, cols, N).amin(-1)
    return out


def ball_query_reference(radius, nsample, xyz, new_xyz, dtype=torch.int32):
    """The kernel's plain version: (B, S, nsample) ``dtype`` (int32 or
    int64) from exact per-coordinate differences, the in-ball indices as keys
    (N outside the ball), the nsample smallest in ascending order, N replaced
    by the row's first key. Batches go in chunks whose (b, S, N)
    intermediates stay under CHUNK_BYTES."""
    p, q = xyz.float(), new_xyz.float()
    B, N, _ = p.shape
    S = q.shape[1]
    r2 = torch.tensor(squared_radius(radius), device=p.device)
    cols = torch.arange(N, dtype=torch.int32, device=p.device)
    k = min(nsample, N)
    step = max(1, CHUNK_BYTES // (4 * max(S, 1) * N))
    outs = []
    for lo in range(0, B, step):
        d = _sq_dist(q[lo : lo + step], p[lo : lo + step])  # K8's C == 3 arithmetic: exact differences
        key = torch.where(d <= r2, cols, N)
        key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        if k < nsample:
            key = torch.cat([key, torch.full(key.shape[:-1] + (nsample - k,), N, dtype=key.dtype, device=key.device)],
                            dim=-1)
        outs.append(torch.where(key == N, key[..., :1], key).to(dtype))
    return torch.cat(outs)


def _check_fps(xyz, npoint):
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if xyz.shape[1] == 0 or npoint < 1:
        raise ValueError(f"fps needs N >= 1 and npoint >= 1, got N={xyz.shape[1]}, npoint={npoint}")


def fps_pallas(xyz, npoint, start=None):
    """xyz (B, N, 3) -> FPS indices (B, npoint) int32 from ``start`` ((B,)
    int in [0, N), point 0 for None; ValueError outside). One kernel launch
    on a CUDA tensor (past ``fps_kernel_limit`` NotImplementedError), the
    plain version on a CPU one."""
    _check_fps(xyz, npoint)
    if xyz.device.type == "cpu":
        return fps_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise ValueError(f"no kernel for device {xyz.device}")
    limit = fps_kernel_limit(xyz.shape[1], npoint)
    if limit is not None:
        raise NotImplementedError(limit)
    x = xyz.detach().float().contiguous()
    B, N, _ = x.shape
    st = None if start is None else _start(x, start).contiguous()  # None: the kernel starts at point 0
    idx = torch.empty((B, npoint), device=x.device, dtype=torch.int32)
    if B == 0:
        return idx
    scratch = torch.empty((B, 4, N), device=x.device, dtype=torch.float32) \
        if _build.library().fps_scratch_needed(N) else None
    _build.launch("fps_sample", x.device, x.data_ptr(), None if st is None else st.data_ptr(), idx.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), B, N, npoint)
    LAUNCHES["fps_pallas"] += 1
    return idx


def _check_ball_query(nsample, xyz, new_xyz):
    if xyz.ndim != 3 or new_xyz.ndim != 3 or xyz.shape[-1] != 3 or new_xyz.shape[-1] != 3 \
            or xyz.shape[0] != new_xyz.shape[0]:
        raise ValueError(f"xyz and new_xyz must be (B, N, 3) and (B, S, 3), got {tuple(xyz.shape)} and "
                         f"{tuple(new_xyz.shape)}")
    if xyz.device != new_xyz.device:
        raise ValueError(f"xyz on {xyz.device}, new_xyz on {new_xyz.device}")
    if xyz.shape[1] == 0 or nsample < 1:
        raise ValueError(f"ball query needs N >= 1 and nsample >= 1, got N={xyz.shape[1]}, nsample={nsample}")


def ball_query_pallas(radius, nsample, xyz, new_xyz, dtype=torch.int32):
    """xyz (B, N, 3), new_xyz (B, S, 3) -> idx (B, S, nsample) ``dtype``
    (int32 or int64). One kernel launch on a CUDA tensor (past
    ``ball_query_kernel_limit`` NotImplementedError), the plain version on a
    CPU one."""
    _check_ball_query(nsample, xyz, new_xyz)
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ball query indices are int32 or int64, got {dtype}")
    if xyz.device.type == "cpu":
        return ball_query_reference(radius, nsample, xyz, new_xyz, dtype)
    if xyz.device.type != "cuda":
        raise ValueError(f"no kernel for device {xyz.device}")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    limit = ball_query_kernel_limit(N, nsample)
    if limit is not None:
        raise NotImplementedError(limit)
    p, q = _f32(xyz), _f32(new_xyz)
    idx = p.new_empty((B, S, nsample), dtype=dtype)
    if B == 0 or S == 0:
        return idx
    _build.launch("ball_query", p.device, p.data_ptr(), q.data_ptr(), idx.data_ptr(), int(dtype == torch.int64), B,
                  N, S, nsample, float(squared_radius(radius)))
    LAUNCHES["ball_query_pallas"] += 1
    return idx


def _f32(t):
    """``t`` as a contiguous f32 tensor, itself where it is one already."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.detach().float().contiguous()


def ball_group_reference(radius, nsample, xyz, new_xyz, itself_idx, values):
    """The kernel's plain version: (B, S, nsample, C) f32. The in-ball
    columns by exact per-coordinate differences, column ``itself_idx`` and
    the rest outside the ball keyed N, the nsample smallest keys in
    ascending order, N replaced by ``itself_idx``; then the values at those
    columns (zeros at a center index outside [0, N)). Batches go in chunks
    whose (b, S, N) intermediates stay under CHUNK_BYTES."""
    p, q, v = xyz.float(), new_xyz.float(), values.float()
    it = itself_idx.long()
    B, N, _ = p.shape
    S, C = q.shape[1], v.shape[-1]
    r2 = torch.tensor(squared_radius(radius), device=p.device)
    cols = torch.arange(N, device=p.device)
    k = min(nsample, N)
    step = max(1, CHUNK_BYTES // (8 * max(S, 1) * N))
    outs = []
    for lo in range(0, B, step):
        d = _sq_dist(q[lo : lo + step], p[lo : lo + step])  # K8's C == 3 arithmetic: exact differences
        center = it[lo : lo + step, :, None]
        key = torch.where((d <= r2) & (cols != center), cols, N)
        key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        if k < nsample:
            key = torch.cat([key, torch.full(key.shape[:-1] + (nsample - k,), N, dtype=key.dtype,
                                             device=key.device)], dim=-1)
        idx = torch.where(key == N, center, key)
        inside = (idx >= 0) & (idx < N)
        flat = torch.where(inside, idx, 0).reshape(idx.shape[0], -1, 1).expand(-1, -1, C)
        g = torch.gather(v[lo : lo + step], 1, flat).reshape(idx.shape + (C,))
        outs.append(torch.where(inside[..., None], g, 0.0))
    return torch.cat(outs)


def _check_ball_group(nsample, xyz, new_xyz, itself_idx, values):
    _check_ball_query(nsample, xyz, new_xyz)
    B, N, S = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    if tuple(itself_idx.shape) != (B, S):
        raise ValueError(f"itself_idx must be (B, S) = {(B, S)}, got {tuple(itself_idx.shape)}")
    if values.ndim != 3 or tuple(values.shape[:2]) != (B, N) or values.shape[-1] == 0:
        raise ValueError(f"values must be (B, N, C) with B, N = {(B, N)} and C >= 1, got {tuple(values.shape)}")
    if itself_idx.dtype.is_floating_point or itself_idx.dtype == torch.bool:
        raise ValueError(f"itself_idx must be an integer tensor, got {itself_idx.dtype}")
    if not (xyz.device == itself_idx.device == values.device):
        raise ValueError(f"xyz on {xyz.device}, itself_idx on {itself_idx.device}, values on {values.device}")


def ball_group_pallas(radius, nsample, xyz, new_xyz, itself_idx, values):
    """xyz (B, N, 3), new_xyz (B, S, 3), itself_idx (B, S), values (B, N, C)
    -> (B, S, nsample, C) f32. One kernel launch on a CUDA tensor (past
    ``ball_group_kernel_limit`` NotImplementedError), the plain version on a
    CPU one. No gradient: the operands are detached."""
    _check_ball_group(nsample, xyz, new_xyz, itself_idx, values)
    if xyz.device.type == "cpu":
        return ball_group_reference(radius, nsample, xyz.detach(), new_xyz.detach(), itself_idx,
                                    values.detach())
    if xyz.device.type != "cuda":
        raise ValueError(f"no kernel for device {xyz.device}")
    limit = ball_group_kernel_limit(xyz.shape[1], nsample, values.shape[-1])
    if limit is not None:
        raise NotImplementedError(limit)
    p, q = xyz.detach().float().contiguous(), new_xyz.detach().float().contiguous()
    v = values.detach().float().contiguous()
    it = itself_idx.detach().to(torch.int32).contiguous()
    B, N, _ = p.shape
    S, C = q.shape[1], v.shape[-1]
    out = torch.empty((B, S, nsample, C), device=p.device, dtype=torch.float32)
    if B == 0 or S == 0:
        return out
    _build.launch("ball_group", p.device, p.data_ptr(), q.data_ptr(), it.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                  N, S, nsample, C, float(squared_radius(radius)))
    LAUNCHES["ball_group_pallas"] += 1
    return out
