"""Sample-and-group operators, counterpart of
``learning3d_tpu/ops/grouping.py``: PPFNet's self-excluding ball query and
``sample_and_group_multi`` (its {xyz, dxyz, ppf} features), pointnet2's
FPS + ball-query grouping (``sample_and_group``, ``sample_and_group_all``)
and PointConv's FPS + kNN grouping (``sample_and_group_knn``) with its
Gaussian-KDE density (``compute_density``).

On the card ``sample_and_group_multi`` groups through K16
(``kernels.sampling.ball_group_pallas``: the ball query and the gather of
the coordinates and normals in one launch) at every nsample, where the JAX
package's TPU gate ``(nsample * 6) % 128 == 0`` is a limit of its kernel's
lanes. On a CPU tensor it takes the JAX package's CPU path:
``query_ball_point_excluding_self`` by the matmul expansion
(``ops.geometry.square_distance``, JAX's CPU rounding) and two
``index_points``. The two in-ball tests differ on points that lie on the
radius (exact differences against the expansion), as K15's and the CPU ball
query do; each path is held to its own JAX twin. The grouped values carry no
gradient on the card (the operands are geometry from the data, as in the
JAX package's kernel path).

The other groupings select through ``ops.geometry``: FPS on K14, the ball
query on K15 and the kNN on K8 (inside its gate, N >= 512) on the card, the
JAX package's CPU paths on a CPU tensor. FPS runs whenever ``npoint > 0``,
also at ``npoint >= N``, where its picks repeat the first point once every
point is taken (the JAX scan's order, which K14 and its plain version keep).
The selections carry no gradient; the gathered coordinates and features do.
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch.kernels import sampling as _sampling
from learning3d_tpu_torch.ops.geometry import (angle, farthest_point_sample, index_points, knn_point, query_ball_point,
                                               square_distance)


def query_ball_point_excluding_self(radius, nsample, xyz, new_xyz, itself_indices):
    """PPFNet's ball query, the JAX package's CPU path: (B, S, nsample)
    int64, the nsample smallest indices of the points of xyz within
    ``radius`` of each query by the matmul expansion (``> radius * radius``
    is out), the query's own index ``itself_indices`` (B, S) left out, short
    rows padded with that index."""
    B, N, _ = xyz.shape
    sqrdists = square_distance(new_xyz.detach(), xyz.detach())  # (B, S, N)
    r2 = torch.tensor(np.float32(float(radius) * float(radius)), device=xyz.device)
    cols = torch.arange(N, device=xyz.device)
    itself = itself_indices.long()[..., None]
    group_idx = torch.where((sqrdists > r2) | (cols == itself), N, cols)
    k = min(nsample, N)
    group_sorted = torch.topk(group_idx, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        group_sorted = torch.cat([group_sorted, group_sorted.new_full(group_sorted.shape[:-1] + (nsample - k,), N)],
                                 dim=-1)
    return torch.where(group_sorted == N, itself, group_sorted)


def _fps_or_all(xyz, npoint, generator=None):
    """(centers (B, S, 3), their indices (B, S)): FPS picks ``npoint`` of
    them whenever ``npoint > 0`` (at ``npoint >= N`` too), else every point
    is a center."""
    B, N, _ = xyz.shape
    if npoint > 0:
        fps_idx = farthest_point_sample(xyz, npoint, generator=generator)
        return index_points(xyz, fps_idx), fps_idx
    return xyz, torch.arange(N, device=xyz.device).expand(B, N)


def sample_and_group(npoint, radius, nsample, xyz, points=None, returnfps=False, generator=None):
    """FPS + ball query + center-relative grouping: (new_xyz (B, S, 3),
    new_points (B, S, nsample, 3 + D)), the offsets of each center's ball
    and the features ``points`` (B, N, D) of its members; with
    ``returnfps`` also the grouped coordinates and the centers' indices.
    ``npoint <= 0`` keeps every point as a center."""
    new_xyz, fps_idx = _fps_or_all(xyz, npoint, generator)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)  # (B, S, nsample, 3)
    grouped_norm = grouped_xyz - new_xyz[:, :, None, :]
    new_points = grouped_norm if points is None else torch.cat([grouped_norm, index_points(points, idx)], dim=-1)
    if returnfps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz, points=None):
    """One group holding every point (pointnet2's GroupAll): (zeros (B, 1,
    3), (B, 1, N, 3 + D))."""
    B, _, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped_xyz = xyz[:, None, :, :]
    new_points = grouped_xyz if points is None else torch.cat([grouped_xyz, points[:, None, :, :]], dim=-1)
    return new_xyz, new_points


def sample_and_group_knn(npoint, nsample, xyz, points=None, density_scale=None, generator=None):
    """PointConv's grouping: FPS centers and their ``nsample`` nearest
    points -> (new_xyz (B, S, 3), new_points (B, S, nsample, 3 + D),
    grouped_norm (B, S, nsample, 3)[, grouped_density (B, S, nsample, 1)]),
    the last where ``density_scale`` (B, N) is given."""
    new_xyz, _ = _fps_or_all(xyz, npoint, generator)
    _, idx = knn_point(nsample, xyz, new_xyz)
    grouped_norm = index_points(xyz, idx) - new_xyz[:, :, None, :]
    new_points = grouped_norm if points is None else torch.cat([grouped_norm, index_points(points, idx)], dim=-1)
    if density_scale is None:
        return new_xyz, new_points, grouped_norm
    return new_xyz, new_points, grouped_norm, index_points(density_scale[..., None], idx)


def compute_density(xyz, bandwidth):
    """Gaussian-KDE density of each point (B, N, 3) -> (B, N): the mean over
    the cloud of exp(-|p - q|^2 / (2 bw^2)) / (2.5 bw), in the JAX package's
    order (divide, exp, scale, mean) with the squared distances of
    ``square_distance``; the two constants are the Python floats rounded
    once to f32, as JAX hands them to the arithmetic. It holds the (B, N,
    N) matrix: 128 MiB at B=32, N=1024."""
    sqrdists = square_distance(xyz, xyz)
    g = torch.exp(-sqrdists / float(np.float32(2.0 * bandwidth * bandwidth))) / float(np.float32(2.5 * bandwidth))
    return torch.mean(g, dim=-1)


def sample_and_group_multi(npoint, radius, nsample, xyz, normals, generator=None):
    """PPFNet grouping: {"xyz": centers (B, S, 3), "dxyz": neighbour offsets
    (B, S, nsample, 3), "ppf": (B, S, nsample, 4)}, ppf = (angle(n_r, d),
    angle(n_i, d), angle(n_r, n_i), |d|) for each neighbour i of center r.
    ``npoint <= 0`` keeps every point as a center (PPFNet's call), otherwise
    FPS picks them (``generator`` draws the starts, as in
    ``farthest_point_sample``). K16 on the card, the CPU path on a CPU
    tensor (module docstring)."""
    B, N, _ = xyz.shape
    if npoint > 0:
        fps_idx = farthest_point_sample(xyz, npoint, generator=generator)
        new_xyz = index_points(xyz, fps_idx)
        nr = index_points(normals, fps_idx)[:, :, None, :]
    else:
        fps_idx = torch.arange(N, device=xyz.device).expand(B, N)
        new_xyz = xyz
        nr = normals[:, :, None, :]
    if xyz.device.type == "cuda":
        vals = torch.cat([xyz, normals], dim=-1)  # (B, N, 6)
        g = _sampling.ball_group_pallas(radius, nsample, xyz.detach(), new_xyz.detach(), fps_idx, vals.detach())
        grouped_xyz, ni = g[..., :3], g[..., 3:]
    else:
        idx = query_ball_point_excluding_self(radius, nsample, xyz, new_xyz, fps_idx)
        grouped_xyz = index_points(xyz, idx)
        ni = index_points(normals, idx)
    d = grouped_xyz - new_xyz[:, :, None, :]  # (B, S, nsample, 3)
    nr_d = angle(nr, d)
    ni_d = angle(ni, d)
    nr_ni = angle(nr, ni)
    d_norm = torch.linalg.vector_norm(d, dim=-1)
    ppf = torch.stack([nr_d, ni_d, nr_ni, d_norm], dim=-1)
    return {"xyz": new_xyz, "dxyz": d, "ppf": ppf}
