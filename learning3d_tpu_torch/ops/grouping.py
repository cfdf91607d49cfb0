"""PPFNet's sample-and-group operators, counterpart of
``learning3d_tpu/ops/grouping.py``. Ported so far: the self-excluding ball
query and ``sample_and_group_multi`` (PPFNet's {xyz, dxyz, ppf} features);
the FPS/kNN grouping of PointConv and the pointnet2 modules follows with
those models (ROADMAP).

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
"""

from __future__ import annotations

import numpy as np
import torch

from learning3d_tpu_torch.kernels import sampling as _sampling
from learning3d_tpu_torch.ops.geometry import angle, farthest_point_sample, index_points, square_distance


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
