"""Exact kNN over xyz and the neighbor gather of DGCNN's edge features, K7,
counterpart of ``learning3d_tpu/kernels/edgeconv.py::knn_neighbors_pallas``:
one launch of the neighbor selection that K5 and K9 share
(``csrc/dgcnn_select.cu``), whose epilogue writes the edge features.

For each point of a cloud x (B, N, 3), its k nearest points of the same
cloud, itself included, nearest first, ties to the smaller index, over
exact f32 squared distances ``(d0*d0 + d1*d1) + d2*d2`` of per-coordinate
differences (no FMA). The kernel and its plain version copy the picked
coordinates, so both are exact; the TPU kernel gathers them by a one-hot
product through a bf16 hi/lo split.

``get_graph_feature_fused`` is DGCNN's entry: the (B, N, k, 6) edge
features concat(neighbor xyz, center xyz), which the kernel writes whole.
Inputs of another width go to ``ops.geometry.get_graph_feature``, as in
the JAX package.
"""

from __future__ import annotations

import torch

from learning3d_tpu_torch.kernels import LAUNCHES
from learning3d_tpu_torch.kernels import _build
from learning3d_tpu_torch.kernels.dgcnn_fused import exact_knn
from learning3d_tpu_torch.ops.geometry import get_graph_feature, index_points

MAX_K = 64
MAX_N = 16384  # the cloud's xyz and the survivor buffers fill one block's shared memory


def kernel_limit(n_pts, k):
    """The limit of K7 that (N, k) breaks, as a message, or None where the
    kernel takes the shape: 1 <= k <= MAX_K and k <= N <= MAX_N."""
    if not 1 <= k <= MAX_K:
        return f"K7 (knn_neighbors) takes 1 <= k <= {MAX_K}, got k={k}"
    if not k <= n_pts <= MAX_N:
        return f"K7 (knn_neighbors) takes k <= N <= {MAX_N}, got N={n_pts}, k={k}"
    return None


def knn_neighbors_reference(x, k):
    """The kernel's plain version: x (B, N, 3) -> the neighbors' xyz
    (B, N, k, 3) f32, selected by a stable sort of the exact distances."""
    x = x.float()
    return index_points(x, exact_knn(x, k))


def edge_features_reference(x, k):
    """(B, N, k, 6) = concat(``knn_neighbors_reference``, center xyz)."""
    nbr = knn_neighbors_reference(x, k)
    return torch.cat([nbr, x.float()[:, :, None, :].expand(nbr.shape)], dim=-1)


def edge_features(x, k):
    """x (B, N, 3) -> (B, N, k, 6) = concat(neighbor xyz, center xyz) f32.
    A CUDA tensor runs the kernel, which writes it whole in one launch (past
    its limit it raises NotImplementedError); a CPU tensor runs the plain
    version."""
    if x.device.type == "cpu":
        return edge_features_reference(x, k)
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, N, 3), got {tuple(x.shape)}")
    limit = kernel_limit(x.shape[1], k)
    if limit is not None:
        raise NotImplementedError(limit)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    x = x.float().contiguous()
    B, N, _ = x.shape
    out = torch.empty((B, N, k, 6), device=x.device, dtype=torch.float32)
    if B == 0:
        return out
    _build.launch("knn_neighbors", x.device, x.data_ptr(), out.data_ptr(), B, N, k)
    LAUNCHES["knn_neighbors_pallas"] += 1
    return out


def knn_neighbors_pallas(x, k):
    """x (B, N, 3) -> neighbor xyz (B, N, k, 3) f32, nearest first: the
    first three channels of ``edge_features`` (one launch on a CUDA tensor,
    the plain version on a CPU one)."""
    if x.device.type == "cpu":
        return knn_neighbors_reference(x, k)
    return edge_features(x, k)[..., :3]


def get_graph_feature_fused(x, k=20):
    """DGCNN edge features (B, N, k, 2C) = concat(neighbor, center): K7 for
    3-channel clouds, ``ops.geometry.get_graph_feature`` otherwise."""
    if x.shape[-1] != 3:
        return get_graph_feature(x, k=k)
    return edge_features(x, k)
