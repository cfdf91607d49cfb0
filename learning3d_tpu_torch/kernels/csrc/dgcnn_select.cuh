// The neighbor selection that K5 (dgcnn_fused.cu) and K9 (dgcnn_int8.cu)
// launch before their chains: one source, compiled once
// (dgcnn_select.cu), called from the two C entries on the host. K7's C
// entry (knn_neighbors) lives in the same source.

#pragma once

// The k nearest neighbors of every point of x (B, N, 3) f32 into idx (B, N,
// k) int32: exact (knn_scale null: keys of the f32 squared distances
// (d0*d0 + d1*d1) + d2*d2, ties to the smaller index) or approximate (the
// per-tile key scales of dgcnn_knn_scale at tile_n). Needs 1 <= k <= 64 and
// k <= N <= 16384 (not checked: the callers' entries check their own,
// narrower limits). One launch
// on the stream; returns the CUDA error code (0 on success).
extern "C" int dgcnn_select(const float* x, const float* knn_scale, int* idx, int batch, int n_pts, int k,
                            int tile_n, void* stream);
