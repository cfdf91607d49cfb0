// PPFNet's ball grouping for Hopper (sm_90a). xyz (B, N, 3), new_xyz
// (B, S, 3) and values (B, N, C) f32, itself (B, S) int32 in; out
// (B, S, nsample, C) f32: for each query, slot j holds the values of the
// j-th point within the radius in ascending index order, the point
// itself[b, s] left out; the slots past the count hold the values of point
// itself[b, s] (zeros where that index lies outside [0, N)).
//
// Replaces the TPU kernel learning3d_tpu/kernels/sampling.py::
// ball_group_pallas (body `_ball_group_kernel`). Same math as the port's
// plain version `ball_group_reference`: the in-ball test of K15
// (ball_query.cu), every operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction, which would move a point that
// lies on the radius in or out),
//   d = ((qx - x)^2 + (qy - y)^2) + (qz - z)^2, in the ball where d <= r2,
// r2 the wrapper's f32 rounding of the Python float radius ** 2. The values
// are copied exactly; the TPU kernel gathers them through a bf16 hi/lo split
// on its matrix unit (~2^-17 relative), the JAX package's oracle
// (index_points) exactly.
//
// Bound. The output dominates the bytes: B S nsample C f32 written once
// (25 MB at RPMNet's B=16, S=N=1024, nsample 64, C=6) against the clouds'
// and values' few hundred KB read once, so the bytes bound it; a query reads
// points in index order until it has nsample in the ball, 9 f32 operations a
// point (chip_smoke.py counts the points this run's queries need).
//
// Design. The TPU kernel builds a (tile, N) distance tile in VMEM, ranks the
// in-ball columns with a triangular-matrix product and gathers with nsample
// one-hot products, so that neither the mask nor the ranks reach HBM. Here
// one warp takes one query, as K15 does: it reads the cloud 32 points at a
// time (lane l the point j0 + l), takes a ballot of the in-ball lanes, and
// each in-ball lane copies its point's C values to slot count + (the
// in-ball lanes below it), so the slots come out in ascending order without
// a sort; it stops once nsample are found. The mask and the ranks live in
// registers only. The padding slots are one contiguous run of the output
// row, written by the whole warp. Eight warps (8 queries) a block, any N,
// S, nsample and C; the clouds and values are read through L2 (RPMNet's
// 1024 points with 6 values are 24 KB an item).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps) ball_group_kernel(const float* __restrict__ xyz,
                                                                 const float* __restrict__ new_xyz,
                                                                 const int* __restrict__ itself,
                                                                 const float* __restrict__ values,
                                                                 float* __restrict__ out, long long queries, int n,
                                                                 int s, int nsample, int c, float r2) {
  const long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= queries) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const long long b = q / s;
  const float* p = xyz + b * n * 3;
  const float* v = values + b * n * c;
  const float qx = new_xyz[3 * q], qy = new_xyz[3 * q + 1], qz = new_xyz[3 * q + 2];
  const int self = itself[q];
  float* o = out + q * nsample * c;
  const unsigned below = (1u << lane) - 1u;

  int found = 0;
  for (int j0 = 0; j0 < n && found < nsample; j0 += 32) {
    const int j = j0 + lane;
    bool in = false;
    if (j < n && j != self) {
      const float d0 = __fsub_rn(qx, __ldg(p + 3 * (size_t)j));
      const float d1 = __fsub_rn(qy, __ldg(p + 3 * (size_t)j + 1));
      const float d2 = __fsub_rn(qz, __ldg(p + 3 * (size_t)j + 2));
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      in = d <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    const int pos = found + __popc(mask & below);
    if (in && pos < nsample) {
      const float* src = v + (size_t)j * c;
      float* dst = o + (size_t)pos * c;
      for (int k = 0; k < c; ++k) dst[k] = __ldg(src + k);
    }
    found += __popc(mask);
  }
  const int start = found < nsample ? found : nsample;
  const long long pad = (long long)(nsample - start) * c;
  const bool has_self = self >= 0 && self < n;
  float* row = o + (size_t)start * c;
  for (long long e = lane; e < pad; e += 32) {
    row[e] = has_self ? __ldg(v + (size_t)self * c + (int)(e % c)) : 0.0f;
  }
}

}  // namespace

// C entry, bound with ctypes. xyz (B, N, 3) f32, new_xyz (B, S, 3) f32,
// itself (B, S) int32, values (B, N, C) f32 and out (B, S, nsample, C) f32
// are device pointers to contiguous tensors; r2 the squared radius. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int ball_group(const float* xyz, const float* new_xyz, const int* itself, const float* values, float* out,
                          int batch, int n, int s, int nsample, int c, float r2, void* stream) {
  if (batch <= 0 || n <= 0 || s <= 0 || nsample <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const long long queries = (long long)batch * s;
  const long long blocks = (queries + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_group_kernel<<<(unsigned)blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, itself, values, out, queries, n, s, nsample, c, r2);
  return (int)cudaGetLastError();
}
