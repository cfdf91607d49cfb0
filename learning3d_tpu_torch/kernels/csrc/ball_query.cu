// Ball query for Hopper (sm_90a). xyz (B, N, 3) and new_xyz (B, S, 3) f32
// in; idx (B, S, nsample) int32 out: for each query the first nsample
// indices of the points within the radius, in ascending order, a short row
// padded with its first in-ball index, a row with no point in the ball N
// everywhere.
//
// Replaces the TPU kernel learning3d_tpu/kernels/sampling.py::
// ball_query_pallas (body `_ballq_kernel`). Same math as the port's plain
// version `ball_query_reference`, every operation rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction, which would move a
// point that lies on the radius in or out):
//   d = ((qx - x)^2 + (qy - y)^2) + (qz - z)^2, in the ball where d <= r2,
// r2 the wrapper's f32 rounding of the Python float radius ** 2, as the JAX
// package passes it.
//
// Bound. The work depends on the data: a query reads points in index order
// until it has found nsample in the ball. Each point read costs 9 f32
// operations; the inputs are read once and the indices written once
// (B S nsample int32), so at FlowNet3D's shapes the bytes bound it
// (chip_smoke.py counts the points this run's queries need).
//
// Design. The TPU kernel builds a (tile, N) distance tile in VMEM and takes
// nsample rounds of row-min extraction over the index keys. Here one warp
// takes one query: it reads the cloud 32 points at a time (lane l the
// point j0 + l), takes a ballot of the in-ball lanes, and writes each
// in-ball index at the row's count so far plus the popcount of the in-ball
// lanes below it, so the row comes out in ascending order without a sort;
// it stops once nsample are found. Eight warps (8 queries) a block, any N,
// any S; the points are read through L2 (the cloud is 24 KB at N = 2048).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps) ball_query_kernel(const float* __restrict__ xyz,
                                                                 const float* __restrict__ new_xyz,
                                                                 int* __restrict__ out, long long queries, int n,
                                                                 int s, int nsample, float r2) {
  const long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= queries) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const long long b = q / s;
  const float* p = xyz + b * n * 3;
  const float qx = new_xyz[3 * q], qy = new_xyz[3 * q + 1], qz = new_xyz[3 * q + 2];
  int* o = out + q * nsample;
  const unsigned below = (1u << lane) - 1u;

  int found = 0, first = n;
  for (int j0 = 0; j0 < n && found < nsample; j0 += 32) {
    const int j = j0 + lane;
    bool in = false;
    if (j < n) {
      const float d0 = __fsub_rn(qx, __ldg(p + 3 * (size_t)j));
      const float d1 = __fsub_rn(qy, __ldg(p + 3 * (size_t)j + 1));
      const float d2 = __fsub_rn(qz, __ldg(p + 3 * (size_t)j + 2));
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      in = d <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (mask == 0u) continue;
    if (found == 0) first = j0 + __ffs(mask) - 1;
    const int pos = found + __popc(mask & below);
    if (in && pos < nsample) o[pos] = j;
    found += __popc(mask);
  }
  for (int pos = (found < nsample ? found : nsample) + lane; pos < nsample; pos += 32) o[pos] = first;
}

}  // namespace

// C entry, bound with ctypes. xyz (B, N, 3) f32, new_xyz (B, S, 3) f32 and
// idx (B, S, nsample) int32 are device pointers to contiguous tensors; r2
// the squared radius. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ball_query(const float* xyz, const float* new_xyz, int* idx, int batch, int n, int s, int nsample,
                          float r2, void* stream) {
  if (batch <= 0 || n <= 0 || s <= 0 || nsample <= 0) return (int)cudaErrorInvalidValue;
  const long long queries = (long long)batch * s;
  const long long blocks = (queries + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_kernel<<<(unsigned)blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, idx, queries, n, s, nsample, r2);
  return (int)cudaGetLastError();
}
