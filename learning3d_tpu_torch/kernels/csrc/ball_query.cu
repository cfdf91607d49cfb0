// Ball query for Hopper (sm_90a), K15. xyz (B, N, 3) and new_xyz (B, S, 3)
// f32 in; idx (B, S, nsample) int32 or int64 out: for each query the first
// nsample indices of the points within the radius, in ascending order, a
// short row padded with its first in-ball index, a row with no point in the
// ball N everywhere.
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
// (B S nsample of them), so at FlowNet3D's shapes the bytes bound it
// (chip_smoke.py counts the points this run's queries need). At those
// shapes a launch is a few microseconds of device time, and the host's
// work around it is more.
//
// Design. The TPU kernel builds a (tile, N) distance tile in VMEM and takes
// nsample rounds of row-min extraction over the index keys. Here one warp
// takes one query (8 a block) and reads its cloud through L1, kRounds
// rounds of 32 points at a time (lane l the point j0 + 32 r + l, clamped
// into the cloud so that the loads carry no branch): every round's loads
// are issued before any is tested, so a query waits for L2 once for each
// 128 points instead of once for each 32. Then each round's ballot puts
// the in-ball lanes' indices at the row's count so far plus the popcount of
// the in-ball lanes below (ascending order without a sort), and the query
// stops once it has nsample. The output is int32, or int64 for
// ops.geometry, which then needs no conversion pass.
// A block that stages its cloud in shared memory for a tile of queries
// (cp.async chunks of 512 points, the next chunk in flight, a block vote
// before each) ran slower on the H100: FlowNet3D's queries read ~150 of
// 2048 points at sa1 (at most 112 at the other levels), so staging a chunk
// costs more than the L2 reads it saves (six launches 0.041 ms against
// 0.033 here, PERF.md).
// Any N, S and nsample that fit int32; 64-bit query, row and point offsets.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // queries a block
constexpr int kRounds = 4;   // 32-point rounds loaded before their ballots
constexpr unsigned kFull = 0xffffffffu;

template <typename Out>
__global__ void __launch_bounds__(32 * kWarps) ball_query_kernel(const float* __restrict__ xyz,
                                                                 const float* __restrict__ new_xyz,
                                                                 Out* __restrict__ out, long long queries, int n,
                                                                 int s, int nsample, float r2) {
  const long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= queries) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float* p = xyz + (q / s) * n * 3;
  const float qx = __ldg(new_xyz + 3 * q), qy = __ldg(new_xyz + 3 * q + 1), qz = __ldg(new_xyz + 3 * q + 2);
  Out* o = out + q * nsample;
  int found = 0, first = n;
  // j0 in 64 bits: j0 + 32 r + lane passes INT32_MAX for N near it
  for (long long j0 = 0; j0 < n && found < nsample; j0 += 32 * kRounds) {
    float x[kRounds], y[kRounds], z[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const size_t j = (size_t)min(j0 + 32 * r + lane, (long long)n - 1);
      x[r] = __ldg(p + 3 * j);
      y[r] = __ldg(p + 3 * j + 1);
      z[r] = __ldg(p + 3 * j + 2);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const float d0 = __fsub_rn(qx, x[r]), d1 = __fsub_rn(qy, y[r]), d2 = __fsub_rn(qz, z[r]);
      const bool in = j0 + 32 * r + lane < n &&
                      __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)) <= r2;
      const unsigned m = __ballot_sync(kFull, in);
      if (m == 0u) continue;
      const int j = (int)(j0 + 32 * r);  // < n: a lane of this round is in the cloud
      if (found == 0) first = j + __ffs(m) - 1;
      const int pos = found + __popc(m & below);
      if (in && pos < nsample) o[pos] = (Out)(j + lane);
      found += __popc(m);
    }
  }
  for (int pos = min(found, nsample) + lane; pos < nsample; pos += 32) o[pos] = (Out)first;
}

}  // namespace

// The scan's rounds loaded before their ballots (kernels/sampling.py's
// BALL_QUERY_ROUNDS, which the CPU emulation of the scan reads).
extern "C" int ball_query_rounds() { return kRounds; }

// C entry, bound with ctypes. xyz (B, N, 3) f32 and new_xyz (B, S, 3) f32
// and idx (B, S, nsample), int64 where is_i64 else int32, are device
// pointers to contiguous tensors; r2 the squared radius. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int ball_query(const float* xyz, const float* new_xyz, void* idx, int is_i64, int batch, int n, int s,
                          int nsample, float r2, void* stream) {
  if (batch <= 0 || n <= 0 || s <= 0 || nsample <= 0) return (int)cudaErrorInvalidValue;
  const long long queries = (long long)batch * s;
  const long long blocks = (queries + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_i64)
    ball_query_kernel<long long><<<(unsigned)blocks, 32 * kWarps, 0, st>>>(
        xyz, new_xyz, static_cast<long long*>(idx), queries, n, s, nsample, r2);
  else
    ball_query_kernel<int><<<(unsigned)blocks, 32 * kWarps, 0, st>>>(xyz, new_xyz, static_cast<int*>(idx), queries,
                                                                     n, s, nsample, r2);
  return (int)cudaGetLastError();
}
