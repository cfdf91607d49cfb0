// Slack log-domain Sinkhorn for Hopper (sm_90a). log_alpha (B, J, K) f32
// in; out (B, J, K) f32: the log of RPMNet's near-doubly-stochastic
// matrix after n_iters iterations over the matrix padded with a zero slack
// row and column, each iteration normalising the first J rows over all K+1
// columns and then the first K columns over all J+1 rows.
//
// Replaces the TPU kernel learning3d_tpu/kernels/sinkhorn.py::
// sinkhorn_log_pallas (body `_sinkhorn_kernel`). The port's plain version
// `sinkhorn_slack_reference` (the twin of the JAX package's XLA oracle
// `_sinkhorn_slack_xla`) subtracts each logsumexp from the whole matrix, pass
// after pass. Here the matrix is never rewritten: with potentials u (rows)
// and v (columns), the padded matrix after any pass is a[i,k] - u[i] - v[k],
// the slack row and column stay 0 (u[J] = v[K] = 0), and
//   row pass:    u[i] = lse(0, {a[i,k] - v[k]}_k),    i < J,
//   column pass: v[k] = lse(0, {a[i,k] - u[i]}_i),    k < K,
//   out[i,k] = (a[i,k] - u[i]) - v[k],
// the 0 being the slack entry. The same function in exact arithmetic; in f32
// it rounds fewer times than the plain version's chain (at RPMNet's shapes
// and range both lie within 4e-6 of the f64 result). Each logsumexp is
// m + logf(sum expf(x - m)), m the running max (at least 0, the slack
// entry), kept online in chunks of 4 values (one rescale a chunk at most),
// and merged across lanes and warps as (m, s) pairs. expf and logf are the
// accurate library functions.
//
// Bound. One read of log_alpha and one write of out, 8 B J K, against
// 2 n_iters (J+1)(K+1) exponentials: at RPMNet's B=16, J=K=1024, 5
// iterations, 134 MB (0.040 ms at 3.35 TB/s) against 168 M exponentials
// (0.040 ms at the SFU's 16 a clock on 132 SMs) - about even.
//
// Design. One item's matrix is 4.2 MB, past a block's 227 KB of shared
// memory and a 16-block cluster's 3.6 MB, so it stays in device memory (and
// at B=16 its 67 MB only partly in the 50 MB L2). A block an item would use
// 16 of the 132 SMs (K14's lesson: a serial chain on a few SMs); so each pass
// is a launch of its own over the whole batch, the launches ordered by the
// stream: 2 n_iters + 1 launches from one C call. A pass reads the matrix
// once and writes only its potential vector (4 B a row or column):
//   row pass, a warp a row, lanes across the columns (coalesced);
//   column pass, a block of 8 warps a tile of 32 columns, each warp taking
//   every 8th row, lanes across the tile's columns (coalesced 128 B rows),
//   the warps' (m, s) merged in shared memory;
//   output, a block a row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;  // rows (warps) a block in the row pass
constexpr int kColWarps = 8;  // warps a block in the column pass, over one 32-column tile
constexpr int kOutThreads = 256;

// (m, s) with lse = m + log(s): fold in 4 values (-INFINITY for none).
__device__ __forceinline__ void lse_add4(float& m, float& s, float x0, float x1, float x2, float x3) {
  const float cm = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
  if (cm > m) {
    s *= expf(m - cm);
    m = cm;
  }
  s += (expf(x0 - m) + expf(x1 - m)) + (expf(x2 - m) + expf(x3 - m));
}

// Merge (mo, so) into (m, s); both m finite (>= 0: every lse starts from the
// slack entry's 0).
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

__device__ __forceinline__ void lse_warp(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, mo, so);
  }
}

// u[b, i] = lse(0, {a[b, i, k] - v[b, k]}_k): a warp a row.
__global__ void __launch_bounds__(32 * kRowWarps) row_pass(const float* __restrict__ a, const float* __restrict__ v,
                                                            float* __restrict__ u, long long rows, int j, int k) {
  const long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the same for the whole warp
  const int lane = threadIdx.x & 31;
  const long long b = r / j;
  const float* ar = a + r * k;
  const float* vb = v + b * k;
  float m = 0.0f, s = lane == 0 ? 1.0f : 0.0f;  // the slack column: a 0 entry
  for (int c0 = 0; c0 < k; c0 += 128) {
    float x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = c0 + 32 * t + lane;
      x[t] = c < k ? __fsub_rn(__ldg(ar + c), __ldg(vb + c)) : -INFINITY;
    }
    lse_add4(m, s, x[0], x[1], x[2], x[3]);
  }
  lse_warp(m, s);
  if (lane == 0) u[r] = m + logf(s);
}

// v[b, c] = lse(0, {a[b, i, c] - u[b, i]}_i): a block a tile of 32 columns.
__global__ void __launch_bounds__(32 * kColWarps) col_pass(const float* __restrict__ a, const float* __restrict__ u,
                                                            float* __restrict__ v, int tiles, int j, int k) {
  __shared__ float sm_m[kColWarps][32], sm_s[kColWarps][32];
  const long long b = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.x % tiles) * 32 + lane;
  const bool live = c < k;
  const float* ab = a + b * j * (long long)k;
  const float* ub = u + b * j;
  float m = 0.0f, s = warp == 0 ? 1.0f : 0.0f;  // the slack row: a 0 entry
  for (int i0 = warp; i0 < j; i0 += 4 * kColWarps) {
    float x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = i0 + t * kColWarps;
      x[t] = (live && i < j) ? __fsub_rn(__ldg(ab + (size_t)i * k + c), __ldg(ub + i)) : -INFINITY;
    }
    lse_add4(m, s, x[0], x[1], x[2], x[3]);
  }
  sm_m[warp][lane] = m;
  sm_s[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kColWarps; ++w) lse_merge(m, s, sm_m[w][lane], sm_s[w][lane]);
    if (live) v[b * k + c] = m + logf(s);
  }
}

// out[b, i, c] = (a[b, i, c] - u[b, i]) - v[b, c]: a block a row.
__global__ void __launch_bounds__(kOutThreads) out_pass(const float* __restrict__ a, const float* __restrict__ u,
                                                         const float* __restrict__ v, float* __restrict__ out, int j,
                                                         int k) {
  const long long r = blockIdx.x;
  const long long b = r / j;
  const float ui = u[r];
  const float* ar = a + r * k;
  const float* vb = v + b * k;
  float* o = out + r * k;
  for (int c = threadIdx.x; c < k; c += kOutThreads) o[c] = __fsub_rn(__fsub_rn(__ldg(ar + c), ui), __ldg(vb + c));
}

}  // namespace

// C entry, bound with ctypes. a (B, J, K) and out (B, J, K) f32 are device
// pointers to contiguous tensors, u (B, J) and v (B, K) f32 scratch for the
// potentials (zeroed here: n_iters = 0 gives out = a). Launches 2 n_iters + 1
// kernels on the stream; returns the first CUDA error code (0 on success).
extern "C" int sinkhorn_slack(const float* a, float* out, float* u, float* v, int batch, int j, int k, int n_iters,
                              void* stream) {
  if (batch <= 0 || j <= 0 || k <= 0 || n_iters < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * j;
  const long long row_blocks = (rows + kRowWarps - 1) / kRowWarps;
  const int tiles = (k + 31) / 32;
  const long long col_blocks = (long long)batch * tiles;
  if (rows > 0x7fffffffLL || col_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(u, 0, sizeof(float) * rows, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(v, 0, sizeof(float) * batch * (size_t)k, st);
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < n_iters; ++it) {
    row_pass<<<(unsigned)row_blocks, 32 * kRowWarps, 0, st>>>(a, v, u, rows, j, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    col_pass<<<(unsigned)col_blocks, 32 * kColWarps, 0, st>>>(a, u, v, tiles, j, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  out_pass<<<(unsigned)rows, kOutThreads, 0, st>>>(a, u, v, out, j, k);
  return (int)cudaGetLastError();
}
