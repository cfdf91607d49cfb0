// Slack log-domain Sinkhorn for Hopper (sm_90a), K17. log_alpha (B, J, K)
// f32 in; out (B, J, K) f32: the log of RPMNet's near-doubly-stochastic
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
// the 0 being the slack entry. The same function in exact arithmetic, here
// computed in f64 (exp and log on f64, f64 sums, f64 potentials) from the
// f32 input, and the output rounded once, out = f32((f64(a) - u) - v): in
// effect the correctly rounded result. Why f64: chip_smoke.py holds one
// RPMNet train step on the kernels to the plain version's within 1e-3, and
// with random weights that gradient moves by 0.8% under rounding-sized
// changes of K17's output (the f64 result rounded to f32 at the potentials
// instead of once: 0.82%; three f32 versions of this design, each within
// 1.9e-6 of the plain version: 0.64-0.81%), and by 1.3e-4 with the f64
// result; the earlier f32 kernel (a row pass and a column pass an
// iteration) passed it at 1.1e-4 by sharing the plain f32 chain's bias
// (PERF.md).
//
// Bound. One read of log_alpha and one write of out, 8 B J K, against
// 2 n_iters (J+1)(K+1) exponentials: at RPMNet's B=16, J=K=1024, 5
// iterations, 134 MB (0.040 ms at 3.35 TB/s) against 168 M f32
// exponentials (0.040 ms at the SFU's 16 a clock on 132 SMs) - about even.
// In f64 the exponentials bind it: this design takes one f64 exp a value
// and iteration.
//
// Design. One item's matrix is 4.2 MB, past a block's 227 KB of shared
// memory and a 16-block cluster's 3.6 MB, so it stays in device memory (and
// at B=16 its 67 MB only partly in the 50 MB L2). An iteration is one sweep
// over the matrix and a small merge, so a call reads the matrix n_iters + 1
// times (the sweeps and the output pass), where a row pass and a column
// pass would read it 2 n_iters + 1 times:
// * sweep: a block of 256 threads takes kRows = 16 rows of one item, in
//   chunks of kChunk = 1024 columns; a thread holds kCols = 4 columns of
//   every row of a chunk in registers (x[16][4]), so that each element is
//   read from device memory once and from no shared memory. The rows' u
//   from the last iteration's v: each thread's per-row max (at least the
//   slack column's 0), a block reduction of the 16 rows at once (a padded
//   16 x 256 table in shared memory, 16 threads a row, then shuffles), then
//   the terms t = exp(a - v - m_r) and their sums the same way, merged over
//   the chunks. Then each column's partial over the 16 rows: where the row
//   fits one chunk (K <= 1024) from the kept terms, exp(a - u_r - M) =
//   t exp(v - M) / s_r with M = max(0, v), an upper bound of a - u_r, so
//   no second exp a value; past that the chunks are read again and each
//   column's max taken. The partials (m, s) go to a (B, ceil(J / kRows), K)
//   pair of f64 arrays (16 MB at RPMNet's shape).
// * merge: v[k] = lse(0, the column's partials), a block of 8 warps a tile
//   of 32 columns, each warp every 8th partial, lanes across the tile's
//   columns (coalesced): the max over the partials first, then the sum of
//   s_p exp(m_p - max), the warps' results combined in shared memory;
// * output: out = f32((f64(a) - u) - v), a block a row.
// (A pass over B=4's 17 MB, which fits the L2, ran no faster a byte than
// over B=16's 67 MB, so no pass orders its work for the L2. An f32 version
// of the sweep ran at 0.32 ms a call at RPMNet's shape, against 0.52 here.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;                  // rows a sweep block
constexpr int kThreads = 256;              // a sweep or merge block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                   // columns of a chunk a sweep thread holds, kThreads apart
constexpr int kChunk = kThreads * kCols;   // columns a sweep block holds at once
constexpr int kRedStride = kThreads + 16;  // a row of the reduction table, padded
constexpr int kOutThreads = 256;

static_assert(kThreads == 16 * kRows, "block_rows reduces each row with 16 threads");

// The max (MAX) or the sum over the block of each thread's vals[r], for the
// kRows rows at once, into res (shared memory): the table red holds row r's
// 256 values; 16 threads a row reduce 16 each, then shuffle within their 16
// lanes.
template <bool MAX>
__device__ __forceinline__ void block_rows(const double (&vals)[kRows], double (*red)[kRedStride], double* res,
                                           int tid) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[r][tid] = vals[r];
  __syncthreads();
  const int r = tid >> 4, l = tid & 15;
  double acc = red[r][l];
#pragma unroll
  for (int i = 1; i < kThreads / 16; ++i) acc = MAX ? fmax(acc, red[r][l + 16 * i]) : acc + red[r][l + 16 * i];
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = MAX ? fmax(acc, o) : acc + o;
  }
  if (l == 0) res[r] = acc;
  __syncthreads();
}

// One iteration's sweep (see the file comment): u[b, i] for the block's
// rows, and the column partials pm, ps (B, tiles, K) over them.
__global__ void __launch_bounds__(kThreads, 1) sweep(const float* __restrict__ a, const double* __restrict__ v,
                                                     double* __restrict__ u, double* __restrict__ pm,
                                                     double* __restrict__ ps, int j, int k, int tiles) {
  __shared__ double red[kRows][kRedStride];
  __shared__ double cmax[kRows], csum[kRows];  // a chunk's row maxima and sums
  __shared__ double us[kRows];
  __shared__ double rinv[kRows];  // 1 / the rows' sums at their max, for one chunk
  const long long b = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - b * tiles);
  const int i0 = tile * kRows, nr = min(kRows, j - i0);
  const int tid = threadIdx.x;
  const float* ab = a + ((size_t)b * j + i0) * k;
  const double* vb = v + (size_t)b * k;

  // x[r][q]: row r, column c0 + tid + kThreads q of the chunk at c0; -inf
  // past the rows and columns (nothing to any max or sum)
  float x[kRows][kCols];
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = c0 + tid + kThreads * q;
        x[r][q] = r < nr && c < k ? __ldg(ab + (size_t)r * k + c) : -INFINITY;
      }
  };

  // the rows' u: row tid's (m, s) over the chunks in thread tid, the slack
  // column's 0 first
  double rm = 0.0, rs = 1.0;
  double t[kRows][kCols], vprev[kCols];  // the last chunk's terms exp(a - v - m_r) and v
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    load(c0);
    double vq[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = c0 + tid + kThreads * q;
      vq[q] = c < k ? __ldg(vb + c) : 0.0;
    }
    double part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      double m = 0.0;  // at least the slack column's 0: no -inf max
#pragma unroll
      for (int q = 0; q < kCols; ++q) m = fmax(m, static_cast<double>(x[r][q]) - vq[q]);
      part[r] = m;
    }
    block_rows<true>(part, red, cmax, tid);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const double mr = cmax[r];
      double sr = 0.0;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        t[r][q] = exp(static_cast<double>(x[r][q]) - vq[q] - mr);
        sr += t[r][q];
      }
      part[r] = sr;
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) vprev[q] = vq[q];
    block_rows<false>(part, red, csum, tid);
    if (tid < kRows) {  // merge into the running (m, s), at the larger max
      const double mn = fmax(rm, cmax[tid]);
      rs = rs * exp(rm - mn) + csum[tid] * exp(cmax[tid] - mn);
      rm = mn;
    }
  }
  if (tid < nr) {
    us[tid] = rm + log(rs);
    u[(size_t)b * j + i0 + tid] = us[tid];
  }
  if (tid < kRows) rinv[tid] = tid < nr ? 1.0 / rs : 0.0;
  __syncthreads();

  // the column partials over the block's rows
  double* pmb = pm + ((size_t)b * tiles + tile) * k;
  double* psb = ps + ((size_t)b * tiles + tile) * k;
  if (k <= kChunk) {  // from the kept terms: exp(a - u_r - M) = t exp(v - M) / s_r, M = max(0, v) >= a - u_r
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = tid + kThreads * q;
      const double mk = fmax(0.0, vprev[q]);
      double sc = 0.0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc += t[r][q] * rinv[r];
      if (c < k) {
        pmb[c] = mk;
        psb[c] = sc * exp(vprev[q] - mk);
      }
    }
    return;
  }
  for (int c0 = 0; c0 < k; c0 += kChunk) {  // past one chunk: each chunk read again, each column's max taken
    load(c0);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = c0 + tid + kThreads * q;
      double m = 0.0;  // at least the slack row's 0, which the merge adds: no -inf max
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) m = fmax(m, static_cast<double>(x[r][q]) - us[r]);
      double sc = 0.0;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) sc += exp(static_cast<double>(x[r][q]) - us[r] - m);
      if (c < k) {
        pmb[c] = m;
        psb[c] = sc;
      }
    }
  }
}

// v[b, c] = lse(0, the column's partials): a block a tile of 32 columns.
__global__ void __launch_bounds__(kThreads) merge(const double* __restrict__ pm, const double* __restrict__ ps,
                                                  double* __restrict__ v, int k, int tiles, int col_tiles) {
  __shared__ double sm_m[kWarps][32], sm_s[kWarps][32];
  const long long b = blockIdx.x / col_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.x % col_tiles) * 32 + lane;
  const bool live = c < k;
  const size_t base = (size_t)b * tiles * k + c;
  double m = 0.0;  // the slack row's 0
  if (live)
    for (int p = warp; p < tiles; p += kWarps) m = fmax(m, __ldg(pm + base + (size_t)p * k));
  sm_m[warp][lane] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmax(m, sm_m[w][lane]);
  double s = warp == 0 ? exp(-m) : 0.0;  // the slack row
  if (live)
    for (int p = warp; p < tiles; p += kWarps) {
      const size_t at = base + (size_t)p * k;
      s += __ldg(ps + at) * exp(__ldg(pm + at) - m);
    }
  sm_s[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) s += sm_s[w][lane];
    if (live) v[b * k + c] = m + log(s);
  }
}

// out[b, i, c] = f32((f64(a[b, i, c]) - u[b, i]) - v[b, c]): a block a row.
__global__ void __launch_bounds__(kOutThreads) out_pass(const float* __restrict__ a, const double* __restrict__ u,
                                                         const double* __restrict__ v, float* __restrict__ out, int j,
                                                         int k) {
  const long long r = blockIdx.x;
  const long long b = r / j;
  const double ui = u[r];
  const float* ar = a + r * k;
  const double* vb = v + b * k;
  float* o = out + r * k;
  for (int c = threadIdx.x; c < k; c += kOutThreads)
    o[c] = static_cast<float>(static_cast<double>(__ldg(ar + c)) - ui - __ldg(vb + c));
}

}  // namespace

// C entry, bound with ctypes. a (B, J, K) and out (B, J, K) f32 are device
// pointers to contiguous tensors; u (B, J) and v (B, K) f64 scratch for the
// potentials (zeroed here: n_iters = 0 gives out = a); part f64 scratch of 2
// B ceil(J / part_rows) K for the sweeps' column partials, part_rows the
// rows a sweep block takes as the caller sized it (must be 16). Launches
// 2 n_iters + 1 kernels on the stream (n_iters sweeps and merges, the
// output pass); returns the first CUDA error code (0 on success).
extern "C" int sinkhorn_slack(const float* a, float* out, double* u, double* v, double* part, int batch, int j, int k,
                              int n_iters, int part_rows, void* stream) {
  if (batch <= 0 || j <= 0 || k <= 0 || n_iters < 0 || part_rows != kRows) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * j;
  const int tiles = (j + kRows - 1) / kRows;
  const long long sweep_blocks = (long long)batch * tiles;
  const int col_tiles = (k + 31) / 32;
  const long long merge_blocks = (long long)batch * col_tiles;
  if (rows > 0x7fffffffLL || merge_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(u, 0, sizeof(double) * rows, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(v, 0, sizeof(double) * batch * (size_t)k, st);
  if (err != cudaSuccess) return (int)err;
  double* pm = part;
  double* ps = part + (size_t)sweep_blocks * k;
  for (int it = 0; it < n_iters; ++it) {
    sweep<<<(unsigned)sweep_blocks, kThreads, 0, st>>>(a, v, u, pm, ps, j, k, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    merge<<<(unsigned)merge_blocks, kThreads, 0, st>>>(pm, ps, v, k, tiles, col_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  out_pass<<<(unsigned)rows, kOutThreads, 0, st>>>(a, u, v, out, j, k);
  return (int)cudaGetLastError();
}
