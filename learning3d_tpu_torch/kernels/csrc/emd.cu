// Approximate Earth Mover's Distance (approxmatch) forward with the
// fixed-match gradients, for Hopper (sm_90a): x (B, N, 3), y (B, M, 3) f32,
// N, M <= 4096 -> cost (B,), g1 (B, N, 3), g2 (B, M, 3) f32.
//
// Replaces the TPU kernel learning3d_tpu/kernels/emd.py::_emd_fwd_pallas
// (body `_emd_pallas_kernel`). Ten annealing levels, level = -4^j for
// j = 7..-1 and then 0, each with K = exp(level * d^2): ratioL = remainL /
// (K remainR + 1e-9); sumr = remainR * (K^T ratioL); ratioR = min(remainR /
// (sumr + 1e-9), 1) * remainR; remainR = max(remainR - sumr, 0); the match
// W = K ratioL ratioR^T; remainL = max(remainL - W 1, 0); cost += sum W C
// with C = sqrt(max(d^2, 1e-20)); g1 += x * rowsum(W / C) - (W / C) y and
// g2 += y * colsum(W / C) - (W / C)^T x. The same arithmetic as the port's
// plain version `_emd_fwd_reference` (kernels/emd.py), which factors the
// sums as the passes below do: the column sums of W / C are ratioR times
// column sums of K ratioL / C, the row sums ratioL times row sums of
// K ratioR (C, 1 / C, y). d^2 is (d0*d0 + d1*d1) + d2*d2 of exact
// per-coordinate differences, with __fsub_rn/__fmul_rn/__fadd_rn so that
// nvcc cannot contract it into FMAs; exp is expf (not __expf).
//
// No (N, M) matrix goes to device memory: every pass recomputes d^2 and K
// from the coordinates, which it stages through shared memory.
//
// Passes. A level's match needs ratioR, which needs a column's sum over all
// rows of K ratioL, so W's row sums can only follow a pass over the columns.
// The TPU kernel keeps a whole (N, chunk) tile in its large VMEM and merges
// the two; here a level is
//   * a column pass: one group of kSplit threads a column m, summing over
//     the rows K ratioL, K ratioL / C and K ratioL / C x_n; then ratioR,
//     remainR and g2 of column m;
//   * a row pass: one group of kSplit threads a row n, summing over the
//     columns K ratioR, K ratioR C, K ratioR / C and K ratioR / C y_m; then
//     the row's cost, g1 and remainL; and, in the same sweep, the next
//     level's K' remainR, so ratioL of the next level (the first row pass
//     computes only that, for level 0).
// So three exponentials a pair and level where the TPU kernel takes two,
// and two sweeps over the pairs a level, as on the TPU. The threads of a
// group split the sweep's points (strided) and reduce by shuffles in a
// fixed order; every row and column has one owner: no atomics, and the
// result does not change from run to run. The per-row costs are summed by
// one more kernel, one block a cloud, in a fixed order. 22 launches a call.
//
// Bound. The function takes 2 * 10 * B * N * M exponentials, one a pair in
// each of the TPU kernel's two passes a level: at B=32, N=M=1024, 671 M,
// 0.161 ms at the SFU's 16 a clock on each of 132 SMs (1.98 GHz). Its f32
// arithmetic, 43 operations a pair and level in the TPU kernel's two passes
// (11 in phase A: d^2, the level, a product and a sum; 32 in phase B/C:
// d^2, the level, sumr, W, C, the cost, W / C, and the row and column sums
// of W, W / C and W / C times the coordinates), is 14.4 G operations,
// 0.215 ms at 67 TFLOP/s, which is the larger: it is bound by operations.
// Its bytes (x, y in, cost and the gradients out, 0.8 MB) take 0.2 us.
// What limits this design: the third
// exponential and the IEEE sqrt and division a pair (1 / C), and, at
// B=32, 32,768 rows or columns, 262,144 threads in groups of 8.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 8;  // threads that share one row or column
constexpr int kGroups = kThreads / kSplit;
constexpr int kTile = 1024;  // points of the other cloud staged at a time
constexpr int kMaxPoints = 4096;
constexpr float kEps = 1e-9f;
constexpr int kLevels = 10;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float4 b) {
  const float d0 = __fsub_rn(ax, b.x), d1 = __fsub_rn(ay, b.y), d2 = __fsub_rn(az, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// Sum over the kSplit lanes of a group (consecutive lanes), every lane
// receiving the total.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kSplit / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct State {
  float* remain_l;  // (B, N)
  float* ratio_l;   // (B, N)
  float* cost_row;  // (B, N)
  float* rr;        // (B, M) remainR
  float* ratio_r;   // (B, M)
};

// The row pass. first: level 0's K remainR only (remainR = mult_r), and the
// rows' state initialized. Otherwise the C part of level `lv` (its ratioR
// from the column pass), and, if has_next, the next level's ratioL.
__global__ void __launch_bounds__(kThreads) emd_row_pass(const float* __restrict__ x, const float* __restrict__ y,
                                                         float* __restrict__ g1, State st, int n_x, int n_y,
                                                         float lv, float lv_next, int first, int has_next,
                                                         float mult_l, float mult_r) {
  __shared__ float4 ys[kTile];
  __shared__ float rrs[kTile];
  __shared__ float rts[kTile];
  const int blocks_per_cloud = (n_x + kGroups - 1) / kGroups;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int n = (blockIdx.x - cloud * blocks_per_cloud) * kGroups + threadIdx.x / kSplit;
  const int lane = threadIdx.x % kSplit;
  const bool valid = n < n_x;
  const size_t row = (size_t)cloud * n_x + (valid ? n : 0);
  const float ax = x[row * 3], ay = x[row * 3 + 1], az = x[row * 3 + 2];
  const float* yc = y + (size_t)cloud * n_y * 3;
  const float* rr = st.rr + (size_t)cloud * n_y;
  const float* rt = st.ratio_r + (size_t)cloud * n_y;
  const bool do_c = !first, do_a = first || has_next;

  float sk = 0.f, skc = 0.f, skic = 0.f, sy0 = 0.f, sy1 = 0.f, sy2 = 0.f, ka = 0.f;
  for (int t0 = 0; t0 < n_y; t0 += kTile) {
    const int len = min(kTile, n_y - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* p = yc + (size_t)(t0 + i) * 3;
      ys[i] = make_float4(p[0], p[1], p[2], 0.f);
      rrs[i] = first ? mult_r : rr[t0 + i];
      rts[i] = first ? 0.f : rt[t0 + i];
    }
    __syncthreads();
    for (int i = lane; i < len; i += kSplit) {
      const float4 p = ys[i];
      const float d2 = sqdist(ax, ay, az, p);
      if (do_c) {
        const float c = sqrtf(fmaxf(d2, 1e-20f));
        const float ic = 1.0f / c;
        const float kr = expf(__fmul_rn(lv, d2)) * rts[i];
        const float krc = kr * ic;
        sk += kr;
        skc += kr * c;
        skic += krc;
        sy0 += krc * p.x;
        sy1 += krc * p.y;
        sy2 += krc * p.z;
      }
      if (do_a) ka += expf(__fmul_rn(lv_next, d2)) * rrs[i];
    }
  }
  ka = group_sum(ka);
  if (do_c) {
    sk = group_sum(sk);
    skc = group_sum(skc);
    skic = group_sum(skic);
    sy0 = group_sum(sy0);
    sy1 = group_sum(sy1);
    sy2 = group_sum(sy2);
  }
  if (!valid || lane != 0) return;
  float remain = first ? mult_l : st.remain_l[row];
  if (first) {
    st.cost_row[row] = 0.f;
    g1[row * 3] = g1[row * 3 + 1] = g1[row * 3 + 2] = 0.f;
  } else {
    const float rl = st.ratio_l[row];
    st.cost_row[row] += rl * skc;
    const float rs = rl * skic;
    g1[row * 3] += ax * rs - rl * sy0;
    g1[row * 3 + 1] += ay * rs - rl * sy1;
    g1[row * 3 + 2] += az * rs - rl * sy2;
    remain = fmaxf(remain - rl * sk, 0.f);
  }
  st.remain_l[row] = remain;
  if (do_a) st.ratio_l[row] = remain / (ka + kEps);
}

// The column pass of level `lv`: ratioR, remainR and g2 of each column, from
// the ratioL of the row pass before it. first: remainR starts at mult_r and
// g2 at 0.
__global__ void __launch_bounds__(kThreads) emd_col_pass(const float* __restrict__ x, const float* __restrict__ y,
                                                         float* __restrict__ g2, State st, int n_x, int n_y,
                                                         float lv, int first, float mult_r) {
  __shared__ float4 xs[kTile];
  __shared__ float rls[kTile];
  const int blocks_per_cloud = (n_y + kGroups - 1) / kGroups;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int m = (blockIdx.x - cloud * blocks_per_cloud) * kGroups + threadIdx.x / kSplit;
  const int lane = threadIdx.x % kSplit;
  const bool valid = m < n_y;
  const size_t col = (size_t)cloud * n_y + (valid ? m : 0);
  const float bx = y[col * 3], by = y[col * 3 + 1], bz = y[col * 3 + 2];
  const float* xc = x + (size_t)cloud * n_x * 3;
  const float* rl = st.ratio_l + (size_t)cloud * n_x;

  float s = 0.f, sc = 0.f, sx0 = 0.f, sx1 = 0.f, sx2 = 0.f;
  for (int t0 = 0; t0 < n_x; t0 += kTile) {
    const int len = min(kTile, n_x - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* p = xc + (size_t)(t0 + i) * 3;
      xs[i] = make_float4(p[0], p[1], p[2], 0.f);
      rls[i] = rl[t0 + i];
    }
    __syncthreads();
    for (int i = lane; i < len; i += kSplit) {
      const float4 p = xs[i];
      // x - y, as everywhere else: the same d^2 bits as the row pass
      const float d0 = __fsub_rn(p.x, bx), d1 = __fsub_rn(p.y, by), d2c = __fsub_rn(p.z, bz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2c, d2c));
      const float c = sqrtf(fmaxf(d2, 1e-20f));
      const float ic = 1.0f / c;
      const float kl = expf(__fmul_rn(lv, d2)) * rls[i];
      const float klc = kl * ic;
      s += kl;
      sc += klc;
      sx0 += klc * p.x;
      sx1 += klc * p.y;
      sx2 += klc * p.z;
    }
  }
  s = group_sum(s);
  sc = group_sum(sc);
  sx0 = group_sum(sx0);
  sx1 = group_sum(sx1);
  sx2 = group_sum(sx2);
  if (!valid || lane != 0) return;
  const float r = first ? mult_r : st.rr[col];
  const float sumr = r * s;
  const float ratio_r = fminf(r / (sumr + kEps), 1.0f) * r;
  st.rr[col] = fmaxf(r - sumr, 0.f);
  st.ratio_r[col] = ratio_r;
  const float cs = ratio_r * sc;
  const float g0 = bx * cs - ratio_r * sx0, g1v = by * cs - ratio_r * sx1, g2v = bz * cs - ratio_r * sx2;
  if (first) {
    g2[col * 3] = g0;
    g2[col * 3 + 1] = g1v;
    g2[col * 3 + 2] = g2v;
  } else {
    g2[col * 3] += g0;
    g2[col * 3 + 1] += g1v;
    g2[col * 3 + 2] += g2v;
  }
}

// cost[b] = sum_n cost_row[b, n], one block a cloud, in a fixed order.
__global__ void __launch_bounds__(kThreads) emd_cost_sum(const float* __restrict__ cost_row,
                                                         float* __restrict__ cost, int n_x) {
  __shared__ float part[kThreads];
  const float* cr = cost_row + (size_t)blockIdx.x * n_x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_x; i += kThreads) s += cr[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[blockIdx.x] = part[0];
}

__host__ float level(int j) {  // -4^(7 - j) for j < 9, then 0
  if (j >= kLevels - 1) return 0.f;
  float v = 1.f;
  for (int e = 7 - j; e > 0; --e) v *= 4.f;
  for (int e = 7 - j; e < 0; ++e) v *= 0.25f;
  return -v;
}

}  // namespace

// C entry, bound with ctypes. x (B, N, 3), y (B, M, 3) f32, cost (B,),
// g1 (B, N, 3), g2 (B, M, 3) f32 and scratch (B * (3N + 2M) f32) are device
// pointers to contiguous tensors; 1 <= N, M <= 4096. mult_l, mult_r: the
// rows' and columns' starting mass. Returns the first CUDA error code of
// the launches (0 on success).
extern "C" int emd_fwd(const float* x, const float* y, float* cost, float* g1, float* g2, float* scratch, int batch,
                       int n_x, int n_y, float mult_l, float mult_r, void* stream) {
  if (batch <= 0 || n_x < 1 || n_y < 1 || n_x > kMaxPoints || n_y > kMaxPoints) return (int)cudaErrorInvalidValue;
  const long long row_blocks = (long long)batch * ((n_x + kGroups - 1) / kGroups);
  const long long col_blocks = (long long)batch * ((n_y + kGroups - 1) / kGroups);
  if (row_blocks > 0x7fffffffLL || col_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  State st;
  st.remain_l = scratch;
  st.ratio_l = st.remain_l + (size_t)batch * n_x;
  st.cost_row = st.ratio_l + (size_t)batch * n_x;
  st.rr = st.cost_row + (size_t)batch * n_x;
  st.ratio_r = st.rr + (size_t)batch * n_y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  emd_row_pass<<<(unsigned)row_blocks, kThreads, 0, s>>>(x, y, g1, st, n_x, n_y, 0.f, level(0), 1, 1, mult_l,
                                                          mult_r);
  cudaError_t err = cudaGetLastError();
  for (int j = 0; j < kLevels && err == cudaSuccess; ++j) {
    emd_col_pass<<<(unsigned)col_blocks, kThreads, 0, s>>>(x, y, g2, st, n_x, n_y, level(j), j == 0, mult_r);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    const int has_next = j + 1 < kLevels;
    emd_row_pass<<<(unsigned)row_blocks, kThreads, 0, s>>>(x, y, g1, st, n_x, n_y, level(j),
                                                            has_next ? level(j + 1) : 0.f, 0, has_next, mult_l,
                                                            mult_r);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  emd_cost_sum<<<batch, kThreads, 0, s>>>(st.cost_row, cost, n_x);
  return (int)cudaGetLastError();
}
