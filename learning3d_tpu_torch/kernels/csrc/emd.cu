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
// nvcc cannot contract it into FMAs.
//
// Bound (chip_smoke.py's k13_bound). Per pair and level the function takes
// two exponentials (one a pair in each of the TPU kernel's two passes) and,
// on the CUDA cores, the two exact squared distances (16 instructions that
// cannot fuse) and 27 other flops (an FMA counted as two): at B=32,
// N=M=1024 that is 0.2957 ms at 67 TFLOP/s and 132 x 128 instructions a
// clock (1.98 GHz), over the SFU's 0.161 ms for the exponentials: bound by
// operations. Its bytes (x, y in, cost and the gradients out, 0.8 MB) take
// 0.2 us.
//
// Design: one launch a call, one thread-block cluster a cloud.
//   * Every CTA of a cloud's cluster holds both clouds in shared memory,
//     loaded once: x as float4 (x, y, z, ratioL), y as float4 (y, ratioR) and
//     remainR, 20 bytes a point of each cloud (160 KB at the gate's 4096 +
//     4096 points). Each CTA owns a slice of the rows and a slice of the
//     columns (ceil(N / S) and ceil(M / S) of them, S the cluster's size).
//   * A level is a column pass (each owned column m sums over every row
//     K ratioL, K ratioL / C and K ratioL / C x_n; then ratioR, remainR and
//     g2 of m) and a row pass (each owned row n sums over every column
//     K ratioR, K ratioR C, K ratioR / C, K ratioR / C y_m and the next
//     level's K' remainR; then the row's cost, g1, remainL and the next
//     ratioL). The owner of a column writes its ratioR and remainR, the
//     owner of a row its ratioL, into every CTA of the cluster (distributed
//     shared memory), and a cluster barrier follows each pass: no pass
//     reads what another CTA writes in the same pass, and every value is
//     written by one thread. All ten levels run in the launch; clusters
//     never wait on each other.
//   * Two exponentials a pair and level: the levels step by 4, so the row
//     pass takes K = (K')^4 from the next level's K' = exp(level' d^2) by
//     two squarings (from -0.25 to 0, where K' = 1, it takes K itself; at
//     level 0 K = 1); the column pass takes its own. An exponential is
//     ex2.approx.ftz of (level log2 e) d^2: 2 instructions where expf takes
//     8. Its argument's rounding moves K by up to |level d^2| 2^-24 relative
//     (6e-6 where K is not flushed to 0, which it is below e^-87 instead of
//     e^-103); expf took 17-19% longer at PCN's shape on an H100.
//   * One reciprocal square root a pair and pass: 1 / C = rsqrt(max(d^2,
//     1e-20)) (rsqrt.approx, within 2 ulp; its argument is never
//     subnormal) and C = max(d^2, 1e-20) * (1 / C).
//   * Each row or column has kSplit = 4 threads, each summing every 4th
//     point of the other cloud in order, read from shared memory; a thread
//     group takes kRows = 2 rows at once (each point read once for both),
//     and the 4 partial sums meet by shuffles in a fixed order. The
//     accumulators across levels (remainL, a row's cost, g1, g2) live in
//     device memory and are read and written by their owner only, once a
//     pass.
//   * The cost: each CTA sums its rows' costs in a fixed order (a tree over
//     its threads) and writes the partial into the first CTA of the
//     cluster, which sums the partials in rank order. No atomics anywhere:
//     the result does not change from run to run.
//   * `plan`: the cluster's size S is the smallest power of two (up to the
//     16 CTAs the card holds) that leaves a CTA at most 64 rows of the
//     larger cloud, whatever B; small CTAs, four an SM, hid the passes'
//     latencies best (at B=32, N=M=1024: 16 CTAs of 128 threads a cloud,
//     28 of the 32 clusters at once, 0.85 ms, against 1.5-1.7 ms for one
//     256-thread CTA an SM in clusters of 4, of which the card holds 30).
//     Past 16 CTAs a cloud (N > 1024) a CTA takes 128 or 256 rows with more
//     threads (kV128, kV256). One cloud of 4096 points runs on 16 SMs, near
//     their own issue rate, and so takes longer than a design that spreads
//     one cloud over the whole card (ROADMAP, K13).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPoints = 4096;
constexpr int kMaxCluster = 16;
constexpr float kEps = 1e-9f;
constexpr int kLevels = 10;

// Row-pass modes: the first (only the next level's K' remainR, for level 0),
// a level whose next level lies 4x closer to 0 (K = K'^4), the level -0.25
// (its own exponential; K' = 1), and the level 0 (K = 1, no next level).
enum RowMode { kFirst, kNextExp, kLastExp, kZero };

__device__ __forceinline__ float sqdist(float4 a, float4 b) {
  const float d0 = __fsub_rn(a.x, b.x), d1 = __fsub_rn(a.y, b.y), d2 = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// -4^(7 - j) for j < 9, then 0 (exact powers of two)
__device__ __forceinline__ float level(int j) { return j >= kLevels - 1 ? 0.f : -ldexpf(1.f, 2 * (7 - j)); }

template <int kSplit>
__device__ __forceinline__ float split_sum(float v) {
#pragma unroll
  for (int off = kSplit / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Cloud {
  float4* xs;   // (N) shared: x, y, z, ratioL
  float4* ys;   // (M) shared: y0, y1, y2, ratioR
  float* rrs;   // (M) shared: remainR
  int n, m;
  int row0, rows, col0, cols;  // this CTA's slices
  const float* x;             // this cloud's (N, 3)
  const float* y;             // (M, 3)
  float* g1;                  // (N, 3)
  float* g2;                  // (M, 3)
  float* remain_l;            // (N)
  float* cost_row;            // (N)
  float mult_l;
};

// Write v into element i of `base` (a shared array) in every CTA of the
// cluster, this one included.
template <typename T>
__device__ __forceinline__ void to_all(cg::cluster_group& cluster, T* base, int i, T v) {
  const int s = (int)cluster.num_blocks();
  for (int r = 0; r < s; ++r) cluster.map_shared_rank(base, r)[i] = v;
}
__device__ __forceinline__ void w_to_all(cg::cluster_group& cluster, float4* base, int i, float v) {
  const int s = (int)cluster.num_blocks();
  for (int r = 0; r < s; ++r) cluster.map_shared_rank(base, r)[i].w = v;
}

// exp(lv d2) as ex2.approx.ftz of lv2 d2, lv2 = lv log2(e)
__device__ __forceinline__ float exp_of(float lv2, float d2) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(lv2 * d2));
  return r;
}

// kRows rows of kSplit threads each a thread group; row i of iteration it
// is row (it * kRows + i) * kGroups + g of this CTA's slice.
template <int kThreads, int kSplit, int kRows, int kMode>
__device__ __forceinline__ void row_pass(cg::cluster_group& cluster, const Cloud& c, float lv, float lvn) {
  constexpr int kGroups = kThreads / kSplit;
  constexpr bool kHasNext = kMode != kZero;
  const int g = threadIdx.x / kSplit, lane = threadIdx.x % kSplit;
  const int iters = (c.rows + kGroups * kRows - 1) / (kGroups * kRows);  // uniform: whole warps shuffle
  const float lv2 = lv * 1.4426950408889634f, lvn2 = lvn * 1.4426950408889634f;
  for (int it = 0; it < iters; ++it) {
    int n[kRows];
    bool valid[kRows];
    float4 p[kRows];
    float remain[kRows], cost[kRows], h0[kRows], h1[kRows], h2[kRows];
    float sk[kRows], skc[kRows], skic[kRows], sy0[kRows], sy1[kRows], sy2[kRows], ka[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (it * kRows + i) * kGroups + g;
      valid[i] = r < c.rows;
      n[i] = c.row0 + (valid[i] ? r : 0);
      p[i] = c.xs[n[i]];
      remain[i] = cost[i] = h0[i] = h1[i] = h2[i] = 0.f;
      if (kMode != kFirst && valid[i] && lane == 0) {  // the owner's state, loaded before the sweep
        remain[i] = c.remain_l[n[i]];
        cost[i] = c.cost_row[n[i]];
        h0[i] = c.g1[n[i] * 3];
        h1[i] = c.g1[n[i] * 3 + 1];
        h2[i] = c.g1[n[i] * 3 + 2];
      }
      sk[i] = skc[i] = skic[i] = sy0[i] = sy1[i] = sy2[i] = ka[i] = 0.f;
    }
#pragma unroll 2
    for (int m = lane; m < c.m; m += kSplit) {
      const float4 q = c.ys[m];
      const float rr = kHasNext ? c.rrs[m] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float d2 = sqdist(p[i], q);
        if constexpr (kMode == kFirst) {
          ka[i] += exp_of(lvn2, d2) * rr;
        } else {
          float k = 1.f;
          if constexpr (kMode == kNextExp) {
            const float e = exp_of(lvn2, d2);
            ka[i] += e * rr;
            const float e2 = __fmul_rn(e, e);
            k = __fmul_rn(e2, e2);
          } else if constexpr (kMode == kLastExp) {
            k = exp_of(lv2, d2);
            ka[i] += rr;
          }
          const float kr = k * q.w;
          const float dm = fmaxf(d2, 1e-20f);
          const float ic = rsqrt_approx(dm);
          const float cc = __fmul_rn(dm, ic);
          const float krc = kr * ic;
          sk[i] += kr;
          skc[i] += kr * cc;
          skic[i] += krc;
          sy0[i] += krc * q.x;
          sy1[i] += krc * q.y;
          sy2[i] += krc * q.z;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if constexpr (kHasNext) ka[i] = split_sum<kSplit>(ka[i]);
      if constexpr (kMode != kFirst) {
        sk[i] = split_sum<kSplit>(sk[i]);
        skc[i] = split_sum<kSplit>(skc[i]);
        skic[i] = split_sum<kSplit>(skic[i]);
        sy0[i] = split_sum<kSplit>(sy0[i]);
        sy1[i] = split_sum<kSplit>(sy1[i]);
        sy2[i] = split_sum<kSplit>(sy2[i]);
      }
      if (!valid[i] || lane != 0) continue;
      const int row = n[i];
      float rem = remain[i];
      if constexpr (kMode == kFirst) {
        rem = c.mult_l;
        c.cost_row[row] = 0.f;
        c.g1[row * 3] = c.g1[row * 3 + 1] = c.g1[row * 3 + 2] = 0.f;
      } else {
        const float rl = p[i].w;
        c.cost_row[row] = cost[i] + rl * skc[i];
        const float rs = rl * skic[i];
        c.g1[row * 3] = h0[i] + (p[i].x * rs - rl * sy0[i]);
        c.g1[row * 3 + 1] = h1[i] + (p[i].y * rs - rl * sy1[i]);
        c.g1[row * 3 + 2] = h2[i] + (p[i].z * rs - rl * sy2[i]);
        rem = fmaxf(rem - rl * sk[i], 0.f);
      }
      c.remain_l[row] = rem;
      if constexpr (kHasNext) w_to_all(cluster, c.xs, row, rem / (ka[i] + kEps));
    }
  }
}

// kRows columns of kSplit threads each a thread group, as the row pass.
template <int kThreads, int kSplit, int kRows, bool kExp>
__device__ __forceinline__ void col_pass(cg::cluster_group& cluster, const Cloud& c, float lv, bool first) {
  constexpr int kGroups = kThreads / kSplit;
  const int g = threadIdx.x / kSplit, lane = threadIdx.x % kSplit;
  const int iters = (c.cols + kGroups * kRows - 1) / (kGroups * kRows);
  const float lv2 = lv * 1.4426950408889634f;
  for (int it = 0; it < iters; ++it) {
    int m[kRows];
    bool valid[kRows];
    float4 q[kRows];
    float rem[kRows], h0[kRows], h1[kRows], h2[kRows];
    float s[kRows], sc[kRows], sx0[kRows], sx1[kRows], sx2[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (it * kRows + i) * kGroups + g;
      valid[i] = r < c.cols;
      m[i] = c.col0 + (valid[i] ? r : 0);
      q[i] = c.ys[m[i]];
      rem[i] = c.rrs[m[i]];
      h0[i] = h1[i] = h2[i] = 0.f;
      if (!first && valid[i] && lane == 0) {
        h0[i] = c.g2[m[i] * 3];
        h1[i] = c.g2[m[i] * 3 + 1];
        h2[i] = c.g2[m[i] * 3 + 2];
      }
      s[i] = sc[i] = sx0[i] = sx1[i] = sx2[i] = 0.f;
    }
#pragma unroll 2
    for (int n = lane; n < c.n; n += kSplit) {
      const float4 p = c.xs[n];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float d2 = sqdist(p, q[i]);  // x - y, as in the row pass: the same d^2 bits
        const float kl = (kExp ? exp_of(lv2, d2) : 1.f) * p.w;
        const float ic = rsqrt_approx(fmaxf(d2, 1e-20f));
        const float klc = kl * ic;
        s[i] += kl;
        sc[i] += klc;
        sx0[i] += klc * p.x;
        sx1[i] += klc * p.y;
        sx2[i] += klc * p.z;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = split_sum<kSplit>(s[i]);
      sc[i] = split_sum<kSplit>(sc[i]);
      sx0[i] = split_sum<kSplit>(sx0[i]);
      sx1[i] = split_sum<kSplit>(sx1[i]);
      sx2[i] = split_sum<kSplit>(sx2[i]);
      if (!valid[i] || lane != 0) continue;
      const int col = m[i];
      const float sumr = rem[i] * s[i];
      const float ratio_r = fminf(rem[i] / (sumr + kEps), 1.0f) * rem[i];
      const float cs = ratio_r * sc[i];
      c.g2[col * 3] = h0[i] + (q[i].x * cs - ratio_r * sx0[i]);
      c.g2[col * 3 + 1] = h1[i] + (q[i].y * cs - ratio_r * sx1[i]);
      c.g2[col * 3 + 2] = h2[i] + (q[i].z * cs - ratio_r * sx2[i]);
      w_to_all(cluster, c.ys, col, ratio_r);
      to_all(cluster, c.rrs, col, fmaxf(rem[i] - sumr, 0.f));
    }
  }
}

size_t smem_bytes(int kThreads, int n, int m) {
  return (size_t)(n + m) * sizeof(float4) + (size_t)m * sizeof(float) + (kMaxCluster + kThreads) * sizeof(float);
}

template <int kThreads, int kSplit, int kRows, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    emd_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ cost,
                       float* __restrict__ g1, float* __restrict__ g2, float* __restrict__ scratch, int n_x, int n_y,
                       float mult_l, float mult_r) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cloud = blockIdx.x / s;
  Cloud c;
  c.xs = smem;
  c.ys = smem + n_x;
  c.rrs = reinterpret_cast<float*>(smem + n_x + n_y);
  float* partials = c.rrs + n_y;      // (kMaxCluster): the cost's partials, read in rank 0
  float* tree = partials + kMaxCluster;  // (kThreads)
  c.n = n_x;
  c.m = n_y;
  const int rpc = (n_x + s - 1) / s, cpc = (n_y + s - 1) / s;
  c.row0 = min(n_x, rank * rpc);
  c.rows = min(n_x - c.row0, rpc);
  c.col0 = min(n_y, rank * cpc);
  c.cols = min(n_y - c.col0, cpc);
  c.x = x + (size_t)cloud * n_x * 3;
  c.y = y + (size_t)cloud * n_y * 3;
  c.g1 = g1 + (size_t)cloud * n_x * 3;
  c.g2 = g2 + (size_t)cloud * n_y * 3;
  c.remain_l = scratch + (size_t)cloud * n_x * 2;
  c.cost_row = c.remain_l + n_x;
  c.mult_l = mult_l;

  for (int i = threadIdx.x; i < n_x; i += kThreads)
    c.xs[i] = make_float4(c.x[i * 3], c.x[i * 3 + 1], c.x[i * 3 + 2], 0.f);
  for (int i = threadIdx.x; i < n_y; i += kThreads) {
    c.ys[i] = make_float4(c.y[i * 3], c.y[i * 3 + 1], c.y[i * 3 + 2], 0.f);
    c.rrs[i] = mult_r;
  }
  cluster.sync();  // every CTA of the cluster running and loaded before any remote write

  row_pass<kThreads, kSplit, kRows, kFirst>(cluster, c, 0.f, level(0));
  cluster.sync();
  for (int j = 0; j < kLevels; ++j) {
    const float lv = level(j);
    if (j < kLevels - 1) col_pass<kThreads, kSplit, kRows, true>(cluster, c, lv, j == 0);
    else col_pass<kThreads, kSplit, kRows, false>(cluster, c, lv, false);
    cluster.sync();
    if (j < kLevels - 2) {
      row_pass<kThreads, kSplit, kRows, kNextExp>(cluster, c, lv, level(j + 1));
      cluster.sync();
    } else if (j == kLevels - 2) {
      row_pass<kThreads, kSplit, kRows, kLastExp>(cluster, c, lv, 0.f);
      cluster.sync();
    } else {
      row_pass<kThreads, kSplit, kRows, kZero>(cluster, c, lv, 0.f);
    }
  }

  // the cost: this CTA's rows in a fixed order, then the partials in rank order
  __syncthreads();  // the last row pass's cost_row writes, visible to the block
  float part = 0.f;
  for (int r = threadIdx.x; r < c.rows; r += kThreads) part += c.cost_row[c.row0 + r];
  tree[threadIdx.x] = part;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) tree[threadIdx.x] += tree[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cluster.map_shared_rank(partials, 0)[rank] = tree[0];
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < s; ++r) total += partials[r];
    cost[cloud] = total;
  }
}

using KernelFn = void (*)(const float*, const float*, float*, float*, float*, float*, int, int, float, float);

struct Variant {
  KernelFn fn;
  int threads;
};

// The instances (threads, threads a row or column, rows or columns a
// thread group, CTAs an SM that ptxas must fit). `plan` picks kV64, kV128
// or kV256 by the rows a CTA owns (the best of a sweep of 15 instances at
// 64, 128 and 256 rows a CTA on an H100).
const Variant kVariants[] = {
    {emd_cluster_kernel<128, 4, 2, 4>, 128},
    {emd_cluster_kernel<256, 4, 2, 2>, 256},
    {emd_cluster_kernel<512, 4, 2, 1>, 512},
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kV64 = 0, kV128 = 1, kV256 = 2;
constexpr int kRowsTarget = 64;  // rows (and columns) a CTA owns where the cluster allows

// A launch of `grid` CTAs of instance `var` in clusters of `s`, with `smem`
// bytes of dynamic shared memory (`attr` holds the cluster's dimension).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  ClusterLaunch(const Variant& var, int s, unsigned grid, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(var.threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = s;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of `s` CTAs of `var` the card runs at once (0 if none).
int active_clusters(const Variant& var, int s, size_t smem) {
  ClusterLaunch launch(var, s, s, smem, nullptr);
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, var.fn, &launch.cfg) != cudaSuccess) {
    cudaGetLastError();  // clear a refusal
    return 0;
  }
  return active;
}

// The largest cluster (16, 8, 4, 2 or 1) the card holds for instance v with
// the gate's largest shared memory; attributes set once an instance.
int cluster_limit(int v) {
  static int limit[kNumVariants] = {0};
  if (limit[v] > 0) return limit[v];
  const Variant& var = kVariants[v];
  const size_t smem = smem_bytes(var.threads, kMaxPoints, kMaxPoints);
  if (cudaFuncSetAttribute(var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaFuncSetAttribute(var.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess) {
    return 0;
  }
  int s = kMaxCluster;
  while (s > 1 && active_clusters(var, s, smem) == 0) s /= 2;
  limit[v] = s;
  return s;
}

// The cluster: the smallest power of two (up to `limit`) that leaves a CTA
// at most kRowsTarget of the larger cloud's points, whatever B (many small
// CTAs, several an SM, hide the sweeps' latencies better than one large CTA
// an SM); the instance by the rows a CTA then owns.
void plan(int n_x, int n_y, int limit, int* cluster, int* variant) {
  const int n = n_x > n_y ? n_x : n_y;
  int s = 1;
  while (s < limit && (n + s - 1) / s > kRowsTarget) s *= 2;
  const int rows = (n + s - 1) / s;
  *cluster = s;
  *variant = rows <= 64 ? kV64 : rows <= 128 ? kV128 : kV256;
}

// The largest cluster the card holds (the least over the instances).
int emd_cluster_limit() {
  int limit = kMaxCluster;
  for (int v = 0; v < kNumVariants; ++v) limit = cluster_limit(v) < limit ? cluster_limit(v) : limit;
  return limit;
}

}  // namespace

// The plan of an (N, M) call on this card: cluster_size * 100 + instance
// (0, 1, 2: up to 64, 128, 256 rows a CTA), or -1 where no cluster fits.
extern "C" int emd_plan(int n_x, int n_y) {
  const int limit = emd_cluster_limit();
  if (limit <= 0) return -1;
  int s, v;
  plan(n_x, n_y, limit, &s, &v);
  return s * 100 + v;
}

// C entry, bound with ctypes: x (B, N, 3), y (B, M, 3) f32, cost (B,),
// g1 (B, N, 3), g2 (B, M, 3) f32 and scratch (B * 2N f32) are device
// pointers to contiguous tensors; 1 <= N, M <= 4096. mult_l, mult_r: the
// rows' and columns' starting mass. One launch of `plan`'s instance in
// `plan`'s clusters. Returns the launch's CUDA error code (0 on success).
extern "C" int emd_fwd(const float* x, const float* y, float* cost, float* g1, float* g2, float* scratch, int batch,
                       int n_x, int n_y, float mult_l, float mult_r, void* stream) {
  if (batch <= 0 || n_x < 1 || n_y < 1 || n_x > kMaxPoints || n_y > kMaxPoints) return (int)cudaErrorInvalidValue;
  const int limit = emd_cluster_limit();
  if (limit == 0) return (int)cudaGetLastError();
  int s, v;
  plan(n_x, n_y, limit, &s, &v);
  const Variant& var = kVariants[v];
  if ((long long)batch * s > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ClusterLaunch launch(var, s, (unsigned)(batch * s), smem_bytes(var.threads, n_x, n_y),
                       static_cast<cudaStream_t>(stream));
  const cudaError_t err =
      cudaLaunchKernelEx(&launch.cfg, var.fn, x, y, cost, g1, g2, scratch, n_x, n_y, mult_l, mult_r);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
