// The neighbor selection of K5 (dgcnn_fused.cu) and K9 (dgcnn_int8.cu), one
// source for both: the k nearest neighbors of every point of a cloud, and
// approx kNN's per-tile key scales. Each chain's C entry calls dgcnn_select
// (dgcnn_select.cuh) on the host, so the selection is its own launch before
// the chain.
//
// Same math as the plain version's `knn_indices`: squared distances as
// exact per-coordinate differences (d0*d0 + d1*d1) + d2*d2, written with
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into FMAs (a
// contraction changes the rounding, a near-tied neighbor swaps, and a whole
// output row moves); neighbors nearest first, ties to the smaller index.
//
// Design (first written for K9): 64 query rows a block of one warpgroup, each
// warp 16 rows, four at a time, with 64-bit (high half: distance bits or
// approximate key; low half: index) keys. A warp-wide operation (shuffle,
// ballot) costs many ALU latencies, so a row's keys meet few of them: pass 1
// keeps each lane's smallest high half (ALU only), and the k-th smallest of
// the 32 lanes' (one sort across the warp) bounds the high half of the row's
// k-th key from above; pass 2 appends the keys within the bound (a ballot a
// chunk of 32) to the row's buffer, and every 32 of them are sorted and
// merged into the row's list (warp_select.cuh), whose k-th key then
// tightens the bound. At the DCP shape (N = 1024, k = 20) a row meets a few
// tens of keys within the bound: one or two merges. The four rows' shuffles
// interleave. Few registers and ~33 KB of shared memory at N = 1024, so ~6
// blocks an SM hide the warp-wide operations' latency. Rows past N are not
// selected (the chains give them neighbor 0, compute them and do not write
// them).
//
// Approximate kNN (the TPU kernel's `approx_knn`): the high word of the key
// is int(trunc(d * scale)) instead of d's bits, scale = f32(levels) /
// max(maxd, 1e-20), levels = 2^(30 - bitlen(Np - 1)) - 1, so that near ties
// inside one distance bucket go to the smaller index. maxd is the largest
// distance over the TPU kernel's whole query tile (tile_n = min(256,
// round_up(N, 128)) rows, zero-padded rows included, Np = round_up(N,
// tile_n)) and the valid columns: a pre-pass, `knn_tile_scale_kernel`,
// takes it per (cloud, tile). Ordering by (bucket, index) is ordering by the
// TPU kernel's int32 key bucket * Np + col, so the same selection picks the
// same neighbors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dgcnn_select.cuh"
#include "warp_select.cuh"

namespace {

using namespace warp_select;

constexpr int kRows = 64;  // query rows a block
constexpr int kThreads = 128;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kGroup = 4;  // rows a warp selects together
constexpr int kBuf = 160;  // a row's survivors between flushes: < 32 left and four chunks of 32
constexpr int kMaxN = 4096;
constexpr int kMaxDevices = 64;
constexpr int kScaleThreads = 256;  // the key-scale pre-pass
constexpr int kScaleWarps = kScaleThreads / 32;

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// The k nearest neighbors of 64 query rows a block into idx (B, N, k) int32.
// Shared memory: the cloud's coordinates (12 N bytes), the warps' survivor
// buffers.
__global__ void __launch_bounds__(kThreads) dgcnn_select_kernel(const float* __restrict__ x,
                                                                const float* __restrict__ knn_scale,
                                                                int* __restrict__ idx, int n_pts, int k, int tile_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* xc = x + (size_t)cloud * n_pts * 3;
  float* px = reinterpret_cast<float*>(smem);
  float* py = px + n_pts;
  float* pz = py + n_pts;
  u64* buf = reinterpret_cast<u64*>(smem + align16(12 * n_pts)) + warp * kGroup * kBuf;  // this warp's rows' survivors
  for (int i = tid; i < n_pts * 3; i += kThreads) {
    const int p = i / 3, d = i - 3 * p;
    (d == 0 ? px : d == 1 ? py : pz)[p] = xc[i];
  }
  __syncthreads();
  const int tiles = (n_pts + tile_n - 1) / tile_n;
  const u32 below = (1u << lane) - 1u;
  for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += kGroup) {
    float qx[kGroup], qy[kGroup], qz[kGroup], ks[kGroup];
    bool live[kGroup];
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      const int q = q0 + r0 + rr, qi = q < n_pts ? q : 0;
      live[rr] = q < n_pts;
      qx[rr] = px[qi];
      qy[rr] = py[qi];
      qz[rr] = pz[qi];
      ks[rr] = knn_scale == nullptr ? 0.f : knn_scale[(size_t)cloud * tiles + qi / tile_n];
    }
    // the high half of row rr's key of a point at (x, y, z): the distance
    // bits, or the approximate key (both order as the distances)
    auto hi_of = [&](int rr, float x, float y, float z) -> u32 {
      const float d0 = __fsub_rn(qx[rr], x), d1 = __fsub_rn(qy[rr], y), d2 = __fsub_rn(qz[rr], z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      return ks[rr] > 0.f ? static_cast<u32>(__float2int_rz(__fmul_rn(d, ks[rr]))) : __float_as_uint(d);
    };
    // pass 1: each lane's smallest high half; the k-th smallest of the 32
    // lanes' (k distinct points) bounds the high half of the row's k-th key
    // from above (inclusive: keys that tie on it go to the smaller index)
    u32 bound[kGroup];
    u64 lst[kGroup];
    int cnt[kGroup];
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) bound[rr] = 0xffffffffu;
    for (int i = lane; i < n_pts; i += 32) {
      const float x = px[i], y = py[i], z = pz[i];
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) bound[rr] = min(bound[rr], hi_of(rr, x, y, z));
    }
    sort32_rows<kGroup>(bound, lane);
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      bound[rr] = __shfl_sync(kFull, bound[rr], k - 1);
      lst[rr] = kNone;
      cnt[rr] = 0;
    }
    // up to 32 survivors of every row sorted and merged into its list (the
    // row's smallest keys, lane j the j-th), the rest moved to the front;
    // the list's k-th key tightens the bound
    auto flush = [&]() {
      __syncwarp();
      u64 c[kGroup];
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) c[rr] = lane < cnt[rr] ? buf[rr * kBuf + lane] : kNone;
      __syncwarp();
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        for (int b = lane; b < cnt[rr] - 32; b += 32) buf[rr * kBuf + b] = buf[rr * kBuf + 32 + b];
        cnt[rr] = max(cnt[rr] - 32, 0);
      }
      sort32_rows<kGroup>(c, lane);
      merge32_rows<kGroup>(lst, c, lane);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr)
        bound[rr] = min(bound[rr], static_cast<u32>(__shfl_sync(kFull, lst[rr], k - 1) >> 32));
    };
    auto most = [&]() {
      int m = 0;
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) m = max(m, cnt[rr]);
      return m;
    };
    // pass 2: the keys within the bound, four chunks of 32 between flushes
    for (int p0 = 0; p0 < n_pts; p0 += 128) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const int i = p0 + 32 * ch + lane;
        const bool ok = i < n_pts;
        const float x = ok ? px[i] : 0.f, y = ok ? py[i] : 0.f, z = ok ? pz[i] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kGroup; ++rr) {
          const u32 hi = hi_of(rr, x, y, z);
          const bool in = ok && live[rr] && hi <= bound[rr];
          const u32 m = __ballot_sync(kFull, in);
          if (in) buf[rr * kBuf + cnt[rr] + __popc(m & below)] = (static_cast<u64>(hi) << 32) | static_cast<u32>(i);
          cnt[rr] += __popc(m);
        }
      }
      while (most() >= 32) flush();
    }
    while (most() > 0) flush();
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      const int q = q0 + r0 + rr;
      if (live[rr] && lane < k)
        idx[((size_t)cloud * n_pts + q) * k + lane] = lst[rr] == kNone ? q : static_cast<int>(lst[rr] & 0xffffffffu);
    }
  }
}

__host__ __device__ constexpr int select_smem_bytes(int n) { return align16(12 * n) + kWarps * kGroup * kBuf * 8; }

// Approx-kNN key scale of each (cloud, query tile): grid (tiles, B). maxd
// over the tile's rows (rows past N are the origin, as the TPU kernel pads
// them) and the N valid columns, then f32(levels) / max(maxd, 1e-20). A
// thread takes a row against the cloud, which the block holds in shared
// memory (12 N bytes; every thread reads the same column at once).
__global__ void __launch_bounds__(kScaleThreads) knn_tile_scale_kernel(const float* x, float* scale,
                                                                       int n_pts, int tile_n, float levels) {
  extern __shared__ float pts[];
  __shared__ float red[kScaleWarps];
  const float* xc = x + (size_t)blockIdx.y * n_pts * 3;
  for (int i = threadIdx.x; i < 3 * n_pts; i += kScaleThreads) pts[i] = xc[i];
  __syncthreads();
  float mx = 0.f;
  for (int r = blockIdx.x * tile_n + threadIdx.x; r < (blockIdx.x + 1) * tile_n; r += kScaleThreads) {
    float q[3] = {0.f, 0.f, 0.f};
    if (r < n_pts)
      for (int e = 0; e < 3; ++e) q[e] = pts[3 * r + e];
    for (int c = 0; c < n_pts; ++c) {
      const float d0 = __fsub_rn(q[0], pts[3 * c]), d1 = __fsub_rn(q[1], pts[3 * c + 1]),
                  d2 = __fsub_rn(q[2], pts[3 * c + 2]);
      mx = fmaxf(mx, __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScaleWarps; ++w) mx = fmaxf(mx, red[w]);
    scale[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = __fdiv_rn(levels, fmaxf(mx, 1e-20f));
  }
}

}  // namespace

// C entry of the approx-kNN pre-pass: x (B, N, 3) f32 -> scale (B, tiles) f32
// with tiles = ceil(N / tile_n) and levels = 2^(30 - bitlen(Np - 1)) - 1 as
// a float. Returns the CUDA error code of the launch (0 on success).
extern "C" int dgcnn_knn_scale(const float* x, float* scale, int batch, int n_pts, int tile_n, float levels,
                               void* stream) {
  if (batch <= 0 || n_pts <= 0 || n_pts > kMaxN || tile_n <= 0) return (int)cudaErrorInvalidValue;
  const int bytes = 12 * n_pts;
  if (bytes + 4 * kScaleWarps > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_tile_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 12 * kMaxN);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_pts + tile_n - 1) / tile_n, batch);
  knn_tile_scale_kernel<<<grid, kScaleThreads, bytes, static_cast<cudaStream_t>(stream)>>>(x, scale, n_pts,
                                                                                          tile_n, levels);
  return (int)cudaGetLastError();
}

// C entry (dgcnn_select.cuh), called by the C entries of K5 and K9.
extern "C" int dgcnn_select(const float* x, const float* knn_scale, int* idx, int batch, int n_pts, int k,
                            int tile_n, void* stream) {
  // the shared-memory limit (the largest N's), once a device
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(dgcnn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               select_smem_bytes(kMaxN));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const dim3 grid((n_pts + kRows - 1) / kRows, batch);
  dgcnn_select_kernel<<<grid, kThreads, select_smem_bytes(n_pts), static_cast<cudaStream_t>(stream)>>>(
      x, knn_scale, idx, n_pts, k, tile_n);
  return (int)cudaGetLastError();
}
