// The neighbor selection of K5 (dgcnn_fused.cu), K7 (knn_neighbors, the
// edge features of the unfused DGCNN path) and K9 (dgcnn_int8.cu), one
// source for all three: the k nearest neighbors of every point of a cloud,
// and approx kNN's per-tile key scales. K5's and K9's C entries call
// dgcnn_select (dgcnn_select.cuh) on the host, so the selection is its own
// launch before their chains; K7's C entry, knn_neighbors, runs the same
// selection and writes the edge features from its epilogue, one launch.
//
// K7 replaces the TPU kernel learning3d_tpu/kernels/edgeconv.py::
// knn_neighbors_pallas (body `_edge_kernel`): x (B, N, 3) f32 in, out (B,
// N, k, 6) f32, the edge features concat(neighbor xyz, center xyz), the
// point itself included. The coordinates are copied, so they are exact: the
// TPU kernel gathers them by a one-hot product on its matrix unit through a
// bf16 hi/lo split, accurate to about 1e-5 relative on the chip. K7's plain
// version is `edge_features_reference` (kernels/edgeconv.py).
//
// Same math as the plain versions' selection (`exact_knn`, `knn_indices`):
// squared distances as exact per-coordinate differences (d0*d0 + d1*d1) +
// d2*d2, written with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc cannot
// contract them into FMAs (a contraction changes the rounding, a near-tied
// neighbor swaps, and a whole output row moves); neighbors nearest first,
// ties to the smaller index.
//
// Bound (K7 at the DCP shape, B=32, N=1024, k=20): B N^2 distances of 8 f32
// instructions and at least one comparison each, 0.30 G instructions, 9 us
// at one f32 instruction a lane and clock (132 SMs x 128 lanes x 1.98 GHz);
// x read (0.4 MB) and the edge tensor written (15.7 MB) once, 4.8 us at
// 3.35 TB/s. Bound by the instructions.
//
// Design (first written for K9): 64 query rows a block of one warpgroup, each
// warp 16 rows, four at a time, with 64-bit (high half: distance bits or
// approximate key; low half: index) keys. A warp-wide operation (shuffle,
// ballot) costs many ALU latencies, so a row's keys meet few of them: pass 1
// keeps each lane's L / 32 smallest high halves (ALU only), and the k-th
// smallest of the warp's L (one sort across the warp) bounds the high half
// of the row's k-th key from above; pass 2 appends the keys within the bound
// (a ballot a chunk of 32) to the row's buffer, and every 32 of them are
// sorted and merged into the row's list of L keys (warp_select.cuh), whose
// k-th key then tightens the bound. L is 32 for k <= 32 (K5, K9 and K7 up to
// there) and 64 for 32 < k <= 64 (K7): two keys a lane, the merge of a
// batch into the list of 64 the lower half of a merge with its upper 32 and
// a full merge with its lower 32. At the DCP shape (N = 1024, k = 20) a row
// meets a few tens of keys within the bound: one or two merges. The four
// rows' shuffles interleave. Few registers and ~33 KB of shared memory at N
// = 1024, so ~6 blocks an SM hide the warp-wide operations' latency. The
// grid is one-dimensional, B x ceil(N / 64) blocks (B is not bounded by a
// grid's y extent). Rows past N are not selected (K5's and K9's chains give
// them neighbor 0, compute them and do not write them; K7 writes nothing
// for them).
//
// Shared memory: the cloud's coordinates (12 N bytes) and the warps'
// survivor buffers (20 KB), align16(12 N) + 20480 bytes: 32.8 KB at N =
// 1024 (six blocks an SM), 69.6 KB at N = 4096 (three), 217.1 KB at N =
// 16384, K7's limit (one block of the SM's 227 KB).
//
// K7's epilogue: a warp's four rows' picks go to its survivor buffer (empty
// after the last merge), and the warp writes the rows' k * 6 floats, one
// contiguous run of 4 * 24 k bytes, with consecutive lanes on consecutive
// floats: the neighbor's xyz copied from the shared coordinates by its
// index, the center's beside them. The (B, N, k) indices never reach
// device memory.
//
// Approximate kNN (the TPU kernel's `approx_knn`, K5 and K9 only): the high
// word of the key is int(trunc(d * scale)) instead of d's bits, scale =
// f32(levels) / max(maxd, 1e-20), levels = 2^(30 - bitlen(Np - 1)) - 1, so
// that near ties inside one distance bucket go to the smaller index. maxd
// is the largest distance over the TPU kernel's whole query tile (tile_n =
// min(256, round_up(N, 128)) rows, zero-padded rows included, Np =
// round_up(N, tile_n)) and the valid columns: a pre-pass,
// `knn_tile_scale_kernel`, takes it per (cloud, tile). Ordering by (bucket,
// index) is ordering by the TPU kernel's int32 key bucket * Np + col, so the
// same selection picks the same neighbors.

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
constexpr int kMaxSelectN = 16384;  // K7's limit: the coordinates and buffers fill one block's shared memory
constexpr int kMaxK = 64;
constexpr int kMaxScaleN = 4096;  // approx kNN (K5's and K9's limit)
constexpr int kMaxDevices = 64;
constexpr int kScaleThreads = 256;  // the key-scale pre-pass
constexpr int kScaleWarps = kScaleThreads / 32;

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// The k nearest neighbors of 64 query rows a block, from a list of L = 32
// (k <= 32) or 64 (k <= 64) keys a row: into idx (B, N, k) int32 (K5, K9;
// edges null) or as the edge features into edges (B, N, k, 6) f32 (K7).
// Shared memory: the cloud's coordinates (12 N bytes), the warps' survivor
// buffers.
template <int L>
__global__ void __launch_bounds__(kThreads) dgcnn_select_kernel(const float* __restrict__ x,
                                                                const float* __restrict__ knn_scale,
                                                                int* __restrict__ idx, float* __restrict__ edges,
                                                                int n_pts, int k, int tile_n) {
  static_assert(L == 32 || L == 64, "a list of 32 or 64 keys");
  constexpr int kLanes = L / 32;  // keys a lane holds
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles_q = (n_pts + kRows - 1) / kRows;
  const int cloud = blockIdx.x / tiles_q;
  const int q0 = (blockIdx.x - cloud * tiles_q) * kRows;
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
    // pass 1: each lane's kLanes smallest high halves; the k-th smallest of
    // the warp's L (k distinct points) bounds the high half of the row's
    // k-th key from above (inclusive: keys that tie on it go to the smaller
    // index)
    u32 bound[kGroup], second[kGroup];
    u64 lst[kGroup], lst_hi[kGroup];  // the row's list: positions lane and (L = 64) 32 + lane
    int cnt[kGroup];
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) bound[rr] = second[rr] = 0xffffffffu;
    for (int i = lane; i < n_pts; i += 32) {
      const float x = px[i], y = py[i], z = pz[i];
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const u32 h = hi_of(rr, x, y, z);
        if constexpr (kLanes == 2) second[rr] = min(second[rr], max(bound[rr], h));
        bound[rr] = min(bound[rr], h);
      }
    }
    sort32_rows<kGroup>(bound, lane);
    if constexpr (kLanes == 2) {
      sort32_rows<kGroup>(second, lane);
      merge64_rows<kGroup>(bound, second, lane);
    }
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      bound[rr] = kLanes == 2 ? __shfl_sync(kFull, second[rr], k - 33) : __shfl_sync(kFull, bound[rr], k - 1);
      lst[rr] = lst_hi[rr] = kNone;
      cnt[rr] = 0;
    }
    // up to 32 survivors of every row sorted and merged into its list (the
    // row's smallest keys), the rest moved to the front; the list's k-th
    // key tightens the bound
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
      if constexpr (kLanes == 2) {
        merge64_batch_rows<kGroup>(lst, lst_hi, c, lane);
#pragma unroll
        for (int rr = 0; rr < kGroup; ++rr)
          bound[rr] = min(bound[rr], static_cast<u32>(__shfl_sync(kFull, lst_hi[rr], k - 33) >> 32));
      } else {
        merge32_rows<kGroup>(lst, c, lane);
#pragma unroll
        for (int rr = 0; rr < kGroup; ++rr)
          bound[rr] = min(bound[rr], static_cast<u32>(__shfl_sync(kFull, lst[rr], k - 1) >> 32));
      }
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
    // the picks: position j of the list, the row itself where no key is
    // left (N >= k rules that out)
    auto pick = [&](u64 key, int q) { return key == kNone ? q : static_cast<int>(key & 0xffffffffu); };
    if (edges == nullptr) {
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) {
        const int q = q0 + r0 + rr;
        if (live[rr] && lane < k) idx[((size_t)cloud * n_pts + q) * k + lane] = pick(lst[rr], q);
      }
      continue;
    }
    // K7: the four rows' picks into the (empty) buffer, then their k * 6
    // floats written as one run, consecutive lanes on consecutive floats
    int* picks = reinterpret_cast<int*>(buf);  // [kGroup][kMaxK]
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      const int q = q0 + r0 + rr;
      picks[rr * kMaxK + lane] = pick(lst[rr], q);
      if constexpr (kLanes == 2) picks[rr * kMaxK + 32 + lane] = pick(lst_hi[rr], q);
    }
    __syncwarp();
    const int row0 = q0 + r0, per_row = 6 * k;
    float* out = edges + ((size_t)cloud * n_pts + row0) * per_row;
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr) {
      if (!live[rr]) break;
      for (int t = lane; t < per_row; t += 32) {
        const int jj = t / 6, c = t - 6 * jj;
        const int p = c < 3 ? picks[rr * kMaxK + jj] : row0 + rr;
        out[rr * per_row + t] = px[(c < 3 ? c : c - 3) * n_pts + p];
      }
    }
    __syncwarp();  // the buffer is the next group's
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
  if (batch <= 0 || n_pts <= 0 || n_pts > kMaxScaleN || tile_n <= 0) return (int)cudaErrorInvalidValue;
  const int bytes = 12 * n_pts;
  if (bytes + 4 * kScaleWarps > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_tile_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 12 * kMaxScaleN);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_pts + tile_n - 1) / tile_n, batch);
  knn_tile_scale_kernel<<<grid, kScaleThreads, bytes, static_cast<cudaStream_t>(stream)>>>(x, scale, n_pts,
                                                                                          tile_n, levels);
  return (int)cudaGetLastError();
}

namespace {

// One launch of the selection: the L = 32 instance up to k = 32, the L =
// 64 one past it; idx or edges written (the other null). The shared-memory
// limit (the largest N's) is set once a device.
int launch_select(const float* x, const float* knn_scale, int* idx, float* edges, int batch, int n_pts, int k,
                  int tile_n, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(dgcnn_select_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               select_smem_bytes(kMaxSelectN));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dgcnn_select_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 select_smem_bytes(kMaxSelectN));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const long long blocks = (long long)batch * ((n_pts + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = select_smem_bytes(n_pts);
  if (k <= 32)
    dgcnn_select_kernel<32><<<(unsigned)blocks, kThreads, bytes, stream>>>(x, knn_scale, idx, edges, n_pts, k, tile_n);
  else
    dgcnn_select_kernel<64><<<(unsigned)blocks, kThreads, bytes, stream>>>(x, knn_scale, idx, edges, n_pts, k, tile_n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry (dgcnn_select.cuh), called by the C entries of K5 and K9.
extern "C" int dgcnn_select(const float* x, const float* knn_scale, int* idx, int batch, int n_pts, int k,
                            int tile_n, void* stream) {
  return launch_select(x, knn_scale, idx, nullptr, batch, n_pts, k, tile_n, static_cast<cudaStream_t>(stream));
}

// C entry of K7, bound with ctypes. x (B, N, 3) f32 and out (B, N, k, 6) f32
// are device pointers to contiguous tensors. Needs 1 <= k <= 64 and k <= N
// <= 16384. One launch; returns its CUDA error code (0 on success).
extern "C" int knn_neighbors(const float* x, float* out, int batch, int n_pts, int k, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxSelectN) return (int)cudaErrorInvalidValue;
  return launch_select(x, nullptr, nullptr, out, batch, n_pts, k, 1, static_cast<cudaStream_t>(stream));
}
