// Exact k-nearest-neighbour selection over xyz or over features of up to 256
// channels, for Hopper (sm_90a). queries (B, S, C) and points (B, N, C) f32
// in; for every query its k nearest points, nearest first, ties to the
// smaller index: dist (B, S, k) f32, the squared distance, and idx (B, S, k)
// int32.
//
// Replaces the TPU kernel learning3d_tpu/kernels/knn.py::knn_pallas (body
// `_knn_kernel`). Same math as the port's plain version `knn_reference`,
// every operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn, so
// that nvcc cannot contract a product and a sum into one FMA; a contraction
// rounds once where the plain version rounds twice, and a near-tied
// neighbour swaps):
// * C == 3: exact per-coordinate differences, (d0*d0 + d1*d1) + d2*d2;
// * C != 3: the expansion (|q|^2 - 2 q.p) + |p|^2, with |q|^2, |p|^2 and q.p
//   each summed one channel at a time in ascending channel order, in f32.
//   The TPU kernel takes the cross term from its matrix unit at full f32
//   (Precision.HIGHEST); no TF32 and no bf16 mma here, which would
//   mis-select as bf16 does on the TPU.
// A register tile changes which thread sums a pair, never the order of its
// sum, so the distances are bit for bit the plain version's.
//
// Bound. At PRNet's widest stage (B=16, S=N=1024, C=128) the cross term is
// 2 B S N C = 4.3 G f32 operations, 0.064 ms at the 67 TFLOP/s of f32 on
// the CUDA cores (an FMA counted as two). Bit-equality makes the product
// and the sum two instructions, so the kernel's own ceiling is half that
// rate, 0.129 ms. The inputs are 16.8 MB and the outputs 2.6 MB, 0.006 ms at
// 3.35 TB/s: the operations bound it. At C = 3, 9 operations a pair; there
// the selection, not the distances, is the work.
//
// Design. The TPU kernel holds a (tile, N) distance tile in VMEM and runs k
// rounds of (row min, first index of the min, mask). Here the points stream
// through shared memory and the selection is a running merge:
// * Grid B * ceil(S / 64), one dimension; 8 warps a block, two blocks an SM
//   (102 KB of shared memory and at most 128 registers a thread each), so
//   that one block's selection runs while the other's products do. A block
//   takes 64 query rows of one cloud and streams the cloud's points in
//   tiles of 128. At PRNet's B=16 and S=1024 (768) that is 256 (192) blocks:
//   every SM has work.
// * Channel chunks of 32 (one chunk of 3 + a zero at C == 3) of the block's
//   queries and of the tile's points are copied row-major into shared memory
//   with cp.async (16 bytes a copy where C % 4 == 0, else 4), two stages and
//   one barrier a chunk: the next chunk, or the next tile's first, is in
//   flight while the current one is multiplied and while the tile's rows
//   are selected. Rows
//   are padded to 36 floats: a warp's 16-byte reads of 8 points fall in 8
//   distinct bank quads.
// * Distances: a thread owns 4 query rows x 8 points (the points tx + 16 j)
//   of the (64, 128) tile; per 4 channels it reads 4 rows and 8 points as
//   float4 (12 shared loads) for 128 products and 128 sums, the channels in
//   ascending order. The first 128 threads also sum the tile's |p|^2; |q|^2
//   is summed once a block. Padding channels and missing points are zeros,
//   and acc + 0*0 is acc. Each distance goes to a (64, 132) u32 tile as
//   order-preserving bits: every bit of a negative value flipped, the sign
//   bit of a non-negative one set (-0 made +0 first). The expansion can make
//   a distance slightly negative (two near-equal feature vectors).
// * Selection: a warp owns 8 rows and keeps, per row, its running smallest
//   keys (64-bit: ordered bits, index) sorted across its lanes in registers
//   (lane l holds position l, and l + 32 in the k > 32 instance): key order
//   is (distance, index) order, so ties go to the smaller index by
//   construction. A row's 128 candidates of a tile are filtered against its
//   current k-th key in registers; the survivors (a ballot count, usually a
//   few) are compacted into a per-warp buffer and merged 32 at a time: up
//   to 8 by rank (each new key's place counted by ballots, the list rebuilt
//   through shared memory), more by a bitonic sort of the 32 across the
//   warp, the elementwise min of the list and the reversed batch (the lower
//   half of a bitonic merge), and a bitonic clean. No key is inserted one
//   at a time.
// * Any N >= k, any S, ragged edges masked in the kernel (rows past S load
//   zeros and write nothing; points past N are no candidates).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_select.cuh"

namespace {

using namespace warp_select;

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int kRows = 64;                // query rows a block
constexpr int kTile = 128;               // points a tile
constexpr int kChunk = 32;               // channels a chunk
constexpr int kLd = kChunk + 4;          // floats a staged row
constexpr int kDistLd = kTile + 4;       // u32 a distance row
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxK = 64;
constexpr int kMaxC = 256;
constexpr int kRankMax = 8;               // new keys a round merged by rank, not by sort
constexpr int kMaxDevices = 64;

struct Smem {
  float q[2][kRows * kLd];   // two stages of a query chunk, row-major
  float p[2][kTile * kLd];   // two stages of a point chunk, row-major
  u32 dist[kRows * kDistLd]; // the tile's distances as ordered bits
  u64 buf[kWarps][kTile];    // a warp's compacted survivors of one row
  u64 scratch[kWarps][64];   // a warp's list, rebuilt by rank_merge
  float qsq[kRows];
  float psq[kTile];
};

// An order-preserving map of f32 to u32 (-0 counted as +0).
__device__ __forceinline__ u32 order_bits(float d) {
  const u32 u = __float_as_uint(__fadd_rn(d, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(u32 o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<u32>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<u32>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Channels [c0, c0 + w4) of the block's query rows and of the tile's points
// into one stage; a copy past S, N or C reads nothing and writes zeros.
__device__ __forceinline__ void load_chunk(float* qs, float* ps, const float* qc, const float* pc, int q0, int p0,
                                           int n_q, int n_p, int c_dim, int c0, int w4, bool vec) {
  const int g4 = w4 >> 2;
  for (int i = threadIdx.x; i < (kRows + kTile) * g4; i += kThreads) {
    const int r = i / g4, g = i - r * g4;
    const bool is_q = r < kRows;
    const int row = is_q ? r : r - kRows;
    const int grow = (is_q ? q0 : p0) + row;
    const bool ok = grow < (is_q ? n_q : n_p);
    const float* src = (is_q ? qc : pc) + (size_t)(ok ? grow : 0) * c_dim + c0 + 4 * g;
    float* dst = (is_q ? qs : ps) + row * kLd + 4 * g;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ce = ok && c0 + 4 * g + e < c_dim;
        cp_async4(dst + e, ce ? src + e : qc, ce);
      }
    }
  }
}

// Bitonic sort of one key a lane, ascending across the warp.
__device__ __forceinline__ u64 sort32(u64 c, int lane) {
  u64 r[1] = {c};
  sort32_rows<1>(r, lane);
  return r[0];
}

// Merge a sorted batch `c` (one key a lane) into a warp's sorted list of 32
// (lo) or 64 (lo, hi: positions lane and lane + 32), keeping the smallest:
// the lower half of a bitonic merge of the list with the reversed batch,
// then a bitonic clean.
template <bool K64>
__device__ __forceinline__ void merge(u64& lo, u64& hi, u64 c, int lane) {
  if constexpr (K64) {
    hi = keep(hi, __shfl_sync(kFull, c, 31 - lane), true);
    const bool lo_first = lo < hi;
    u64 l[2] = {lo_first ? lo : hi, lo_first ? hi : lo};
    clean32_rows<2>(l, lane);
    lo = l[0];
    hi = l[1];
  } else {
    u64 l[1] = {lo};
    const u64 b[1] = {c};
    merge32_rows<1>(l, b, lane);
    lo = l[0];
  }
}

// Merge a few unsorted keys (`c` on the lanes of `valid`, kNone elsewhere)
// into the sorted list by rank: a list key moves up by the number of new
// keys below it, a new key lands at (list keys below it) + (new keys below
// it); the list is rebuilt through the warp's 64-key scratch. Cheaper than
// a bitonic sort and merge for up to kRankMax keys.
template <bool K64>
__device__ __forceinline__ void rank_merge(u64& lo, u64& hi, u64 c, u32 valid, int lane, u64* scratch) {
  int up_lo = 0, up_hi = 0, below_c = 0, rank_c = 0;
  for (u32 m = valid; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const u64 cj = __shfl_sync(kFull, c, j);
    up_lo += cj < lo;
    if (K64) up_hi += cj < hi;
    below_c += cj < c;
    const int r = __popc(__ballot_sync(kFull, lo < cj)) + (K64 ? __popc(__ballot_sync(kFull, hi < cj)) : 0);
    if (lane == j) rank_c = r;
  }
  constexpr int kLen = K64 ? 64 : 32;
  if (lane + up_lo < kLen) scratch[lane + up_lo] = lo;
  if (K64 && lane + 32 + up_hi < kLen) scratch[lane + 32 + up_hi] = hi;
  if (((valid >> lane) & 1u) && rank_c + below_c < kLen) scratch[rank_c + below_c] = c;
  __syncwarp();
  lo = scratch[lane];
  if (K64) hi = scratch[lane + 32];
  __syncwarp();
}

// The list's k-th key: the filter a candidate must pass.
template <bool K64>
__device__ __forceinline__ u64 kth_key(u64 lo, u64 hi, int k) {
  return K64 ? __shfl_sync(kFull, hi, k - 33) : __shfl_sync(kFull, lo, k - 1);
}

template <bool K64>
__global__ void __launch_bounds__(kThreads, 2) knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
                                                          float* __restrict__ out_d, int* __restrict__ out_i,
                                                          int n_q, int n_p, int c_dim, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int blocks_per_cloud = (n_q + kRows - 1) / kRows;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int q0 = (blockIdx.x - cloud * blocks_per_cloud) * kRows;
  const float* qc = q + (size_t)cloud * n_q * c_dim;
  const float* pc = p + (size_t)cloud * n_p * c_dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool xyz = c_dim == 3;
  const bool vec = (c_dim & 3) == 0;
  const int tx = tid & 15, ty = tid >> 4;  // rows 4ty .. 4ty + 3; points tx + 16 j of the tile

  if (!xyz && tid < kRows) {  // |q|^2 of the block's rows, channels in ascending order
    float sq = 0.f;
    if (q0 + tid < n_q) {
      const float* r = qc + (size_t)(q0 + tid) * c_dim;
      for (int c = 0; c < c_dim; ++c) sq = __fadd_rn(sq, __fmul_rn(r[c], r[c]));
    }
    s.qsq[tid] = sq;
  }

  u64 lo[kRowsPerWarp], hi[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) lo[rr] = hi[rr] = kNone;

  const int nchunks = xyz ? 1 : (c_dim + kChunk - 1) / kChunk;
  const int ntiles = (n_p + kTile - 1) / kTile;
  const int steps = ntiles * nchunks;
  // channels of chunk `ch`, rounded up to 4 (the zeros past C add nothing)
  auto width4 = [&](int ch) { return xyz ? 4 : (min(kChunk, c_dim - ch * kChunk) + 3) & ~3; };

  load_chunk(s.q[0], s.p[0], qc, pc, q0, 0, n_q, n_p, c_dim, 0, width4(0), vec);
  cp_async_commit();

  float acc[4][8];
  float pss = 0.f;  // |p|^2 of point tid of the tile, for tid < kTile
  for (int step = 0; step < steps; ++step) {
    const int tile = step / nchunks, ch = step - tile * nchunks;
    cp_async_wait0();
    // chunk `step` has landed for every thread, and every thread is done
    // with the other stage (chunk step - 1): the next chunk may go there
    __syncthreads();
    if (step + 1 < steps) {
      const int nt = (step + 1) / nchunks, nc = step + 1 - nt * nchunks;
      load_chunk(s.q[(step + 1) & 1], s.p[(step + 1) & 1], qc, pc, q0, nt * kTile, n_q, n_p, c_dim, nc * kChunk,
                 width4(nc), vec);
      cp_async_commit();
    }

    const float* qs = s.q[step & 1];
    const float* ps = s.p[step & 1];
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      pss = 0.f;
    }
    if (xyz) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(ps + (tx + 16 * j) * kLd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d0 = __fsub_rn(a[i].x, b.x), d1 = __fsub_rn(a[i].y, b.y), d2 = __fsub_rn(a[i].z, b.z);
          acc[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
        }
      }
    } else {
      const int w4 = width4(ch);
#pragma unroll 2
      for (int c = 0; c < w4; c += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(ps + (tx + 16 * j) * kLd + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = acc[i][j];
            v = __fadd_rn(v, __fmul_rn(a[i].x, b.x));
            v = __fadd_rn(v, __fmul_rn(a[i].y, b.y));
            v = __fadd_rn(v, __fmul_rn(a[i].z, b.z));
            acc[i][j] = __fadd_rn(v, __fmul_rn(a[i].w, b.w));
          }
        }
      }
      if (tid < kTile) {
        for (int c = 0; c < w4; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ps + tid * kLd + c);
          pss = __fadd_rn(pss, __fmul_rn(v.x, v.x));
          pss = __fadd_rn(pss, __fmul_rn(v.y, v.y));
          pss = __fadd_rn(pss, __fmul_rn(v.z, v.z));
          pss = __fadd_rn(pss, __fmul_rn(v.w, v.w));
        }
      }
    }
    if (ch + 1 < nchunks) continue;

    // the tile's distances, then its selection
    if (!xyz && tid < kTile) s.psq[tid] = pss;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float d = xyz ? acc[i][j] : __fadd_rn(__fsub_rn(s.qsq[r], __fmul_rn(2.f, acc[i][j])), s.psq[col]);
        s.dist[r * kDistLd + col] = order_bits(d);
      }
    }
    __syncthreads();

    const int p0 = tile * kTile;
    const int valid = min(kTile, n_p - p0);
    const u32 below = (1u << lane) - 1u;
    u64* buf = s.buf[warp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n_q) continue;  // the same for the whole warp
      u64 key[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int col = lane + 32 * h;
        key[h] = col < valid ? (static_cast<u64>(s.dist[r * kDistLd + col]) << 32) | static_cast<u32>(p0 + col)
                             : kNone;
      }
      u64 thr = kth_key<K64>(lo[rr], hi[rr], k);
      bool in[4];
      int pos[4], total = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        in[h] = key[h] < thr;
        const u32 m = __ballot_sync(kFull, in[h]);
        pos[h] = total + __popc(m & below);
        total += __popc(m);
      }
      if (total == 0) continue;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (in[h]) buf[pos[h]] = key[h];
      __syncwarp();
      for (int base = 0; base < total; base += 32) {
        u64 c = base + lane < total ? buf[base + lane] : kNone;
        if (!(c < thr)) c = kNone;  // the k-th key may have fallen in the last batch
        const u32 valid = __ballot_sync(kFull, c != kNone);
        if (!valid) continue;
        if (__popc(valid) <= kRankMax)
          rank_merge<K64>(lo[rr], hi[rr], c, valid, lane, s.scratch[warp]);
        else
          merge<K64>(lo[rr], hi[rr], sort32(c, lane), lane);
        thr = kth_key<K64>(lo[rr], hi[rr], k);
      }
      __syncwarp();  // the buffer is read before the next row fills it
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= n_q) continue;
    const size_t base = ((size_t)cloud * n_q + row) * k;
    if (lane < k) {
      out_d[base + lane] = from_order_bits(static_cast<u32>(lo[rr] >> 32));
      out_i[base + lane] = static_cast<int>(lo[rr] & 0xffffffffu);
    }
    if (K64 && lane + 32 < k) {
      out_d[base + lane + 32] = from_order_bits(static_cast<u32>(hi[rr] >> 32));
      out_i[base + lane + 32] = static_cast<int>(hi[rr] & 0xffffffffu);
    }
  }
}

}  // namespace

// C entry, bound with ctypes. q (B, S, C), p (B, N, C) f32, dist (B, S, k)
// f32 and idx (B, S, k) int32 are device pointers to contiguous tensors.
// Needs 1 <= k <= 64, k <= N, 1 <= C <= 256. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int knn_select(const float* q, const float* p, float* dist, int* idx, int batch, int n_q, int n_p,
                          int c_dim, int k, void* stream) {
  if (batch <= 0 || n_q <= 0 || k < 1 || k > kMaxK || n_p < k || c_dim < 1 || c_dim > kMaxC)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch * ((n_q + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  auto kernel = k > 32 ? knn_kernel<true> : knn_kernel<false>;
  // the shared-memory limit is set once a device and instance
  static bool ready[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev][k > 32]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev][k > 32] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(q, p, dist, idx, n_q, n_p, c_dim,
                                                                                 k);
  return (int)cudaGetLastError();
}
