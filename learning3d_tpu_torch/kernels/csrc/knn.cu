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
//
// Bound. At PRNet's widest stage (B=16, S=N=1024, C=128) the cross term is
// 2 B S N C = 4.3 G f32 operations, 0.064 ms at the 67 TFLOP/s of f32 on
// the CUDA cores (an FMA counted as two; this kernel issues the product and
// the sum apart, so its own ceiling is half that rate); the inputs are
// 16.8 MB and the outputs 2.6 MB, 0.006 ms at 3.35 TB/s: the operations
// bound it. At C = 3, 9 operations a pair (0.0022 ms at B=16, N=1024).
//
// Design. The TPU kernel holds a (tile, N) distance tile in VMEM and runs k
// rounds of (row min, first index of the min, mask). A block here has 227
// KB of shared memory, and (N, 256) f32 points are 1 MiB at N=1024, so the
// points stream and the selection is a running merge:
// * Grid B * ceil(S / 32), one dimension: a block of 8 warps takes 32 query
//   rows of one cloud and streams the cloud's points in tiles of 64.
// * Distances: each tile's (32, 64) block of distances is computed like a
//   small GEMM on the CUDA cores, a thread owning 2 rows x 4 points, the
//   channels in chunks of 32 through shared memory (queries [c][row],
//   points [c][point] read as float4). The threads of the tile's first two
//   warps also sum the tile's |p|^2; |q|^2 is summed once a block.
// * Keys: a distance becomes the 64-bit key (ordered bits, index). The
//   expansion can make a distance slightly negative (two near-equal feature
//   vectors), so the f32 is first mapped to an order-preserving u32 (every
//   bit of a negative value flipped, the sign bit of a non-negative one
//   set; -0 is made +0 first): key order is then (distance, index) order
//   and ties go to the smaller index by construction.
// * Selection: each warp owns 4 rows and keeps, per row, the running k
//   smallest keys sorted across its lanes in registers (lane l holds
//   positions l and l + 32; k <= 64). A tile's 64 candidates of a row (two a
//   lane) that beat the row's current k-th key are inserted one by one: a
//   ballot counts the keys below the candidate, the list shifts up one
//   position by a shuffle, and the last drops out. After the first tile few
//   candidates pass, so the merge costs little beside the distances.
// * Any N >= k, any S, ragged edges masked in the kernel (rows past S load
//   zeros and write nothing; points past N are no candidates).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int kRows = 32;   // query rows a block
constexpr int kTile = 64;   // points a tile
constexpr int kChunk = 32;  // channels a chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxK = 64;
constexpr int kMaxC = 256;
constexpr u64 kNone = ~0ull;

// An order-preserving map of f32 to u32 (-0 counted as +0).
__device__ __forceinline__ u32 order_bits(float d) {
  const u32 u = __float_as_uint(__fadd_rn(d, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(u32 o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ u64 make_key(float d, int idx) {
  return (static_cast<u64>(order_bits(d)) << 32) | static_cast<u32>(idx);
}

// Insert ``key`` (below the list's k-th key) into a warp's sorted list of
// the k smallest keys (lane l holds positions l in ``lo`` and l + 32 in
// ``hi``); the k-th key drops out and ``thr`` becomes the new k-th key.
__device__ __forceinline__ void insert(u64& lo, u64& hi, u64& thr, u64 key, int k, int lane) {
  const int pos = __popc(__ballot_sync(0xffffffffu, lo < key)) + __popc(__ballot_sync(0xffffffffu, hi < key));
  const u64 lo_prev = __shfl_up_sync(0xffffffffu, lo, 1);
  const u64 hi_up = __shfl_up_sync(0xffffffffu, hi, 1);
  const u64 lo_last = __shfl_sync(0xffffffffu, lo, 31);
  const u64 hi_prev = lane == 0 ? lo_last : hi_up;
  const int a = lane, b = lane + 32;
  lo = a < pos ? lo : (a == pos ? key : lo_prev);
  hi = b < pos ? hi : (b == pos ? key : hi_prev);
  if (a >= k) lo = kNone;
  if (b >= k) hi = kNone;
  thr = k <= 32 ? __shfl_sync(0xffffffffu, lo, k - 1) : __shfl_sync(0xffffffffu, hi, k - 33);
}

__global__ void __launch_bounds__(kThreads) knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
                                                       float* __restrict__ out_d, int* __restrict__ out_i, int n_q,
                                                       int n_p, int c_dim, int k) {
  __shared__ float qs[kChunk][kRows + 1];
  __shared__ __align__(16) float ps[kChunk][kTile + 4];
  __shared__ float ds[kRows][kTile + 1];
  __shared__ float qsq[kRows];
  __shared__ float psq[kTile];

  const int blocks_per_cloud = (n_q + kRows - 1) / kRows;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int q0 = (blockIdx.x - cloud * blocks_per_cloud) * kRows;
  const float* qc = q + (size_t)cloud * n_q * c_dim;
  const float* pc = p + (size_t)cloud * n_p * c_dim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool xyz = c_dim == 3;
  const int ty = tid >> 4, tx = tid & 15;  // rows 2ty, 2ty + 1; points 4tx .. 4tx + 3 of the tile

  if (!xyz && tid < kRows) {  // |q|^2 of the block's rows, channels in ascending order
    float s = 0.f;
    if (q0 + tid < n_q) {
      const float* r = qc + (size_t)(q0 + tid) * c_dim;
      for (int c = 0; c < c_dim; ++c) s = __fadd_rn(s, __fmul_rn(r[c], r[c]));
    }
    qsq[tid] = s;
  }

  u64 lo[kRowsPerWarp], hi[kRowsPerWarp], thr[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) lo[rr] = hi[rr] = thr[rr] = kNone;

  for (int p0 = 0; p0 < n_p; p0 += kTile) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float pss = 0.f;  // |p|^2 of point p0 + tid, for tid < kTile
    for (int c0 = 0; c0 < c_dim; c0 += kChunk) {
      const int kc = min(kChunk, c_dim - c0);
      for (int i = tid; i < kRows * kc; i += kThreads) {
        const int r = i / kc, c = i - r * kc;
        qs[c][r] = q0 + r < n_q ? qc[(size_t)(q0 + r) * c_dim + c0 + c] : 0.f;
      }
      for (int i = tid; i < kTile * kc; i += kThreads) {
        const int j = i / kc, c = i - j * kc;
        ps[c][j] = p0 + j < n_p ? pc[(size_t)(p0 + j) * c_dim + c0 + c] : 0.f;
      }
      __syncthreads();
      if (xyz) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 2 * ty + i, pt = 4 * tx + j;
            const float d0 = __fsub_rn(qs[0][r], ps[0][pt]), d1 = __fsub_rn(qs[1][r], ps[1][pt]),
                        d2 = __fsub_rn(qs[2][r], ps[2][pt]);
            acc[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
          }
      } else {
#pragma unroll 4
        for (int c = 0; c < kc; ++c) {
          const float a[2] = {qs[c][2 * ty], qs[c][2 * ty + 1]};
          const float4 b4 = *reinterpret_cast<const float4*>(&ps[c][4 * tx]);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
        }
        if (tid < kTile)
          for (int c = 0; c < kc; ++c) pss = __fadd_rn(pss, __fmul_rn(ps[c][tid], ps[c][tid]));
      }
      __syncthreads();  // the chunk is read before the next one is loaded
    }
    if (!xyz && tid < kTile) psq[tid] = pss;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i, pt = 4 * tx + j;
        ds[r][pt] = xyz ? acc[i][j]
                        : __fadd_rn(__fsub_rn(qsq[r], __fmul_rn(2.f, acc[i][j])), psq[pt]);
      }
    __syncthreads();

    const int valid = min(kTile, n_p - p0);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= n_q) continue;  // the same for the whole warp
      u64 c_lo = lane < valid ? make_key(ds[r][lane], p0 + lane) : kNone;
      u64 c_hi = lane + 32 < valid ? make_key(ds[r][lane + 32], p0 + lane + 32) : kNone;
      while (true) {
        const bool a_in = c_lo < thr[rr], b_in = c_hi < thr[rr];
        const u32 m = __ballot_sync(0xffffffffu, a_in || b_in);
        if (!m) break;
        const int src = __ffs(m) - 1;
        const u64 mine = a_in ? ((b_in && c_hi < c_lo) ? c_hi : c_lo) : c_hi;
        const u64 key = __shfl_sync(0xffffffffu, mine, src);
        if (lane == src) {
          if (key == c_lo)
            c_lo = kNone;
          else
            c_hi = kNone;
        }
        insert(lo[rr], hi[rr], thr[rr], key, k, lane);
      }
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
    if (lane + 32 < k) {
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
  knn_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q, p, dist, idx, n_q, n_p, c_dim,
                                                                                   k);
  return (int)cudaGetLastError();
}
