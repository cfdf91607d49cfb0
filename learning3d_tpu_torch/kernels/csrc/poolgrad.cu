// The train-mode fused PointNet tail for Hopper (sm_90a): K3, the forward
// statistics of conv5 + BatchNorm + ReLU + max-pool, and K4, its sparse
// max-pool backward.
//
// K3 replaces learning3d_tpu/kernels/poolgrad.py::pool_stats_pallas (body
// `_stats_kernel`). x (B, N, 128) and W (128, E), both bf16 or both f32, and
// c (E) f32 in; z = x W + c is never written. Out: per (cloud, channel) the
// max, min, argmax and argmin of z over the points (f32, f32, int32, int32;
// ties go to the smaller point index), the 128 x 128 Gram matrix
// G = sum over all B*N rows of x x^T and the column sum of x, both f32.
// Same math as the port's plain version `pool_stats_reference`: bf16
// operands multiply exactly into f32 sums; the bias is added before the
// comparisons, as the TPU kernel adds it.
//
// K4 replaces poolgrad.py::pool_bwd_pallas (body `_scatter_kernel`). idx
// (B, E) int32, dsel (B, E) f32, W (as W^T, (E, 128)) and x (B, N, 128) in;
// dx_sp (B, N, 128) f32 with dx_sp[b, idx[b,e], :] += r(dsel[b,e]) W[:, e],
// every untouched row 0, and dW_sel (as its transpose (E, 128)) f32 with
// dW_sel[:, e] = sum_b x[b, idx[b,e], :] dsel[b,e]. r rounds to bf16 when W
// is bf16 (the TPU kernel casts its one-hot tile to bf16 for that product)
// and is the identity for f32; the dW products take dsel in f32.
// `pool_bwd_reference` is the plain version.
//
// Bound (bench.py's training step: B=256, N=1024, K=128, E=1024, bf16).
// K3: z is 2 * 262,144 * 128 * 1024 = 68.7 GFLOP and G 8.6 GFLOP, 78 us at
// the dense bf16 tensor-core peak (989 TFLOP/s); x is 64 MiB, 20 us at
// 3.35 TB/s. Bound by operations. Beside the products, the running max,
// min and their indices take some 7 CUDA-core instructions a z element
// (1.9 G at this shape, 56 us at one instruction a lane and clock), which
// have to hide under them. K4: dx_sp is 128 MiB written and at most 64 MiB
// of x is read, 60 us; its operations are 2 * B * E * 128 * 2 = 0.13 GFLOP.
// Bound by bytes.
//
// K3 design (the design of K1's stage 5, pointnet_fused.cu: the same 128 ->
// 1024 product over the same points with a max over them):
// * Weights. A pack launch (`pack_kernel`, from the same C entry) reads W
//   in place and writes W^T once a call as bf16 in the exact shared-memory
//   image wgmma reads:
//   blocks of 64 output channels, each two boxes of 64 rows (k 0..63,
//   64..127) of 128 bytes with the 128-byte swizzle; for f32 W a hi image
//   and a lo image (bf16(W) and bf16(W - hi)). A block fetches its group's
//   slice with one bulk copy a part and keeps it resident.
// * A persistent grid over (cloud, channel group) items, one block an SM:
//   each block is bound to one group of at most 512 channels (256 for f32)
//   and walks its clouds. `plan` chooses the group count from the rounds of
//   items a block takes: two groups of 512 at B=256, E=1024 (66 blocks a
//   group, four rounds of clouds on 132 SMs).
// * x tiles by TMA (3-D map (128, N, B), boxes of 64 channels x P points,
//   128-byte swizzle, zeros past N: a ragged tail is read as zeros and
//   masked in the fold, never padded in memory) into a ring of two stages,
//   issued by a producer warp beside the two consumer warpgroups, with
//   full and empty mbarriers. P = 128 points for bf16, 64 for f32. No
//   thread copies x, and the tile loop has no __syncthreads.
// * Transposed product: D (64 channels x P points) = W^T block (A, shared
//   memory, K-major) x tile^T (B, shared memory, K-major), m64nPk16, one
//   64-channel block a wgmma group. With channels as rows, a thread's
//   running max, min and their indices for its two channels come from its
//   own accumulator columns, which it sees in increasing point order, so a
//   strict comparison keeps the first index; at the end the four threads of
//   a quad are combined in (value, index) order. Each warpgroup owns half of
//   the group's channel blocks; both read every tile.
// * The two consumer warpgroups take turns issuing (sm90::PingPong), so
//   that one folds its accumulators while the other's wgmma group runs.
//   The fold adds the bias to every element (ties are decided on fl(z +
//   c)), takes the tile's max and min of each channel with fmaxf and fminf
//   first, and searches the tile for the first point that holds one only
//   where it beats the running value. At N = 1024 most warps still search
//   in most tiles; on the H100 this ran 12% faster than a
//   compare-and-select of value and index at every element (7
//   instructions an element; both with the running values in registers),
//   and 8% faster than the same fold on the raw accumulators with the bias
//   added to the tile's max alone. The running values live in shared memory,
//   each thread's own (in registers the bf16 instance spilled).
// * Gram matrix: four 64 x 64 quadrants of x^T x on wgmma with both
//   operands read from the same x tile through the transpose bits (the
//   points are the contracted index, along the tile's rows): a warpgroup
//   of the block's slot 2 * group + warpgroup accumulates quadrant slot
//   (and slot + 2 ngroups where there is one group), in registers, issued
//   in its first wgmma group of each tile. Column sums: the producer warp
//   of each first-group block sums the tile's columns from shared memory
//   once it has landed (lane l four columns, in point order) before it
//   frees the stage. Both are partials of one cloud, which a second kernel
//   sums over the clouds in index order: a fixed order, no float atomics,
//   and the summation of K3 before this design (a cloud's 1024 points in
//   one tensor-core chain of k-steps of 16, then the clouds in order).
//   That order matters: the classifier's train-mode step turns G into BN
//   variances by E[z^2] - mean^2, which cancels, and chip_smoke.py's check
//   of the step against the plain version (cuBLAS's f32 sums) failed at
//   3.1-5.2% with one partial a block (a block's clouds in one chain of up
//   to 256 k-steps, G 7.3e-6 from its f64 value) as it did with exact
//   sums (5.1%), where this order gives 2.1%.
// * f32 x and W: a split launch writes x as bf16 hi and lo tensors first;
//   the same pipeline then reads a hi and a lo tile a stage and every
//   product is hi*hi + hi*lo + lo*hi (the TPU kernel's `_dot3` split, about
//   2^-16 of the exact product), three wgmmas a k-step; the column sums add
//   hi + lo (exact in f32, within 2^-17 of x).
//
// K4 design. The TPU builds (idx == row) one-hot tiles and multiplies them
// on the MXU; here one launch of two block roles, the dW blocks first (their
// gathers are latency chains that the dx blocks' stores then overlap; on
// the H100 this ran faster than the dW blocks last or spread among the dx
// blocks).
// * dx (a block a tile of kRowTile = 128 rows of one cloud: 2048 blocks at
//   B=256, N=1024, many waves of 8 warps): the block reads its cloud's E
//   indices (warp w a contiguous range of e; each key's row staged in shared
//   memory) and keeps the keys whose row lies in its tile, in ascending e: a
//   ballot a 32-key round, a warp's count, the warps' offsets summed by
//   every thread, then each key written at its offset plus the popcount of
//   the lanes below (a list of row << 12 | e, and a count a row by shared
//   atomics). Warp w writes rows w, w + 8, ...: a row with keys takes them
//   from the list by ballot in e order until it has its count, loads
//   kRowKeys = 4 keys' W^T rows (L2-resident) and dsel before their FMAs
//   (rows hold ~2 keys at the classifier's shape: 4 ran faster than 2, 8 or
//   16 on the H100),
//   and lane l sums columns 2l, 2l + 1, 64 + 2l, 65 + 2l by fmaf from 0 in
//   ascending e; a row with none is zeros. Every row is written whole by
//   streaming stores. No sort (a bitonic sort of the keys takes 55 barriers
//   at E = 1024) and no search a row. Each output's summation chain is fixed
//   (ascending e from 0; ascending b below), so the results do not depend on
//   the schedule: a sort-based schedule gives the same bits.
// * dW (a warp a half row: 64 columns of one channel e): lane l sums its two
//   columns of x[b, idx[b,e], :] dsel[b,e] over b = 0..B-1 in order (fmaf),
//   with 32 clouds' rows in flight for bf16 and 16 for f32. It writes
//   dW_sel^T (E, 128); the wrapper hands back its transpose.
// * Registers: 64 a thread (four blocks an SM; at 96, two blocks an SM, dx
//   ran 20% slower), a dW warp's loads in flight 32 of them. Indices outside
//   [0, N) contribute nothing and write nothing. Shared memory is 8 E + 544 bytes (33 KB at E = 4096): under
//   48 KB, so no attribute is set.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_sm90.cuh"

namespace {

using sm90::desc_sw128;
using sm90::fence_operands;

typedef __nv_bfloat16 bf16;

constexpr int kK = 128;  // input channels: the PointNet tail's conv5 width
// K3
constexpr int kConsumerThreads = 256;                   // two consumer warpgroups
constexpr int kStatsThreads = kConsumerThreads + 32;    // and the producer warp
constexpr int kWBox = 8192;        // 64 channels x 64 k of bf16
constexpr int kBlockBytes = 16384; // a 64-channel block of the image: two boxes
constexpr int kMaxDevices = 64;
// K4 and the partial sums' reduction
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxE = 4096;  // K4: e fits the low 12 bits of a list entry
constexpr int kRowTile = 128;  // K4: dx_sp rows a block
constexpr int kRowKeys = 4;    // K4: keys whose W^T rows a dx row loads before their FMAs
constexpr int kReduceUnroll = 64;  // loads in flight a thread of the partials' sum
constexpr int kReduceThreads = 128;

// K3's shapes for bf16 or f32 operands.
template <bool kF32>
struct Cfg {
  static constexpr int kPts = kF32 ? 64 : 128;        // points a tile: the product's N
  static constexpr int kStages = 2;                   // stages of the tile ring
  static constexpr int kMaxGroup = kF32 ? 256 : 512;  // channels a block keeps resident
  static constexpr int kParts = kF32 ? 2 : 1;         // bf16 parts: hi (and lo)
  static constexpr int kBox = kPts * 128;             // a tile box: kPts points x 64 k
  static constexpr int kStageBytes = kParts * 2 * kBox;
  static constexpr int kAcc = kPts / 2;               // a thread's accumulators of one block
  static constexpr int kWBytes = kParts * kMaxGroup * 256;
  static constexpr int kMaxCb = kMaxGroup / 128;      // channel blocks a warpgroup
  static constexpr int kStateBytes = kMaxCb * 2 * kConsumerThreads * 16;  // the running values
  // the dynamic shared memory, past the 1024-byte alignment: the weights,
  // the ring, the running values and the barriers
  static constexpr int kSmem = kWBytes + kStages * kStageBytes + kStateBytes + 8 * (1 + 2 * kStages);
};

struct StatsArgs {
  const uint8_t* img;  // the packed W^T: hi (and lo at e * 256 bytes)
  const float* c;      // (E,)
  float *mx, *mn;      // (B, E)
  int *amax, *amin;    // (B, E)
  float* gpart;        // (B, 128, 128) Gram partials, one a cloud
  float* cspart;       // (B, 128) column-sum partials
  int n, e, batch;
  int group, ngroups;  // channels a group (a multiple of 128), groups
  int cpg;             // blocks a group
};

// Eight f32 values as bf16 hi = bf16(v) and lo = bf16(v - hi), in order.
__device__ __forceinline__ void split8(float4 a, float4 b, uint4& hi, uint4& lo) {
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    const float2 back = __bfloat1622float2(hh);
    const __nv_bfloat162 ll = __floats2bfloat162_rn(f[2 * q] - back.x, f[2 * q + 1] - back.y);
    memcpy(&h[q], &hh, 4);
    memcpy(&l[q], &ll, 4);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// W (128, E), bf16 or f32, read in place, as the image of W^T that wgmma
// reads (see Design: Weights): byte `off` of a part lies in 64-channel
// block off / 16384, box (off / 8192) & 1 (k from 64 box), row (channel)
// (off / 128) & 63, and its 16-byte chunk at (off / 16) & 7 holds k 8
// (chunk ^ row % 8) .. + 7. The lo part (f32 W only) follows the hi part.
// One thread a chunk (its eight weights a column apart in W: 256 KB or
// 512 KB, read once).
template <bool kF32>
__global__ void pack_kernel(const void* __restrict__ w, int e_total, uint8_t* __restrict__ img) {
  const int chunks = e_total * 256 / 16;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < chunks; i += gridDim.x * blockDim.x) {
    const int off = 16 * i;
    const int rr = (off >> 7) & 63;
    const int n = 64 * (off / kBlockBytes) + rr;
    const int k0 = 64 * ((off / kWBox) & 1) + 8 * (((off >> 4) & 7) ^ (rr & 7));
    if constexpr (kF32) {
      const float* col = static_cast<const float*>(w) + (size_t)k0 * e_total + n;
      float f[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = col[(size_t)q * e_total];
      uint4 hi, lo;
      split8(make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7]), hi, lo);
      *reinterpret_cast<uint4*>(img + off) = hi;
      *reinterpret_cast<uint4*>(img + (size_t)e_total * 256 + off) = lo;
    } else {
      const unsigned short* col = static_cast<const unsigned short*>(w) + (size_t)k0 * e_total + n;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = static_cast<uint32_t>(col[(size_t)(2 * q) * e_total]) |
               (static_cast<uint32_t>(col[(size_t)(2 * q + 1) * e_total]) << 16);
      *reinterpret_cast<uint4*>(img + off) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// f32 x (count values, a multiple of 8) as bf16 hi = bf16(x) and lo =
// bf16(x - hi), 8 values a thread.
__global__ void split_kernel(const float4* __restrict__ x, uint4* __restrict__ hi, uint4* __restrict__ lo,
                             size_t count) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; 8 * i < count; i += (size_t)gridDim.x * blockDim.x)
    split8(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// Four bf16 values (8 bytes) as f32.
__device__ __forceinline__ void bf16x4(float (&f)[4], uint2 v) {
  __nv_bfloat162 p[2];
  memcpy(p, &v, 8);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// (value, index) order of the max: the larger value, on a tie the smaller index.
__device__ __forceinline__ bool beats_max(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ bool beats_min(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// Issues z's product of one 64-channel block (its image at wb; f32: the lo
// image kMaxGroup * 256 bytes on) against the tile at st: 8 k-steps of 16,
// K-major operands, box (kk / 4) and 32 bytes a k-step within it.
template <bool kF32>
__device__ __forceinline__ void issue_z(float (&acc)[Cfg<kF32>::kAcc], const uint8_t* wb, const uint8_t* st) {
  using C = Cfg<kF32>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t da = desc_sw128(wb + (kk >> 2) * kWBox, 16) + 2 * (kk & 3);
    const uint64_t db = desc_sw128(st + (kk >> 2) * C::kBox, 16) + 2 * (kk & 3);
    if constexpr (C::kPts == 64)
      sm90::mma_bf16_ss_n64(acc, da, db, kk > 0);
    else
      sm90::mma_bf16_ss(acc, da, db, kk > 0);
    if constexpr (kF32) {
      const uint64_t dal = desc_sw128(wb + C::kMaxGroup * 256 + (kk >> 2) * kWBox, 16) + 2 * (kk & 3);
      const uint64_t dbl = desc_sw128(st + (2 + (kk >> 2)) * C::kBox, 16) + 2 * (kk & 3);
      sm90::mma_bf16_ss_n64(acc, da, dbl, 1);
      sm90::mma_bf16_ss_n64(acc, dal, db, 1);
    }
  }
}

// Issues the tile's part of Gram quadrant (qi, qj): D[i][j] += sum over the
// tile's points of x[p][64 qi + i] x[p][64 qj + j], A = x^T and B = x read
// from boxes qi and qj through the transpose bits, k-steps of 16 points
// (2048 bytes). f32: hi*hi + hi*lo + lo*hi.
template <bool kF32>
__device__ __forceinline__ void issue_gram(float (&d)[32], const uint8_t* st, int qi, int qj) {
  using C = Cfg<kF32>;
#pragma unroll
  for (int ks = 0; ks < C::kPts / 16; ++ks) {
    const uint64_t da = desc_sw128(st + qi * C::kBox, C::kBox) + 128 * ks;
    const uint64_t db = desc_sw128(st + qj * C::kBox, C::kBox) + 128 * ks;
    sm90::mma_bf16_ss_n64_tt(d, da, db, 1);
    if constexpr (kF32) {
      sm90::mma_bf16_ss_n64_tt(d, da, desc_sw128(st + (2 + qj) * C::kBox, C::kBox) + 128 * ks, 1);
      sm90::mma_bf16_ss_n64_tt(d, desc_sw128(st + (2 + qi) * C::kBox, C::kBox) + 128 * ks, db, 1);
    }
  }
}

// A thread's running max, min and their points for one of its channels
// (row g or g + 8 of its warp's 16 of a 64-channel block). They live in
// shared memory, [block][row][consumer thread], each thread's own: read
// once a tile, written where the tile beats them, so that the registers
// hold the accumulators (in registers the bf16 instance spilled).
struct Running {
  float mx, mn;
  int ax, an;
};

// Folds a tile's accumulators (columns 8 j + 2 t + e: points p0 + 8 j + e,
// p0 = tile start + 2 t, in increasing order) into `run` (rows g and g + 8:
// run and run + kConsumerThreads), whose current max and min (cur0, cur1)
// and biases (b0, b1) the caller read. The bias is added to every value
// (ties are decided on fl(z + c)); the tile's max and min of each channel
// come first, from fmaxf and fminf in two chains each (even and odd
// columns), and only where one beats the running value is the tile
// searched for its first point that holds it. MASKED (the last tile of a
// ragged cloud): points from n on never win.
template <bool kMasked, int kAcc>
__device__ __forceinline__ void fold(Running* run, const float (&acc)[kAcc], float b0, float b1, float2 cur0,
                                     float2 cur1, int p0, int n) {
  float rmx[2][2], rmn[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rmx[h][e] = -INFINITY;
      rmn[h][e] = INFINITY;
    }
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !kMasked || p0 + 8 * j + e < n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = acc[4 * j + 2 * h + e] + (h ? b1 : b0);
        rmx[h][e] = fmaxf(rmx[h][e], ok ? v : -INFINITY);
        rmn[h][e] = fminf(rmn[h][e], ok ? v : INFINITY);
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float b = h ? b1 : b0;
    const float2 cur = h ? cur1 : cur0;
    const float mx = fmaxf(rmx[h][0], rmx[h][1]), mn = fminf(rmn[h][0], rmn[h][1]);
    Running* r = run + h * kConsumerThreads;
    if (mx > cur.x)
      {
        int at = 0;
#pragma unroll
        for (int j = kAcc / 4 - 1; j >= 0; --j)
#pragma unroll
          for (int e = 1; e >= 0; --e)
            if (acc[4 * j + 2 * h + e] + b == mx) at = p0 + 8 * j + e;
        r->mx = mx;
        r->ax = at;
      }
    if (mn < cur.y)
      {
        int at = 0;
#pragma unroll
        for (int j = kAcc / 4 - 1; j >= 0; --j)
#pragma unroll
          for (int e = 1; e >= 0; --e)
            if (acc[4 * j + 2 * h + e] + b == mn) at = p0 + 8 * j + e;
        r->mn = mn;
        r->an = at;
      }
  }
}

template <bool kF32, int kQuads>
__global__ void __launch_bounds__(kStatsThreads, 1)
    pool_stats_kernel(const __grid_constant__ CUtensorMap map_hi, const __grid_constant__ CUtensorMap map_lo,
                      const StatsArgs a) {
  using C = Cfg<kF32>;
  // channel blocks a warpgroup: one group of 128 channels where the block
  // also keeps two Gram quadrants (E = 128, one group)
  constexpr int kMaxCb = kQuads == 2 ? 1 : C::kMaxCb;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint8_t* ring = smem + C::kWBytes;
  Running* state = reinterpret_cast<Running*>(ring + C::kStages * C::kStageBytes);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes + C::kStateBytes);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = blockIdx.x % a.ngroups, r = blockIdx.x / a.ngroups;
  const int c_lo = grp * a.group;
  const int nmb = min(a.group, a.e - c_lo) >> 6;  // 64-channel blocks of this group (even)
  const int ntiles = (a.n + C::kPts - 1) / C::kPts;
  if (tid == 0) {
    sm90::bar_init(wbar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, kConsumerThreads / 32 + 1);  // the consumer warps and the producer
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warp
    if (lane == 0) {
      sm90::bar_expect_tx(wbar, C::kParts * nmb * kBlockBytes);
      sm90::bulk_load(smem, a.img + (size_t)c_lo * 256, nmb * kBlockBytes, wbar);
      if constexpr (kF32)
        sm90::bulk_load(smem + C::kMaxGroup * 256, a.img + ((size_t)a.e + c_lo) * 256, nmb * kBlockBytes, wbar);
    }
    // the column sums: the first group's blocks, lane l columns 64 (l / 16)
    // + 4 (l % 16) .. + 3 of each tile, in point order (rows past N are 0),
    // one tile behind the loads, so that the next tile's copy is in flight
    // while this one lands and is summed. Other blocks free a stage's
    // producer share as soon as they have issued its copy.
    const bool sums = grp == 0;
    const int box = lane >> 4, cc = 4 * (lane & 15);
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
    sm90::Ring loads(C::kStages), summed(C::kStages);
    int sum_cloud = r, sum_t = 0;  // the tile the next sum takes
    auto sum_tile = [&]() {
      sm90::bar_wait(full + summed.stage, summed.phase);
      const uint8_t* col = ring + summed.stage * C::kStageBytes + box * C::kBox + 2 * (cc & 7);
#pragma unroll 4
      for (int p = 0; p < C::kPts; ++p) {
        const int off = p * 128 + ((((cc >> 3) ^ p) & 7) << 4);
        float v[4];
        bf16x4(v, *reinterpret_cast<const uint2*>(col + off));
        if constexpr (kF32) {
          float l[4];
          bf16x4(l, *reinterpret_cast<const uint2*>(col + 2 * C::kBox + off));
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] += l[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) cs[q] += v[q];
      }
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(empty + summed.stage);
      summed.next();
      if (++sum_t == ntiles) {  // the cloud's partial
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a.cspart[(size_t)sum_cloud * kK + 64 * box + cc + q] = cs[q];
          cs[q] = 0.f;
        }
        sum_t = 0;
        sum_cloud += a.cpg;
      }
    };
    bool behind = false;  // a loaded tile waits for its sum
    for (int cloud = r; cloud < a.batch; cloud += a.cpg)
      for (int t = 0; t < ntiles; ++t) {
        if (lane == 0) {
          uint8_t* st = ring + loads.stage * C::kStageBytes;
          sm90::bar_wait(empty + loads.stage, loads.phase ^ 1u);
          sm90::bar_expect_tx(full + loads.stage, C::kStageBytes);
#pragma unroll
          for (int part = 0; part < C::kParts; ++part)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              sm90::tma_load_3d(st + (2 * part + b) * C::kBox, part ? &map_lo : &map_hi, full + loads.stage,
                                64 * b, t * C::kPts, cloud);
          if (!sums) sm90::bar_arrive(empty + loads.stage);
        }
        loads.next();
        if (sums) {
          if (behind) sum_tile();
          behind = true;
        }
      }
    if (behind) sum_tile();
    return;
  }

  // the consumers: warpgroup wg takes channel blocks cb0 .. cb0 + ncb - 1
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ncb = nmb >> 1, cb0 = wg * ncb;
  // the Gram quadrants slot + 2 ngroups i of slot 2 grp + wg. Every
  // warpgroup issues its products: a slot past the four quadrants (three
  // or more groups) computes quadrant slot % 4 again and does not write
  // it, since a wgmma on a path that not every warpgroup takes is
  // serialized (ptxas C7520)
  const int slot = 2 * grp + wg;
  int quad[kQuads];
  float gacc[kQuads][32];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) quad[q] = slot + 2 * a.ngroups * q;
  sm90::bar_wait(wbar, 0);
  const sm90::PingPong turns(wg);
  turns.open();
  int stage = 0;
  uint32_t phase = 0;
  for (int cloud = r; cloud < a.batch; cloud += a.cpg) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) gacc[q][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * kMaxCb; ++i) state[i * kConsumerThreads + tid] = Running{-INFINITY, INFINITY, 0, 0};
    for (int tile = 0; tile < ntiles; ++tile) {
      const uint8_t* st = ring + stage * C::kStageBytes;
      sm90::bar_wait(full + stage, phase);
      const int p0 = tile * C::kPts + 2 * t;
      const bool whole = (tile + 1) * C::kPts <= a.n;
#pragma unroll
      for (int cb = 0; cb < kMaxCb; ++cb) {
        if (cb >= ncb) break;
        float acc[C::kAcc];
        // the biases and the running values, read before the products
        turns.turn();
        fence_operands(acc);
#pragma unroll
        for (int q = 0; q < kQuads; ++q) fence_operands(gacc[q]);
        sm90::wgmma_fence();
        issue_z<kF32>(acc, smem + (cb0 + cb) * kBlockBytes, st);
        if (cb == 0)
#pragma unroll
          for (int q = 0; q < kQuads; ++q) issue_gram<kF32>(gacc[q], st, (quad[q] >> 1) & 1, quad[q] & 1);
        sm90::wgmma_commit();
        turns.pass();
        sm90::wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int q = 0; q < kQuads; ++q) fence_operands(gacc[q]);
        const float* bc = a.c + c_lo + 64 * (cb0 + cb) + 16 * warp + g;
        const float b0 = __ldg(bc), b1 = __ldg(bc + 8);
        Running* run = state + 2 * cb * kConsumerThreads + tid;
        const float2 cur0 = *reinterpret_cast<const float2*>(run);
        const float2 cur1 = *reinterpret_cast<const float2*>(run + kConsumerThreads);
        if (whole)
          fold<false>(run, acc, b0, b1, cur0, cur1, p0, a.n);
        else
          fold<true>(run, acc, b0, b1, cur0, cur1, p0, a.n);
      }
      sm90::release(empty + stage, lane);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    // the quad's four threads in (value, index) order; thread t == 0 writes
#pragma unroll
    for (int cb = 0; cb < kMaxCb; ++cb) {
      if (cb >= ncb) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Running run = state[(2 * cb + h) * kConsumerThreads + tid];
        float vx = run.mx, vn = run.mn;
        int ix = run.ax, in = run.an;
#pragma unroll
        for (int s = 1; s < 4; s <<= 1) {
          const float ox = __shfl_xor_sync(0xffffffffu, vx, s), on = __shfl_xor_sync(0xffffffffu, vn, s);
          const int jx = __shfl_xor_sync(0xffffffffu, ix, s), jn = __shfl_xor_sync(0xffffffffu, in, s);
          if (beats_max(ox, jx, vx, ix)) {
            vx = ox;
            ix = jx;
          }
          if (beats_min(on, jn, vn, in)) {
            vn = on;
            in = jn;
          }
        }
        if (t == 0) {
          const size_t o = (size_t)cloud * a.e + c_lo + 64 * (cb0 + cb) + 16 * warp + g + 8 * h;
          a.mx[o] = vx;
          a.mn[o] = vn;
          a.amax[o] = ix;
          a.amin[o] = in;
        }
      }
    }
    // the cloud's Gram partial: quadrant (qi, qj) rows 64 qi + 16 warp + g
    // (+ 8), columns 64 qj + 8 j + 2 t (+ 1)
    float* gp = a.gpart + (size_t)cloud * kK * kK;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      if (quad[q] >= 4) continue;
      const int row = 64 * (quad[q] >> 1) + 16 * warp + g, col = 64 * (quad[q] & 1) + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(gp + (size_t)(row + 8 * h) * kK + col + 8 * j) =
              make_float2(gacc[q][4 * j + 2 * h], gacc[q][4 * j + 2 * h + 1]);
    }
  }
  turns.close();
}

// G = sum_b gpart[b], colsum = sum_b cspart[b], over the clouds b in index
// order.
__global__ void __launch_bounds__(kReduceThreads) pool_stats_reduce(const float* gpart, const float* cspart,
                                                                    float* G, float* colsum, int batch) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= kK * kK + kK) return;
  const float* src = i < kK * kK ? gpart + i : cspart + (i - kK * kK);
  const size_t stride = i < kK * kK ? (size_t)kK * kK : (size_t)kK;
  float s = 0.f;
  for (int b0 = 0; b0 < batch; b0 += kReduceUnroll) {
    float v[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) v[u] = b0 + u < batch ? src[(b0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) s += v[u];
  }
  if (i < kK * kK) G[i] = s; else colsum[i - kK * kK] = s;
}

// Two consecutive columns of a row as a lane loads them (bf16: 4 bytes, f32:
// 8), and how many clouds' gathered x rows a dW warp keeps in flight (32
// registers of loads either way).
template <bool kF32>
struct Pair;

template <>
struct Pair<true> {
  using Raw = float2;
  static constexpr int kInflight = 16;
  __device__ static Raw zero() { return make_float2(0.f, 0.f); }
  __device__ static Raw load(const void* base, size_t off) {
    return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(base) + off));
  }
  __device__ static float2 unpack(Raw v) { return v; }
};

template <>
struct Pair<false> {
  using Raw = unsigned;
  static constexpr int kInflight = 32;
  __device__ static Raw zero() { return 0u; }
  __device__ static Raw load(const void* base, size_t off) {
    return __ldg(reinterpret_cast<const unsigned*>(static_cast<const bf16*>(base) + off));
  }
  __device__ static float2 unpack(Raw v) {
    __nv_bfloat162 h;
    memcpy(&h, &v, 4);
    return __bfloat1622float2(h);
  }
};

// K4 (see the header): one launch, two block roles. Blocks [0, dw_blocks)
// take dW_sel^T, a warp a half row (64 channels of x) of one channel e; the
// rest take dx_sp, a block a tile of kRowTile rows of one cloud.
template <bool kF32>
__device__ __forceinline__ void pool_bwd_dw(const int* idx, const float* dsel, const void* x, float* dwt, int batch,
                                            int n_pts, int e_total, int block) {
  using P = Pair<kF32>;
  constexpr int kIn = P::kInflight;
  const int lane = threadIdx.x & 31;
  const int half_row = block * kWarps + (threadIdx.x >> 5);
  const int e = half_row >> 1;
  if (e >= e_total) return;
  const int col = 64 * (half_row & 1) + 2 * lane;  // lane's two columns
  float acc0 = 0.f, acc1 = 0.f;
  for (int b0 = 0; b0 < batch; b0 += kIn) {
    int my_n = -1;
    float my_d = 0.f;
    if (lane < kIn && b0 + lane < batch) {
      my_n = __ldg(idx + (size_t)(b0 + lane) * e_total + e);
      my_d = __ldg(dsel + (size_t)(b0 + lane) * e_total + e);
    }
    if (my_n < 0 || my_n >= n_pts) my_d = 0.f;  // a row outside [0, N) contributes nothing
    typename P::Raw v[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int n = __shfl_sync(0xffffffffu, my_n, u);
      v[u] = P::zero();
      if (n >= 0 && n < n_pts) v[u] = P::load(x, ((size_t)(b0 + u) * n_pts + n) * kK + col);
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const float d = __shfl_sync(0xffffffffu, my_d, u);
      const float2 f = P::unpack(v[u]);
      acc0 = fmaf(f.x, d, acc0);
      acc1 = fmaf(f.y, d, acc1);
    }
  }
  *reinterpret_cast<float2*>(dwt + (size_t)e * kK + col) = make_float2(acc0, acc1);
}

template <bool kF32>
__device__ __forceinline__ void pool_bwd_dx(const int* idx, const float* dsel, const void* wt, float* dx, int n_pts,
                                            int e_total, int item, int tiles, unsigned char* smem) {
  using P = Pair<kF32>;
  unsigned* rel = reinterpret_cast<unsigned*>(smem);   // [e_total]: each key's row less r0
  int* list = reinterpret_cast<int*>(rel + e_total);   // [e_total]: (row << 12) | e, the tile's keys in e order
  int* cnt = list + e_total;                           // [kRowTile]: keys a row
  int* wcount = cnt + kRowTile;                        // [kWarps]: keys a warp's range of e
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int cloud = item / tiles, r0 = (item - cloud * tiles) * kRowTile;
  const unsigned rows = (unsigned)min(kRowTile, n_pts - r0);
  const int* ib = idx + (size_t)cloud * e_total;
  const float* db = dsel + (size_t)cloud * e_total;
  // warp w takes the contiguous 32-key rounds [w seg, (w + 1) seg) of e
  const int seg = (((e_total + 31) >> 5) + kWarps - 1) / kWarps;
  const int e0 = warp * seg * 32 + lane, e1 = min((warp + 1) * seg * 32, e_total);
  for (int i = tid; i < kRowTile; i += kThreads) cnt[i] = 0;
  int count = 0;
#pragma unroll 4
  for (int e = e0; e < (warp + 1) * seg * 32; e += 32) {
    const unsigned r = e < e1 ? (unsigned)__ldg(ib + e) - (unsigned)r0 : 0xffffffffu;
    if (e < e1) rel[e] = r;
    count += __popc(__ballot_sync(0xffffffffu, r < rows));
  }
  if (lane == 0) wcount[warp] = count;
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = wcount[w];
    off += w < warp ? c : 0;
    total += c;
  }
  // the compaction: each warp's keys at its offset, in e order
  for (int e = e0; e < (warp + 1) * seg * 32; e += 32) {
    const unsigned r = e < e1 ? rel[e] : 0xffffffffu;
    const bool in = r < rows;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (in) {
      list[off + __popc(m & below)] = (int)(r << 12) | e;
      atomicAdd(cnt + r, 1);
    }
    off += __popc(m);
  }
  __syncthreads();
  // the rows: a warp a row, its keys taken from the list by ballot in e
  // order, kRowKeys W^T rows and r(dsel) loaded before their FMAs; lane l sums
  // columns 2l, 2l + 1 and 64 + 2l, 65 + 2l
  float* out = dx + ((size_t)cloud * n_pts + r0) * kK;
  for (int r = warp; r < (int)rows; r += kWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int want = cnt[r];
    for (int i0 = 0, got = 0; got < want; i0 += 32) {
      const int ent = i0 + lane < total ? list[i0 + lane] : -1;
      unsigned m = __ballot_sync(0xffffffffu, ent >= 0 && (ent >> 12) == r);
      got += __popc(m);
      while (m) {
        typename P::Raw w0[kRowKeys], w1[kRowKeys];
        float dk[kRowKeys];
        int nb = 0;
#pragma unroll
        for (int j = 0; j < kRowKeys; ++j) {
          if (m) {
            const int e = __shfl_sync(0xffffffffu, ent, __ffs(m) - 1) & 0xfff;
            m &= m - 1;
            const float d = __ldg(db + e);
            dk[j] = kF32 ? d : __bfloat162float(__float2bfloat16_rn(d));
            w0[j] = P::load(wt, (size_t)e * kK + 2 * lane);
            w1[j] = P::load(wt, (size_t)e * kK + 64 + 2 * lane);
            ++nb;
          }
        }
#pragma unroll
        for (int j = 0; j < kRowKeys; ++j)
          if (j < nb) {
            const float2 a = P::unpack(w0[j]), c = P::unpack(w1[j]);
            acc[0] = fmaf(dk[j], a.x, acc[0]);
            acc[1] = fmaf(dk[j], a.y, acc[1]);
            acc[2] = fmaf(dk[j], c.x, acc[2]);
            acc[3] = fmaf(dk[j], c.y, acc[3]);
          }
      }
    }
    float* row = out + (size_t)r * kK;
    __stcs(reinterpret_cast<float2*>(row) + lane, make_float2(acc[0], acc[1]));
    __stcs(reinterpret_cast<float2*>(row + 64) + lane, make_float2(acc[2], acc[3]));
  }
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads, 4) pool_bwd_kernel(const int* __restrict__ idx,
                                                               const float* __restrict__ dsel,
                                                               const void* __restrict__ wt,
                                                               const void* __restrict__ x, float* __restrict__ dx,
                                                               float* __restrict__ dwt, int batch, int n_pts,
                                                               int e_total, int dw_blocks, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = (int)blockIdx.x;
  if (i < dw_blocks)
    pool_bwd_dw<kF32>(idx, dsel, x, dwt, batch, n_pts, e_total, i);
  else
    pool_bwd_dx<kF32>(idx, dsel, wt, dx, n_pts, e_total, i - dw_blocks, tiles, smem);
}

// The work split of a K3 call (see Design): the group count that minimizes
// (rounds of clouds a block) x (an item's cost), an item costing its
// channel blocks' products and folds plus half a block's worth for the
// Gram quadrant and the pipeline. At least two groups from E = 256 on, so
// that a warpgroup keeps at most one Gram quadrant beside more than one
// channel block.
struct Plan {
  int group, ngroups, cpg;
};

inline Plan plan(int batch, int e_total, int sms, int max_group) {
  Plan best{0, 0, 0};
  double best_cost = 0.0;
  int ng = (e_total + max_group - 1) / max_group;
  if (e_total >= 256 && ng < 2) ng = 2;
  for (; ng <= e_total / 128; ++ng) {
    const int group = ((e_total + ng - 1) / ng + 127) / 128 * 128;
    const int groups = (e_total + group - 1) / group;
    if (groups == 1 && e_total > 128) continue;
    const int cpg = sms / groups < 1 ? 1 : sms / groups < batch ? sms / groups : batch;
    const double cost = (double)((batch + cpg - 1) / cpg) * (group / 128.0 + 0.5);
    if (best.group == 0 || cost < best_cost - 1e-9) {
      best = Plan{group, groups, cpg};
      best_cost = cost;
    }
  }
  return best;
}

int launch_pack(const void* w, int is_f32, int e_total, void* img, cudaStream_t stream) {
  const int chunks = e_total * 16;
  if (is_f32)
    pack_kernel<true><<<(chunks + 255) / 256, 256, 0, stream>>>(w, e_total, static_cast<uint8_t*>(img));
  else
    pack_kernel<false><<<(chunks + 255) / 256, 256, 0, stream>>>(w, e_total, static_cast<uint8_t*>(img));
  return (int)cudaGetLastError();
}

template <bool kF32, int kQuads>
int launch_stats_kernel(const CUtensorMap& hi, const CUtensorMap& lo, const StatsArgs& args, int blocks,
                        cudaStream_t stream) {
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr int bytes = 1024 + Cfg<kF32>::kSmem;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(pool_stats_kernel<kF32, kQuads>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  pool_stats_kernel<kF32, kQuads><<<blocks, kStatsThreads, bytes, stream>>>(hi, lo, args);
  return (int)cudaGetLastError();
}

template <bool kF32>
int launch_stats(const void* x, const void* w, const float* c, float* mx, float* mn, int* amax, int* amin,
                 float* gpart, float* cspart, float* G, float* colsum, void* img, void* xs, int batch,
                 int n_pts, int e_total, cudaStream_t stream) {
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan p = plan(batch, e_total, sms_of[dev], Cfg<kF32>::kMaxGroup);
  if (p.group == 0) return (int)cudaErrorInvalidValue;
  int e = launch_pack(w, kF32, e_total, img, stream);
  if (e != 0) return e;
  const bf16* x_hi = static_cast<const bf16*>(x);
  const bf16* x_lo = x_hi;
  if constexpr (kF32) {
    const size_t count = (size_t)batch * n_pts * kK;
    bf16* hi = static_cast<bf16*>(xs);
    const size_t threads = count / 8;
    const unsigned grid = threads / 256 + 1 < 8192 ? (unsigned)(threads / 256 + 1) : 8192u;
    split_kernel<<<grid, 256, 0, stream>>>(static_cast<const float4*>(x), reinterpret_cast<uint4*>(hi),
                                           reinterpret_cast<uint4*>(hi + count), count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    x_hi = hi;
    x_lo = hi + count;
  }
  CUtensorMap map_hi, map_lo;
  e = sm90::make_map(&map_hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x_hi, kK, n_pts, batch, 64, Cfg<kF32>::kPts);
  if (e == 0)
    e = sm90::make_map(&map_lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x_lo, kK, n_pts, batch, 64, Cfg<kF32>::kPts);
  if (e != 0) return e;
  const StatsArgs args{static_cast<const uint8_t*>(img), c, mx, mn, amax, amin, gpart, cspart, n_pts, e_total,
                       batch, p.group, p.ngroups, p.cpg};
  const int blocks = p.cpg * p.ngroups;
  e = p.ngroups == 1 ? launch_stats_kernel<kF32, 2>(map_hi, map_lo, args, blocks, stream)
                     : launch_stats_kernel<kF32, 1>(map_hi, map_lo, args, blocks, stream);
  if (e != 0) return e;
  pool_stats_reduce<<<(kK * kK + kK + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
      gpart, cspart, G, colsum, batch);
  return (int)cudaGetLastError();
}

template <bool kF32>
int launch_bwd(const int* idx, const float* dsel, const void* wt, const void* x, float* dx, float* dwt,
               int batch, int n_pts, int e_total, cudaStream_t stream) {
  const int tiles = (n_pts + kRowTile - 1) / kRowTile;
  const int dw_blocks = (2 * e_total + kWarps - 1) / kWarps;  // a warp a half row
  const long long blocks = dw_blocks + (long long)batch * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // under 48 KB (33 KB at E = 4096): no attribute to set
  const int bytes = 8 * e_total + 4 * (kRowTile + kWarps);
  pool_bwd_kernel<kF32><<<(unsigned)blocks, kThreads, bytes, stream>>>(idx, dsel, wt, x, dx, dwt, batch, n_pts,
                                                                      e_total, dw_blocks, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes. All pointers are device pointers to
// contiguous tensors; K = 128. Each returns the CUDA error code of its
// launches (0 on success).
//
// K3's weight pack alone: W (128, E), bf16 (is_f32 = 0) or f32, into img
// (E * 256 bytes, twice that for f32; 16-byte aligned).
extern "C" int pool_stats_pack(const void* w, int is_f32, int e_total, void* img, void* stream) {
  if (e_total <= 0 || e_total % 64 != 0) return (int)cudaErrorInvalidValue;
  return launch_pack(w, is_f32, e_total, img, static_cast<cudaStream_t>(stream));
}

// K3: x (B, N, 128) and W (128, E), both bf16 (is_f32 = 0) or both f32; c (E,) f32; out mx, mn (B, E) f32, amax, amin (B, E) int32, G
// (128, 128) f32, colsum (128,) f32; scratch: gpart (B, 128, 128) and
// cspart (B, 128) f32 for the clouds' partial sums, img (E * 256 bytes, twice that for f32) for the packed weights,
// xs (2 * B * N * 128 bf16) for f32 x's hi and lo (null for bf16). E %
// 128 == 0, N >= 1. Four launches (three for bf16): the pack, the split,
// the statistics, the sum of the partials.
extern "C" int pool_stats(const void* x, const void* w, const float* c, int is_f32, float* mx, float* mn,
                          int* amax, int* amin, float* gpart, float* cspart, float* G, float* colsum, void* img,
                          void* xs, int batch, int n_pts, int e_total, void* stream) {
  if (batch <= 0 || n_pts <= 0 || e_total <= 0 || e_total % 128 != 0 || (is_f32 && xs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_stats<true>(x, w, c, mx, mn, amax, amin, gpart, cspart, G, colsum, img, xs, batch, n_pts,
                                     e_total, s)
                : launch_stats<false>(x, w, c, mx, mn, amax, amin, gpart, cspart, G, colsum, img, xs, batch, n_pts,
                                      e_total, s);
}

// K4: idx (B, E) int32, dsel (B, E) f32, wt = W^T (E, 128) and x (B, N, 128)
// both bf16 (is_f32 = 0) or both f32; out dx (B, N, 128) f32 and dwt =
// dW_sel^T (E, 128) f32. E <= 4096, N < 2^20.
extern "C" int pool_bwd(const int* idx, const float* dsel, const void* wt, const void* x, int is_f32,
                        float* dx, float* dwt, int batch, int n_pts, int e_total, void* stream) {
  if (batch <= 0 || n_pts <= 0 || n_pts >= (1 << 20) || e_total <= 0 || e_total > kMaxE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_bwd<true>(idx, dsel, wt, x, dx, dwt, batch, n_pts, e_total, s)
                : launch_bwd<false>(idx, dsel, wt, x, dx, dwt, batch, n_pts, e_total, s);
}

// K4's dx_sp schedule, as kernels/poolgrad.py states it for the CPU
// emulation: which 0 the rows a block (BWD_ROW_TILE), 1 the warps a block
// (BWD_WARPS), 2 the keys a row loads before their FMAs (BWD_KEY_BATCH);
// -1 for any other.
extern "C" int pool_bwd_schedule(int which) {
  return which == 0 ? kRowTile : which == 1 ? kWarps : which == 2 ? kRowKeys : -1;
}
