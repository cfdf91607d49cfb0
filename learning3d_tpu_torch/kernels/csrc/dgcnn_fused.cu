// Fused eval-mode DGCNN encoder for Hopper (sm_90a): exact kNN, the edge
// gather, the BN-folded conv stages 6->64->64->128->256 with a max over
// the k neighbors after each, and conv5 512->emb, in one kernel.
// x (B, N, 3) f32 and the per-point stage-1 product xw1 (B, N, 64) bf16 in,
// (B, N, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/dgcnn_fused.py::
// dgcnn_encode_fused (body `_fused_kernel`). Same math as the port's plain
// version `dgcnn_encode_reference`: squared distances as exact per-coordinate
// differences (d0*d0 + d1*d1) + d2*d2, written with __fmul_rn/__fadd_rn so
// that nvcc cannot contract them into FMAs (a contraction changes the
// rounding, a near-tied neighbor swaps, and a whole output row moves);
// neighbors nearest first, ties to the smaller index; bf16 operands, f32
// sums, f32 bias, ReLU, each stage's output rounded to bf16.
//
// Bound. At B=32, N=1024, k=20, emb=512 the conv chain is
// 2 * 32,768 points * [20 * (64*64 + 64*128 + 128*256) + 512*512] MAC
// = 76 GFLOP, about 77 us at the dense bf16 tensor-core peak (989 TFLOP/s);
// the output (33.5 MB bf16) takes 10 us at 3.35 TB/s. So it is bound by
// operations. Distances and selection add about 0.3 G f32 operations on the
// CUDA cores.
//
// Design (simple: mma.sync from shared memory; wgmma/TMA come later). The
// TPU kernel holds the whole (k * 256, C) edge tensor and a one-hot gather
// matrix on chip; an SM has 227 KB, and the 256-wide stage alone would need
// 20 * 64 * 256 * 2 = 655 KB for a 64-row tile. So:
// * Grid (ceil(N / 64), B): one block of 8 warps per 64 query points.
// * Phase 1, selection: the cloud's xyz goes to shared memory; one warp per
//   query writes its N distances to a shared row. Each distance becomes a
//   64-bit key (distance bits, index): for non-negative floats the bits
//   order as the values, so key order is (distance, index) order and ties go
//   to the smaller index by construction. A scan of the row keeps each
//   lane's 8 smallest keys above the last pick in registers; the warp then
//   pops the smallest head across lanes (a shuffle reduction) until k are
//   picked, scanning again only if one lane's 8 were all taken. Candidates
//   past N are never scanned.
// * Phase 2, the chain: the block walks the k neighbors one at a time. For
//   the 64 rows it gathers the neighbor's xw1 row by index (the one-hot
//   product exists only because a TPU has no fast gather; the next
//   neighbor's rows are loaded before the current one's stages run), adds
//   the center half c1 (kept in registers) and runs stages 2-4 on the tensor
//   cores (mma.sync.m16n8k16 bf16 -> f32), the stage outputs going through
//   shared memory as bf16. Each thread owns fixed output elements of every
//   stage, so the running max over neighbors of all four stages (64 x 512)
//   stays in registers as packed bf16 pairs: the max of bf16-rounded values
//   equals the rounding of the max, and ReLU makes 0 a valid start.
// * Phase 3, conv5: the running maxes go to shared memory as the (64, 512)
//   bf16 concatenation; W5 (512 x emb, 512 KB at emb=512, more than an SM
//   holds) is streamed through shared memory in slabs of 64 output channels
//   and each slab's product, bias and ReLU are written straight to the
//   output. One launch does all three phases.
// * The three phases share one region of shared memory (140 KB at N=1024),
//   so one block is resident per SM.
// * Ragged N: query rows past N select neighbor 0, are computed and are not
//   written.
// * Approximate kNN (the TPU kernel's `approx_knn`): the high word of the
//   key is int(trunc(d * scale)) instead of d's bits, scale = f32(levels) /
//   max(maxd, 1e-20), levels = 2^(30 - bitlen(Np - 1)) - 1, so that near
//   ties inside one distance bucket go to the smaller index. maxd is the
//   largest distance over the TPU kernel's whole query tile (tile_n =
//   min(256, round_up(N, 128)) rows, zero-padded rows included, Np =
//   round_up(N, tile_n)) and the valid columns: a pre-pass,
//   `knn_tile_scale`, takes it per (cloud, tile) into `knn_scale`, which
//   K9 (csrc/dgcnn_int8.cu) reads too. Ordering by (bucket, index) is
//   ordering by the TPU kernel's int32 key bucket * Np + col, so the same
//   scan picks the same neighbors. A null `knn_scale` is exact kNN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int kRows = 64;  // query points per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kC1 = 64, kC2 = 64, kC3 = 128, kC4 = 256, kCat = 512;
constexpr int kMaxK = 32;
constexpr int kMaxN = 4096;
constexpr int kT = 8;              // selection: sorted keys each lane keeps per scan
constexpr u64 kNone = ~0ull;
constexpr int kSlab = 64;          // conv5 output channels per W5 slab
constexpr int kLd1 = kC1 + 8;      // padded rows (bf16 elements): conflict-free fragments
constexpr int kLd2 = kC2 + 8;
constexpr int kLd3 = kC3 + 8;
constexpr int kLdCat = kCat + 8;

struct Args {
  const float* x;     // (B, N, 3)
  const bf16* xw1;    // (B, N, 64)
  const float* wc1;   // (3, 64) f32, rounded to bf16 here
  const float* b1;    // (64,)
  const bf16* wt[4];  // stages 2..5 as (out, in) bf16
  const float* b[4];  // their biases, f32
  bf16* out;          // (B, N, emb)
  const float* knn_scale;  // (B, ceil(N / tile_n)) approx-kNN key scales, or null (exact)
  int n, k, emb, tile_n;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets inside the shared region that follows the index table.
constexpr int kW2 = 0;
constexpr int kW3 = kW2 + 2 * kC2 * kLd1;
constexpr int kW4 = kW3 + 2 * kC3 * kLd2;
constexpr int kE1 = kW4 + 2 * kC4 * kLd3;
constexpr int kZ2 = kE1 + 2 * kRows * kLd1;
constexpr int kZ3 = kZ2 + 2 * kRows * kLd2;
constexpr int kBias = kZ3 + 2 * kRows * kLd3;
constexpr int kChainBytes = kBias + 4 * (kC2 + kC3 + kC4);
constexpr int kCatBytes = 2 * kRows * kLdCat;
constexpr int kConv5Bytes = kCatBytes + 2 * kSlab * kLdCat;

__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

__host__ __device__ constexpr int select_bytes(int n) { return 4 * 3 * n + 4 * kWarps * n; }

__host__ __device__ constexpr int smem_bytes(int n, int k) {
  return align16(4 * kRows * k) + max3(select_bytes(n), kChainBytes, kConv5Bytes);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to a bf16 pair, the first in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Elementwise max of two bf16 pairs.
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  bf162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const bf162 r = __hmax2(x, y);
  uint32_t u;
  memcpy(&u, &r, 4);
  return u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of k-step kk (16 rows from m0) of a row-major bf16 operand.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* h, int ld, int m0,
                                       int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = h + (m0 + g) * ld + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// One stage for the warp's 16 rows from m0 and NT 8-column tiles from n0:
// acc = in[m0:m0+16, :K] @ W[:, n0:n0+8NT] with W given as wt[n][k];
// v = bf16(relu(acc + bias)) goes to `out` (unless null) and into the
// running max mx[j] = {rows g, rows g + 8} as packed bf16 pairs.
template <int K, int NT>
__device__ __forceinline__ void stage(const bf16* in, int ldi, const bf16* wt, int ldw,
                                      const float* bias, bf16* out, int ldo, uint32_t (&mx)[NT][2],
                                      int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) load_a(a[kk], in, ldi, m0, kk, lane);
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += 4) {
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* q = wt + (n0 + 8 * (j0 + j) + g) * ldw + kk * 16 + 2 * t;
        mma_bf16(acc[j], a[kk], ld32(q), ld32(q + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * (j0 + j) + 2 * t;
      const float bb0 = bias[c], bb1 = bias[c + 1];
      const uint32_t top = pack(fmaxf(acc[j][0] + bb0, 0.f), fmaxf(acc[j][1] + bb1, 0.f));
      const uint32_t bot = pack(fmaxf(acc[j][2] + bb0, 0.f), fmaxf(acc[j][3] + bb1, 0.f));
      if (out != nullptr) {
        *reinterpret_cast<uint32_t*>(out + (m0 + g) * ldo + c) = top;
        *reinterpret_cast<uint32_t*>(out + (m0 + g + 8) * ldo + c) = bot;
      }
      mx[j0 + j][0] = bmax2(mx[j0 + j][0], top);
      mx[j0 + j][1] = bmax2(mx[j0 + j][1], bot);
    }
  }
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) from global to padded
// shared rows, 16 bytes at a time.
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, int rows, int cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * cols + c);
  }
}

// Store the running max of one stage (accumulator layout) into `cat`.
template <int NT>
__device__ __forceinline__ void store_max(bf16* cat, const uint32_t (&mx)[NT][2], int col0,
                                          int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + n0 + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(cat + (m0 + g) * kLdCat + c) = mx[j][0];
    *reinterpret_cast<uint32_t*>(cat + (m0 + g + 8) * kLdCat + c) = mx[j][1];
  }
}

__global__ void __launch_bounds__(kThreads, 1) dgcnn_encode_bf16_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pts = args.n, k = args.k, emb = args.emb;
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int* idx = reinterpret_cast<int*>(smem);
  unsigned char* region = smem + align16(4 * kRows * k);
  const float* xc = args.x + (size_t)cloud * n_pts * 3;

  // The center half of stage 1 for this thread's gather elements: row
  // gr, channels gc..gc+15: c1 = bf16(center) . bf16(Wc1) + b1 in f32.
  const int gr = threadIdx.x >> 2, gc = (threadIdx.x & 3) * 16;
  float c1[16];
  {
    float cen[3] = {0.f, 0.f, 0.f};
    if (q0 + gr < n_pts)
      for (int d = 0; d < 3; ++d)
        cen[d] = __bfloat162float(__float2bfloat16_rn(xc[(size_t)(q0 + gr) * 3 + d]));
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float w[3];
      for (int d = 0; d < 3; ++d)
        w[d] = __bfloat162float(__float2bfloat16_rn(args.wc1[d * kC1 + gc + i]));
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(cen[0], w[0]), __fmul_rn(cen[1], w[1])),
                                __fmul_rn(cen[2], w[2]));
      c1[i] = __fadd_rn(z, args.b1[gc + i]);
    }
  }

  // ---- phase 1: exact kNN, one warp per query row ----
  {
    float* px = reinterpret_cast<float*>(region);
    float* py = px + n_pts;
    float* pz = py + n_pts;
    float* dist = pz + n_pts + warp * n_pts;
    for (int i = threadIdx.x; i < n_pts * 3; i += kThreads) {
      const int p = i / 3, d = i - 3 * p;
      (d == 0 ? px : d == 1 ? py : pz)[p] = xc[i];
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int q = q0 + r;
      if (q >= n_pts) {
        if (lane < k) idx[r * k + lane] = 0;
        continue;
      }
      const float qx = px[q], qy = py[q], qz = pz[q];
      const float kscale =
          args.knn_scale == nullptr ? 0.f : args.knn_scale[(size_t)cloud * ((n_pts + args.tile_n - 1) / args.tile_n) +
                                                           q / args.tile_n];
      for (int i = lane; i < n_pts; i += 32) {
        const float d0 = __fsub_rn(qx, px[i]), d1 = __fsub_rn(qy, py[i]), d2 = __fsub_rn(qz, pz[i]);
        dist[i] = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      }
      __syncwarp();
      // Keys (distance bits << 32 | index): for d >= 0 a float's bits order
      // as its value, so key order is (distance, index) order. A scan keeps
      // each lane's kT smallest keys above the last pick, sorted, in
      // registers; picks then pop the warp-wide smallest head until k are
      // picked or a lane has popped its whole list (its next key is unknown
      // until the next scan). One scan usually yields all k.
      u64 last = 0;
      int j = 0;
      while (j < k) {
        u64 l[kT];
#pragma unroll
        for (int p = 0; p < kT; ++p) l[p] = kNone;
        for (int i = lane; i < n_pts; i += 32) {
          const u32 hi = kscale > 0.f ? static_cast<u32>(__float2int_rz(__fmul_rn(dist[i], kscale)))
                                      : __float_as_uint(dist[i]);
          const u64 key = (static_cast<u64>(hi) << 32) | static_cast<u32>(i);
          if ((j == 0 || key > last) && key < l[kT - 1]) {
#pragma unroll
            for (int p = kT - 1; p > 0; --p) l[p] = key < l[p - 1] ? l[p - 1] : (key < l[p] ? key : l[p]);
            l[0] = key < l[0] ? key : l[0];
          }
        }
        int popped = 0;
        while (j < k) {
          u64 w = l[0];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const u64 o = __shfl_xor_sync(0xffffffffu, w, off);
            w = o < w ? o : w;
          }
          // kNone only once no key is left, which N >= k rules out
          if (lane == 0) idx[r * k + j] = w == kNone ? q : static_cast<int>(w & 0xffffffffu);
          ++j;
          last = w;
          if (w != kNone && l[0] == w) {  // the owner pops its head
#pragma unroll
            for (int p = 0; p < kT - 1; ++p) l[p] = l[p + 1];
            l[kT - 1] = kNone;
            ++popped;
          }
          if (__any_sync(0xffffffffu, popped == kT)) break;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();  // phase 1's region is reused from here on

  // ---- phase 2: the chain, one neighbor at a time ----
  bf16* w2t = reinterpret_cast<bf16*>(region + kW2);
  bf16* w3t = reinterpret_cast<bf16*>(region + kW3);
  bf16* w4t = reinterpret_cast<bf16*>(region + kW4);
  bf16* e1 = reinterpret_cast<bf16*>(region + kE1);
  bf16* z2 = reinterpret_cast<bf16*>(region + kZ2);
  bf16* z3 = reinterpret_cast<bf16*>(region + kZ3);
  float* b2 = reinterpret_cast<float*>(region + kBias);
  float* b3 = b2 + kC2;
  float* b4 = b3 + kC3;
  copy_rows(w2t, kLd1, args.wt[0], kC2, kC1);
  copy_rows(w3t, kLd2, args.wt[1], kC3, kC2);
  copy_rows(w4t, kLd3, args.wt[2], kC4, kC3);
  for (int i = threadIdx.x; i < kC2; i += kThreads) b2[i] = args.b[0][i];
  for (int i = threadIdx.x; i < kC3; i += kThreads) b3[i] = args.b[1][i];
  for (int i = threadIdx.x; i < kC4; i += kThreads) b4[i] = args.b[2][i];

  const bf16* xw1 = args.xw1 + (size_t)cloud * n_pts * kC1;
  uint32_t m1[8], m2[4][2], m3[8][2], m4[16][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) m1[i] = 0u;  // bf16 +0.0 pairs
#pragma unroll
  for (int i = 0; i < 4; ++i) m2[i][0] = m2[i][1] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) m3[i][0] = m3[i][1] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i][0] = m4[i][1] = 0u;

  const int m0 = (warp >> 1) * 16;
  uint4 nxt[2];
  {
    const uint4* src = reinterpret_cast<const uint4*>(xw1 + (size_t)idx[gr * k] * kC1 + gc);
    nxt[0] = src[0];
    nxt[1] = src[1];
  }
  for (int j = 0; j < k; ++j) {
    // e1 = bf16(relu(xw1[nbr] + c1)) for row gr, channels gc..gc+15
    {
      const uint32_t w[8] = {nxt[0].x, nxt[0].y, nxt[0].z, nxt[0].w,
                             nxt[1].x, nxt[1].y, nxt[1].z, nxt[1].w};
      uint32_t e[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        e[p] = pack(fmaxf(lo_f32(w[p]) + c1[2 * p], 0.f), fmaxf(hi_f32(w[p]) + c1[2 * p + 1], 0.f));
        m1[p] = bmax2(m1[p], e[p]);
      }
      uint4* dst = reinterpret_cast<uint4*>(e1 + gr * kLd1 + gc);
      dst[0] = make_uint4(e[0], e[1], e[2], e[3]);
      dst[1] = make_uint4(e[4], e[5], e[6], e[7]);
      if (j + 1 < k) {  // the next neighbor's rows, in flight during the stages
        const uint4* src =
            reinterpret_cast<const uint4*>(xw1 + (size_t)idx[gr * k + j + 1] * kC1 + gc);
        nxt[0] = src[0];
        nxt[1] = src[1];
      }
    }
    __syncthreads();
    stage<kC1, 4>(e1, kLd1, w2t, kLd1, b2, z2, kLd2, m2, m0, (warp & 1) * 32, lane);
    __syncthreads();
    stage<kC2, 8>(z2, kLd2, w3t, kLd2, b3, z3, kLd3, m3, m0, (warp & 1) * 64, lane);
    __syncthreads();
    stage<kC3, 16>(z3, kLd3, w4t, kLd3, b4, nullptr, 0, m4, m0, (warp & 1) * 128, lane);
  }
  __syncthreads();  // phase 2's region is reused from here on

  // ---- phase 3: conv5 on the (64, 512) concatenation of the maxes ----
  bf16* cat = reinterpret_cast<bf16*>(region);
  bf16* w5s = reinterpret_cast<bf16*>(region + kCatBytes);
  {
    uint4* dst = reinterpret_cast<uint4*>(cat + gr * kLdCat + gc);
    dst[0] = make_uint4(m1[0], m1[1], m1[2], m1[3]);
    dst[1] = make_uint4(m1[4], m1[5], m1[6], m1[7]);
  }
  store_max<4>(cat, m2, kC1, m0, (warp & 1) * 32, lane);
  store_max<8>(cat, m3, kC1 + kC2, m0, (warp & 1) * 64, lane);
  store_max<16>(cat, m4, kC1 + kC2 + kC3, m0, (warp & 1) * 128, lane);

  const float* b5 = args.b[3];
  bf16* out = args.out + (size_t)cloud * n_pts * emb;
  const int n0 = (warp & 1) * 32;
  const int row_top = q0 + m0 + g, row_bot = row_top + 8;
  for (int s0 = 0; s0 < emb; s0 += kSlab) {
    __syncthreads();  // cat is complete; the previous slab is consumed
    copy_rows(w5s, kLdCat, args.wt[3] + (size_t)s0 * kCat, kSlab, kCat);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < kCat / 16; ++kk) {
      uint32_t a[4];
      load_a(a, cat, kLdCat, m0, kk, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* q = w5s + (n0 + 8 * j + g) * kLdCat + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, ld32(q), ld32(q + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s0 + n0 + 8 * j + 2 * t;
      const float bb0 = b5[c], bb1 = b5[c + 1];
      if (row_top < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_top * emb + c) =
            pack(fmaxf(acc[j][0] + bb0, 0.f), fmaxf(acc[j][1] + bb1, 0.f));
      if (row_bot < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_bot * emb + c) =
            pack(fmaxf(acc[j][2] + bb0, 0.f), fmaxf(acc[j][3] + bb1, 0.f));
    }
  }
}

// Approx-kNN key scale of each (cloud, query tile): grid (tiles, B). maxd
// over the tile's rows (rows past N are the origin, as the TPU kernel pads
// them) and the N valid columns, then f32(levels) / max(maxd, 1e-20). A
// thread takes a row against the cloud, which the block holds in shared
// memory (12 N bytes; every thread reads the same column at once).
__global__ void __launch_bounds__(kThreads) knn_tile_scale_kernel(const float* x, float* scale, int n_pts,
                                                                  int tile_n, float levels) {
  extern __shared__ float pts[];
  __shared__ float red[kWarps];
  const float* xc = x + (size_t)blockIdx.y * n_pts * 3;
  for (int i = threadIdx.x; i < 3 * n_pts; i += kThreads) pts[i] = xc[i];
  __syncthreads();
  float mx = 0.f;
  for (int r = blockIdx.x * tile_n + threadIdx.x; r < (blockIdx.x + 1) * tile_n; r += kThreads) {
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
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
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
  if (bytes + 4 * kWarps > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_tile_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 12 * kMaxN);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n_pts + tile_n - 1) / tile_n, batch);
  knn_tile_scale_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(x, scale, n_pts, tile_n,
                                                                                     levels);
  return (int)cudaGetLastError();
}

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; xw1 (B, N, 64) bf16; wc1 (3, 64) f32; b1 (64,)
// f32; w2t..w5t (out, in) bf16 of widths 64x64, 128x64, 256x128, emb x 512;
// b2..b5 f32; out (B, N, emb) bf16; knn_scale null (exact kNN) or the
// (B, ceil(N / tile_n)) scales of dgcnn_knn_scale (approximate). Needs 1 <=
// k <= 32, k <= N <= 4096 and emb % 64 == 0. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int dgcnn_encode_bf16(const float* x, const void* xw1, const float* wc1,
                                 const float* b1, const void* w2t, const float* b2,
                                 const void* w3t, const float* b3, const void* w4t,
                                 const float* b4, const void* w5t, const float* b5, void* out,
                                 const float* knn_scale, int batch, int n_pts, int k, int emb,
                                 int tile_n, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxN || emb <= 0 ||
      emb % kSlab != 0 || tile_n <= 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(n_pts, k);
  cudaError_t err = cudaFuncSetAttribute(dgcnn_encode_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Args args{x,
            static_cast<const bf16*>(xw1),
            wc1,
            b1,
            {static_cast<const bf16*>(w2t), static_cast<const bf16*>(w3t),
             static_cast<const bf16*>(w4t), static_cast<const bf16*>(w5t)},
            {b2, b3, b4, b5},
            static_cast<bf16*>(out),
            knn_scale,
            n_pts,
            k,
            emb,
            tile_n};
  dim3 grid((n_pts + kRows - 1) / kRows, batch);
  dgcnn_encode_bf16_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
