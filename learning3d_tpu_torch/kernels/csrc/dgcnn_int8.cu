// Fused int8 eval DGCNN encoder for Hopper (sm_90a), K9: exact kNN, the
// gather of the int8 stage-1 rows, the int8 conv stages 64->64->128->256 with
// requantizing epilogues and a max over the k neighbors after each, and conv5
// 512->emb as one int8 product, in one kernel. x (B, N, 3) f32 and the
// quantized per-point stage-1 product xw1q (B, N, 64) int8 with its scale
// (a device scalar) in, (B, N, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/dgcnn_fused.py::
// dgcnn_encode_fused_int8 (body `_fused_kernel_int8`). Same math as the
// port's plain version `dgcnn_int8_reference`: K5's neighbor selection
// (exact per-coordinate differences (d0*d0 + d1*d1) + d2*d2 by
// __fmul_rn/__fadd_rn, nearest first, ties to the smaller index); the
// neighbor's int8 row of xw1q gathered as it is (the TPU's one-hot matmul
// returns it exactly); e1 = q1(relu(xw1q * s_xw1 + c1)) with c1 = bf16(center)
// . bf16(Wc1) + b1 in f32; stages 2-4 int8 x int8 -> int32 with the epilogue
// relu(acc * swb[0] + swb[1]) and q_i(z) = round(z * inv_s_i) (round half to
// even) clamped to 127; the max over neighbors on the int8 values (values are
// >= 0 after ReLU, so 0 starts it); conv5 int8 against W5 whose rows carry the
// stage scales, relu(acc * s_w5 + b5) rounded to bf16. Every float product
// and sum is written with __fmul_rn/__fadd_rn, so nvcc cannot contract it.
//
// Bound. At B=32, N=1024, k=20, emb=512 the int8 products are 2 * 32,768
// points * [20 * (64*64 + 64*128 + 128*256) + 512*512] MAC = 76 G int8
// operations, about 39 us at the dense int8 tensor-core peak (1,979 TOP/s);
// the output (33.5 MB bf16) takes 10 us at 3.35 TB/s. It is bound by
// operations. Distances and selection add about 0.3 G f32 operations.
//
// Design, K5's (csrc/dgcnn_fused.cu) with int8 operands: mma.sync m16n8k32
// s8 -> s32 from shared memory, int8 tiles in rows padded by 16 bytes.
// * Grid (ceil(N / 64), B): one block of 8 warps per 64 query points.
// * Phase 1, selection, as K5: one warp per query, 64-bit (distance bits,
//   index) keys, each lane's 8 smallest kept in registers, the warp popping
//   heads across lanes.
// * Phase 2, the chain, one neighbor at a time: each thread gathers 16 int8
//   channels of its row's neighbor (one 16-byte load, the next neighbor's in
//   flight during the stages), forms e1, and the stages run on the tensor
//   cores. The running max of every stage stays in registers: e1's as packed
//   int8 quadruples (__vmaxs4), the others as packed 16-bit pairs (__vmaxs2)
//   in the accumulator layout.
// * Phase 3, conv5: the maxes go to shared memory as the (64, 512) int8
//   concatenation; the int8 W5 (256 KB at emb=512) streams through shared
//   memory in slabs of 64 output channels.
// * The int8 weights arrive transposed, (out, in), from the wrapper, which
//   builds them once per model (DGCNNInt8Weights); xw1q and its whole-batch
//   scale are made by the wrapper on the device, so nothing syncs the host.
// * Ragged N: query rows past N select neighbor 0, are computed and are not
//   written.
// * Approximate kNN: the key of K5's approx mode (csrc/dgcnn_fused.cu), from
//   the same per-tile scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
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
constexpr int kLd1 = kC1 + 16;     // padded int8 rows (bytes): stride = 4 mod 32 words
constexpr int kLd2 = kC2 + 16;
constexpr int kLd3 = kC3 + 16;
constexpr int kLdCat = kCat + 16;

struct Args {
  const float* x;       // (B, N, 3)
  const int8_t* xw1q;   // (B, N, 64)
  const float* s_xw1;   // device scalar
  const float* wc1;     // (3, 64) f32, rounded to bf16 here
  const float* b1;      // (64,)
  const int8_t* wt[4];  // conv2..conv5 int8, (out, in)
  const float* swb[4];  // (2, out)
  float inv[4];         // 1 / s1 .. 1 / s4
  bf16* out;            // (B, N, emb)
  const float* knn_scale;  // approx-kNN key scales (csrc/dgcnn_fused.cu's pre-pass), or null
  int n, k, emb, tile_n;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets inside the shared region that follows the index table.
constexpr int kW2 = 0;
constexpr int kW3 = kW2 + kC2 * kLd1;
constexpr int kW4 = kW3 + kC3 * kLd2;
constexpr int kE1 = kW4 + kC4 * kLd3;
constexpr int kZ2 = kE1 + kRows * kLd1;
constexpr int kZ3 = kZ2 + kRows * kLd2;
constexpr int kSwb = kZ3 + kRows * kLd3;
constexpr int kChainBytes = kSwb + 4 * 2 * (kC2 + kC3 + kC4);
constexpr int kCatBytes = kRows * kLdCat;
constexpr int kConv5Bytes = kCatBytes + kSlab * kLdCat;

__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

__host__ __device__ constexpr int select_bytes(int n) { return 4 * 3 * n + 4 * kWarps * n; }

__host__ __device__ constexpr int smem_bytes(int n, int k) {
  return align16(4 * kRows * k) + max3(select_bytes(n), kChainBytes, kConv5Bytes);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of k-step kk (16 rows from m0) of a row-major int8 operand.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* h, int ld, int m0, int kk,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = h + (m0 + g) * ld + kk * 32 + 4 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * ld + 16);
}

__device__ __forceinline__ float epilogue(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// requantize a non-negative activation: round(v * inv) clamped to 127
__device__ __forceinline__ u32 requant(float v, float inv) {
  return static_cast<u32>(min(__float2int_rn(__fmul_rn(v, inv)), 127));
}

// One stage for the warp's 16 rows from m0 and NT 8-column tiles from n0:
// acc = in[m0:m0+16, :K] @ W[:, n0:n0+8NT] with W given as wt[n][k];
// v = requant(relu(acc * s + b)) goes to `out` (unless null) and into the
// running max mx[j] = {row g, row g + 8} as packed 16-bit pairs.
template <int K, int NT>
__device__ __forceinline__ void stage(const int8_t* in, int ldi, const int8_t* wt, int ldw,
                                      const float* swb, int cout, float inv, int8_t* out, int ldo,
                                      uint32_t (&mx)[NT][2], int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[K / 32][4];
#pragma unroll
  for (int kk = 0; kk < K / 32; ++kk) load_a(a[kk], in, ldi, m0, kk, lane);
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += 4) {
    int acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < K / 32; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* q = wt + (n0 + 8 * (j0 + j) + g) * ldw + kk * 32 + 4 * t;
        mma_s8(acc[j], a[kk], ld32(q), ld32(q + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * (j0 + j) + 2 * t;
      const float s0 = swb[c], s1 = swb[c + 1], b0 = swb[cout + c], b1 = swb[cout + c + 1];
      const u32 q00 = requant(fmaxf(epilogue(acc[j][0], s0, b0), 0.f), inv);
      const u32 q01 = requant(fmaxf(epilogue(acc[j][1], s1, b1), 0.f), inv);
      const u32 q10 = requant(fmaxf(epilogue(acc[j][2], s0, b0), 0.f), inv);
      const u32 q11 = requant(fmaxf(epilogue(acc[j][3], s1, b1), 0.f), inv);
      if (out != nullptr) {
        *reinterpret_cast<uint16_t*>(out + (m0 + g) * ldo + c) = static_cast<uint16_t>(q00 | (q01 << 8));
        *reinterpret_cast<uint16_t*>(out + (m0 + g + 8) * ldo + c) = static_cast<uint16_t>(q10 | (q11 << 8));
      }
      mx[j0 + j][0] = __vmaxs2(mx[j0 + j][0], q00 | (q01 << 16));
      mx[j0 + j][1] = __vmaxs2(mx[j0 + j][1], q10 | (q11 << 16));
    }
  }
}

// Copy `rows` rows of `cols` int8 (cols % 16 == 0) from global to padded
// shared rows, 16 bytes at a time.
__device__ __forceinline__ void copy_rows(int8_t* dst, int ld, const int8_t* src, int rows, int cols) {
  const int chunks = cols / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 16;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(src + (size_t)r * cols + c);
  }
}

// Store the running max of one stage (accumulator layout, 16-bit pairs) into
// `cat` as int8.
template <int NT>
__device__ __forceinline__ void store_max(int8_t* cat, const uint32_t (&mx)[NT][2], int col0, int m0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = col0 + n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const u32 v = mx[j][h];
      *reinterpret_cast<uint16_t*>(cat + (m0 + g + 8 * h) * kLdCat + c) =
          static_cast<uint16_t>((v & 0xffu) | ((v >> 8) & 0xff00u));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) dgcnn_encode_int8_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pts = args.n, k = args.k, emb = args.emb;
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int* idx = reinterpret_cast<int*>(smem);
  unsigned char* region = smem + align16(4 * kRows * k);
  const float* xc = args.x + (size_t)cloud * n_pts * 3;

  // The center half of stage 1 for this thread's gather elements: row gr,
  // channels gc..gc+15: c1 = bf16(center) . bf16(Wc1) + b1 in f32.
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
      for (int d = 0; d < 3; ++d) w[d] = __bfloat162float(__float2bfloat16_rn(args.wc1[d * kC1 + gc + i]));
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(cen[0], w[0]), __fmul_rn(cen[1], w[1])),
                                __fmul_rn(cen[2], w[2]));
      c1[i] = __fadd_rn(z, args.b1[gc + i]);
    }
  }

  // ---- phase 1: exact kNN, one warp per query row (as K5) ----
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
          if (lane == 0) idx[r * k + j] = w == kNone ? q : static_cast<int>(w & 0xffffffffu);
          ++j;
          last = w;
          if (w != kNone && l[0] == w) {
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
  int8_t* w2t = reinterpret_cast<int8_t*>(region + kW2);
  int8_t* w3t = reinterpret_cast<int8_t*>(region + kW3);
  int8_t* w4t = reinterpret_cast<int8_t*>(region + kW4);
  int8_t* e1 = reinterpret_cast<int8_t*>(region + kE1);
  int8_t* z2 = reinterpret_cast<int8_t*>(region + kZ2);
  int8_t* z3 = reinterpret_cast<int8_t*>(region + kZ3);
  float* s2 = reinterpret_cast<float*>(region + kSwb);
  float* s3 = s2 + 2 * kC2;
  float* s4 = s3 + 2 * kC3;
  copy_rows(w2t, kLd1, args.wt[0], kC2, kC1);
  copy_rows(w3t, kLd2, args.wt[1], kC3, kC2);
  copy_rows(w4t, kLd3, args.wt[2], kC4, kC3);
  for (int i = threadIdx.x; i < 2 * kC2; i += kThreads) s2[i] = args.swb[0][i];
  for (int i = threadIdx.x; i < 2 * kC3; i += kThreads) s3[i] = args.swb[1][i];
  for (int i = threadIdx.x; i < 2 * kC4; i += kThreads) s4[i] = args.swb[2][i];

  const float s_xw1 = *args.s_xw1;
  const float inv1 = args.inv[0], inv2 = args.inv[1], inv3 = args.inv[2], inv4 = args.inv[3];
  const int8_t* xw1q = args.xw1q + (size_t)cloud * n_pts * kC1;
  uint32_t m1[4], m2[4][2], m3[8][2], m4[16][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) m1[i] = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) m2[i][0] = m2[i][1] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) m3[i][0] = m3[i][1] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i][0] = m4[i][1] = 0u;

  const int m0 = (warp >> 1) * 16;
  uint4 nxt = *reinterpret_cast<const uint4*>(xw1q + (size_t)idx[gr * k] * kC1 + gc);
  for (int j = 0; j < k; ++j) {
    // e1 = q1(relu(xw1q[nbr] * s_xw1 + c1)) for row gr, channels gc..gc+15
    {
      const uint32_t w[4] = {nxt.x, nxt.y, nxt.z, nxt.w};
      uint32_t e[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        u32 packed = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int v = static_cast<int8_t>((w[p] >> (8 * b)) & 0xffu);
          const float z = __fadd_rn(__fmul_rn(__int2float_rn(v), s_xw1), c1[4 * p + b]);
          packed |= requant(fmaxf(z, 0.f), inv1) << (8 * b);
        }
        e[p] = packed;
        m1[p] = __vmaxs4(m1[p], packed);
      }
      *reinterpret_cast<uint4*>(e1 + gr * kLd1 + gc) = make_uint4(e[0], e[1], e[2], e[3]);
      if (j + 1 < k)  // the next neighbor's row, in flight during the stages
        nxt = *reinterpret_cast<const uint4*>(xw1q + (size_t)idx[gr * k + j + 1] * kC1 + gc);
    }
    __syncthreads();
    stage<kC1, 4>(e1, kLd1, w2t, kLd1, s2, kC2, inv2, z2, kLd2, m2, m0, (warp & 1) * 32, lane);
    __syncthreads();
    stage<kC2, 8>(z2, kLd2, w3t, kLd2, s3, kC3, inv3, z3, kLd3, m3, m0, (warp & 1) * 64, lane);
    __syncthreads();
    stage<kC3, 16>(z3, kLd3, w4t, kLd3, s4, kC4, inv4, nullptr, 0, m4, m0, (warp & 1) * 128, lane);
  }
  __syncthreads();  // phase 2's region is reused from here on

  // ---- phase 3: conv5 on the (64, 512) int8 concatenation of the maxes ----
  int8_t* cat = reinterpret_cast<int8_t*>(region);
  int8_t* w5s = reinterpret_cast<int8_t*>(region + kCatBytes);
  *reinterpret_cast<uint4*>(cat + gr * kLdCat + gc) = make_uint4(m1[0], m1[1], m1[2], m1[3]);
  store_max<4>(cat, m2, kC1, m0, (warp & 1) * 32, lane);
  store_max<8>(cat, m3, kC1 + kC2, m0, (warp & 1) * 64, lane);
  store_max<16>(cat, m4, kC1 + kC2 + kC3, m0, (warp & 1) * 128, lane);

  const float* swb5 = args.swb[3];
  bf16* out = args.out + (size_t)cloud * n_pts * emb;
  const int n0 = (warp & 1) * 32;
  const int row_top = q0 + m0 + g, row_bot = row_top + 8;
  for (int s0 = 0; s0 < emb; s0 += kSlab) {
    __syncthreads();  // cat is complete; the previous slab is consumed
    copy_rows(w5s, kLdCat, args.wt[3] + (size_t)s0 * kCat, kSlab, kCat);
    __syncthreads();
    int acc[4][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < kCat / 32; ++kk) {
      uint32_t a[4];
      load_a(a, cat, kLdCat, m0, kk, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* q = w5s + (n0 + 8 * j + g) * kLdCat + kk * 32 + 4 * t;
        mma_s8(acc[j], a, ld32(q), ld32(q + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s0 + n0 + 8 * j + 2 * t;
      const float sa = swb5[c], sb = swb5[c + 1], ba = swb5[emb + c], bb = swb5[emb + c + 1];
      if (row_top < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_top * emb + c) =
            pack_bf16(fmaxf(epilogue(acc[j][0], sa, ba), 0.f), fmaxf(epilogue(acc[j][1], sb, bb), 0.f));
      if (row_bot < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_bot * emb + c) =
            pack_bf16(fmaxf(epilogue(acc[j][2], sa, ba), 0.f), fmaxf(epilogue(acc[j][3], sb, bb), 0.f));
    }
  }
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; xw1q (B, N, 64) int8; s_xw1 a f32 device scalar;
// wc1 (3, 64) f32; b1 (64,) f32; w2t..w5t int8 (out, in) of widths 64x64,
// 128x64, 256x128, emb x 512; swb2..swb5 (2, out) f32; inv1..inv4 the
// reciprocals of the stage scales; out (B, N, emb) bf16; knn_scale null
// (exact kNN) or the scales of dgcnn_knn_scale at tile_n (approximate). Needs
// 1 <= k <= 32, k <= N <= 4096 and emb % 64 == 0. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int dgcnn_encode_int8(const float* x, const void* xw1q, const float* s_xw1,
                                 const float* wc1, const float* b1, const void* w2t,
                                 const float* swb2, const void* w3t, const float* swb3,
                                 const void* w4t, const float* swb4, const void* w5t,
                                 const float* swb5, float inv1, float inv2, float inv3, float inv4,
                                 void* out, const float* knn_scale, int batch, int n_pts, int k, int emb,
                                 int tile_n, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxN || emb <= 0 ||
      emb % kSlab != 0 || tile_n <= 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(n_pts, k);
  cudaError_t err = cudaFuncSetAttribute(dgcnn_encode_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Args args{x,
            static_cast<const int8_t*>(xw1q),
            s_xw1,
            wc1,
            b1,
            {static_cast<const int8_t*>(w2t), static_cast<const int8_t*>(w3t),
             static_cast<const int8_t*>(w4t), static_cast<const int8_t*>(w5t)},
            {swb2, swb3, swb4, swb5},
            {inv1, inv2, inv3, inv4},
            static_cast<bf16*>(out),
            knn_scale,
            n_pts,
            k,
            emb,
            tile_n};
  dim3 grid((n_pts + kRows - 1) / kRows, batch);
  dgcnn_encode_int8_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
