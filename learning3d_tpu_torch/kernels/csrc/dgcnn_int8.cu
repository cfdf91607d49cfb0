// Fused int8 eval DGCNN encoder for Hopper (sm_90a), K9: exact kNN, the
// gather of the int8 stage-1 rows, the int8 conv stages 64->64->128->256 with
// requantizing epilogues and a max over the k neighbors after each, and conv5
// 512->emb as one int8 product, in one kernel. x (B, N, 3) f32 and the
// quantized per-point stage-1 product xw1q (B, N, 64) int8 with its scale
// (a device scalar) in, (B, N, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/dgcnn_fused.py::
// dgcnn_encode_fused_int8 (body `_fused_kernel_int8`). Same math as the
// port's plain version `dgcnn_int8_reference`: the neighbor selection shared
// with K5 (dgcnn_select.cu: exact per-coordinate differences (d0*d0 + d1*d1)
// + d2*d2 by __fmul_rn/__fadd_rn, nearest first, ties to the smaller index); the
// neighbor's int8 row of xw1q gathered as it is (the TPU's one-hot matmul
// returns it exactly); e1 = q1(relu(xw1q * s_xw1 + c1)) with c1 = bf16(center)
// . bf16(Wc1) + b1 in f32; stages 2-4 int8 x int8 -> int32 with the epilogue
// relu(acc * swb[0] + swb[1]) and q_i(z) = round(z * inv_s_i) (round half to
// even) clamped to 127; the max over neighbors on the int8 values (values are
// >= 0 after ReLU, so 0 starts it); conv5 int8 against W5 whose rows carry the
// stage scales, relu(acc * s_w5 + b5) rounded to bf16. Every float product
// and sum is written with __fmul_rn/__fadd_rn, so nvcc cannot contract it.
// Integer products sum exactly in any order, so the kernel is bit for bit
// the plain version.
//
// Bound. At B=32, N=1024, k=20, emb=512 the int8 products are 2 * 32,768
// points * [20 * (64*64 + 64*128 + 128*256) + 512*512] MAC = 76 G int8
// operations, about 39 us at the dense int8 tensor-core peak (1,979 TOP/s);
// the output (33.5 MB bf16) takes 10 us at 3.35 TB/s. It is bound by
// operations. Distances and selection add about 0.3 G f32 operations. What
// sets the time is the CUDA cores' work around the products: the 448
// requantized outputs of a row and neighbor (~9 instructions each) and the
// selection.
//
// Design: two launches over the grid (ceil(N / 64), B), one warpgroup (128
// threads) a block of 64 query points. The selection (dgcnn_select.cu,
// shared with K5) is latency-bound on warp-wide operations and wants many
// warps an SM; the
// chain (dgcnn_encode_int8_kernel) wants registers: two blocks an SM, at
// most 255 registers a thread (at three blocks, 168 registers spilled and
// ran slower), ~71 KB of shared memory. The neighbors pass between them
// through a (B, N, k) int32 scratch. Before them the wrapper quantizes
// xw1 with two small kernels of this file (dgcnn_quant_xw1), which take
// the place of torch's chain of elementwise and reduction launches.
// * The weights arrive packed once per model (DGCNNInt8Weights) in wgmma's
//   128-byte-swizzled K-major image: W2^T | W3^T side by side in 128-byte
//   rows (16 KB), W4^T (32 KB), W5^T in slabs of 32 output channels (16 KB
//   each); one bulk copy (TMA) brings W2-W4 while the block reads its
//   neighbors and forms c1.
// * The chain, one neighbor at a time, on int8 wgmma with A from registers,
//   no barrier at all: each thread forms its own A fragments of e1 (rows g
//   and g + 8 of its warp's 16, four gathered 4-byte words a row, the next
//   neighbor's in flight), stage 2 is m64n64k32 x 2, stage 3 two m64n64
//   halves, stage 4 four m64n64 quarters. A stage's accumulators become the
//   next stage's A fragments in the thread that holds them: the next
//   weights' contracted index is permuted into the accumulator layout's
//   key order (attention_sm90.cuh's s8_pack_p; position 16h + 4t + i of a
//   16-channel group holds channel 16h + 2t + i for i < 2, 16h + 8 + 2t + i
//   - 2 for i >= 2), so no value crosses a lane. The epilogues round
//   to integers with the 1.5 * 2^23 trick on the FP32 pipe (adding 1.5 *
//   2^23 leaves the integer, rounded half to even, in the low bits) instead
//   of a float-to-int conversion; the accumulators become floats by
//   __int2float_rn, which measured faster than the same trick backwards.
// * The running max of every stage is packed int8 in A-fragment layout:
//   e1, z2 and z3 in registers, z4 (32 registers' worth) in shared memory,
//   128 bytes a thread.
// * conv5: the maxes are the A fragments of the (64, 512) concatenation; W5
//   streams through a 3-slab ring (cp.async.bulk into the freed weight
//   region, mbarriers), m64n32k32 x 16 a slab, the next slabs in flight.
// * Approximate kNN: the key of K5's approx mode (csrc/dgcnn_fused.cu), from
//   the same per-tile scales.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "dgcnn_select.cuh"

namespace {

using sm90::desc_sw128;
using sm90::fence_operands;

typedef __nv_bfloat16 bf16;
typedef unsigned int u32;

constexpr int kRows = 64;  // query points a block: one warpgroup's m64
constexpr int kThreads = 128;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kC1 = 64;
constexpr int kCat = 512;
constexpr int kMaxK = 32;
constexpr int kMaxN = 4096;
constexpr int kW23Bytes = 16384;  // W2^T (k 0..63) | W3^T (k 64..127), 128 rows of 128 bytes
constexpr int kW4Bytes = 32768;   // W4^T, 256 rows of 128 bytes
constexpr int kHalf = 8192;       // 64 rows of 128 bytes: an n64 B operand
constexpr int kSlabCols = 32;     // conv5 output channels a W5 slab
constexpr int kSlabBytes = kSlabCols * kCat;
constexpr int kStages = (kW23Bytes + kW4Bytes) / kSlabBytes;  // the ring in the weight region
constexpr int kM4Chunks = 8;                                  // z4's max: 8 A-fragment chunks a thread
constexpr int kM4Bytes = kThreads * kM4Chunks * 16;
constexpr u32 kMagicI = 0x4B400000u;  // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;        // (B, N, 3)
  const int8_t* xw1q;    // (B, N, 64)
  const float* s_xw1;    // device scalar
  const float* wc1;      // (3, 64) f32, rounded to bf16 here
  const float* b1;       // (64,)
  const uint8_t* w23;    // the packed images (DGCNNInt8Weights)
  const uint8_t* w4;
  const uint8_t* w5;
  const float* swb[4];   // (2, out): conv2..conv5
  float inv[4];          // 1 / s1 .. 1 / s4
  bf16* out;             // (B, N, emb)
  const int* idx;        // (B, N, k): dgcnn_select's neighbors
  int n, k, emb;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// The main kernel's dynamic shared memory past the 1024-byte alignment: the
// weights (then conv5's ring), z4's max, the index table and four
// mbarriers (the weights', the ring's three).
__host__ __device__ constexpr int smem_bytes(int k) {
  return kW23Bytes + kW4Bytes + kM4Bytes + align16(4 * kRows * k) + 4 * 8;
}

// requant(z) = round(min(relu(z) * inv, 127)), round half to even, in the
// low byte of the result's bits (adding 1.5 * 2^23 rounds to an integer).
__device__ __forceinline__ u32 requant_bits(float z, float inv) {
  return __float_as_uint(__fadd_rn(fminf(__fmul_rn(fmaxf(z, 0.f), inv), 127.f), kMagicF));
}

// The low bytes of four values, in order.
__device__ __forceinline__ u32 pack4(u32 a, u32 b, u32 c, u32 d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// e1 for four channels of one gathered word: q1(relu(v * s + c1)). Each
// byte v + 128 (the word xor 0x80808080) goes into the low byte of 1.5 *
// 2^23's bits, whose float is then 1.5 * 2^23 + 128 + v exactly.
__device__ __forceinline__ u32 e1_word(u32 w, const float* c1, float s, float inv) {
  const u32 u = w ^ 0x80808080u;
  u32 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __fsub_rn(__uint_as_float(__byte_perm(u, kMagicI, 0x7650 + i)), kMagicF + 128.f);
    q[i] = requant_bits(__fadd_rn(__fmul_rn(v, s), c1[i]), inv);
  }
  return pack4(q[0], q[1], q[2], q[3]);
}

// An m64n64 s32 accumulator (columns col0.. of a stage of `cout` outputs)
// requantized and packed as the A fragments of two 32-channel chunks, in
// key order: of chunk c, accumulators 16c + {0, 1, 4, 5}, {2, 3, 6, 7},
// {8, 9, 12, 13}, {10, 11, 14, 15} (rows g, g + 8, g, g + 8).
__device__ __forceinline__ void requant_pack(uint32_t (*a)[4], const int (&acc)[32], const float* __restrict__ swb,
                                             int cout, int col0, float inv, int t) {
  u32 q[32];
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int c = col0 + 8 * jb + 2 * t;
    const float2 s = __ldg(reinterpret_cast<const float2*>(swb + c));
    const float2 b = __ldg(reinterpret_cast<const float2*>(swb + cout + c));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[4 * jb + e] = requant_bits(
          __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * jb + e]), (e & 1) ? s.y : s.x), (e & 1) ? b.y : b.x), inv);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int b = 16 * c;
    a[c][0] = pack4(q[b], q[b + 1], q[b + 4], q[b + 5]);
    a[c][1] = pack4(q[b + 2], q[b + 3], q[b + 6], q[b + 7]);
    a[c][2] = pack4(q[b + 8], q[b + 9], q[b + 12], q[b + 13]);
    a[c][3] = pack4(q[b + 10], q[b + 11], q[b + 14], q[b + 15]);
  }
}

template <int C>
__device__ __forceinline__ void max_into(uint32_t (*m)[4], const uint32_t (*a)[4]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[c][r] = __vmaxu4(m[c][r], a[c][r]);
}

// One n64 product of a stage: acc = A (C chunks from registers) . B (the
// descriptor's 64 rows, k-step c at +32 bytes), waited for.
template <int C>
__device__ __forceinline__ void product_n64(int (&acc)[32], const uint32_t (*a)[4], uint64_t desc) {
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c) sm90::mma_s8_rs_n64(acc, a[c], desc + 2 * c, c > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_operands(acc);
}

__global__ void __launch_bounds__(kThreads, 2) dgcnn_encode_int8_kernel(Args args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int n_pts = args.n, k = args.k, emb = args.emb;
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  uint8_t* wts = smem;                                   // W2|W3, W4; then conv5's ring
  uint4* m4s = reinterpret_cast<uint4*>(smem + kW23Bytes + kW4Bytes);  // z4's max: chunk c of thread tid at c * kThreads + tid
  int* idx = reinterpret_cast<int*>(smem + kW23Bytes + kW4Bytes + kM4Bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(idx) + align16(4 * kRows * k));  // the weights', the ring's three
  const float* xc = args.x + (size_t)cloud * n_pts * 3;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) sm90::bar_init(bars + i, 1);
    sm90::bar_fence_init();
  }
  // the block's rows of the index table (rows past N: neighbor 0)
  for (int i = tid; i < kRows * k; i += kThreads) {
    const int q = q0 + i / k;
    idx[i] = q < n_pts ? args.idx[((size_t)cloud * n_pts + q0) * k + i] : 0;
  }
#pragma unroll
  for (int c = 0; c < kM4Chunks; ++c) m4s[c * kThreads + tid] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) {
    sm90::bar_expect_tx(bars, kW23Bytes + kW4Bytes);
    sm90::bulk_load(wts, args.w23, kW23Bytes, bars);
    sm90::bulk_load(wts + kW23Bytes, args.w4, kW4Bytes, bars);
  }

  // the center half of stage 1 for this thread's A-fragment elements: rows
  // 16 warp + g + 8h, channels 32c + 16e + 4t + i: c1 = bf16(center) .
  // bf16(Wc1) + b1 in f32, at c1v[h][8c + 4e + i]
  const int row = kRowsPerWarp * warp + g;
  float c1v[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cen[3] = {0.f, 0.f, 0.f};
    if (q0 + row + 8 * h < n_pts)
      for (int d = 0; d < 3; ++d)
        cen[d] = __bfloat162float(__float2bfloat16_rn(xc[(size_t)(q0 + row + 8 * h) * 3 + d]));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ch = 32 * (j >> 3) + 16 * ((j >> 2) & 1) + 4 * t + (j & 3);
      float w[3];
      for (int d = 0; d < 3; ++d) w[d] = __bfloat162float(__float2bfloat16_rn(args.wc1[d * kC1 + ch]));
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(cen[0], w[0]), __fmul_rn(cen[1], w[1])),
                                __fmul_rn(cen[2], w[2]));
      c1v[h][j] = __fadd_rn(z, args.b1[ch]);
    }
  }
  // ---- phase 2: the chain, one neighbor at a time ----
  uint32_t m1[2][4], m2[2][4], m3[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m1[0][r] = m1[1][r] = m2[0][r] = m2[1][r] = 0u;
    m3[0][r] = m3[1][r] = m3[2][r] = m3[3][r] = 0u;
  }
  const float s_xw1 = *args.s_xw1;
  const int8_t* xw1q = args.xw1q + (size_t)cloud * n_pts * kC1 + 4 * t;
  const int* nbr0 = idx + row * k;
  const int* nbr1 = idx + (row + 8) * k;
  // gathered words [h][c][e]: row + 8h's neighbor, channels 32c + 16e + 4t..
  u32 nxt[2][2][2];
  auto gather = [&](int j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* src = xw1q + (size_t)(h ? nbr1 : nbr0)[j] * kC1;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) nxt[h][c][e] = __ldg(reinterpret_cast<const u32*>(src + 32 * c + 16 * e));
    }
  };
  gather(0);
  sm90::bar_wait(bars, 0);
  const uint64_t d_w23 = desc_sw128(wts, 16), d_w4 = desc_sw128(wts + kW23Bytes, 16);
  const float inv1 = args.inv[0], inv2 = args.inv[1], inv3 = args.inv[2], inv4 = args.inv[3];
  for (int j = 0; j < k; ++j) {
    uint32_t a2[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) a2[c][h + 2 * e] = e1_word(nxt[h][c][e], &c1v[h][8 * c + 4 * e], s_xw1, inv1);
    max_into<2>(m1, a2);
    if (j + 1 < k) gather(j + 1);  // in flight during the stages

    int acc[32];
    uint32_t a3[2][4], a4[4][4];
    product_n64<2>(acc, a2, d_w23);  // stage 2: k bytes 0..63 of rows 0..63
    requant_pack(a3, acc, args.swb[0], 64, 0, inv2, t);
    max_into<2>(m2, a3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // stage 3: k bytes 64..127 of rows 64 hf..
      product_n64<2>(acc, a3, d_w23 + hf * (kHalf >> 4) + 4);
      requant_pack(a4 + 2 * hf, acc, args.swb[1], 128, 64 * hf, inv3, t);
    }
    max_into<4>(m3, a4);
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {  // stage 4: rows 64 qr.. of W4^T
      product_n64<4>(acc, a4, d_w4 + qr * (kHalf >> 4));
      uint32_t z4[2][4];
      requant_pack(z4, acc, args.swb[2], 256, 64 * qr, inv4, t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint4 m = m4s[(2 * qr + c) * kThreads + tid];
        m.x = __vmaxu4(m.x, z4[c][0]);
        m.y = __vmaxu4(m.y, z4[c][1]);
        m.z = __vmaxu4(m.z, z4[c][2]);
        m.w = __vmaxu4(m.w, z4[c][3]);
        m4s[(2 * qr + c) * kThreads + tid] = m;
      }
    }
  }

  // ---- phase 3: conv5 on the (64, 512) int8 concatenation of the maxes ----
  __syncthreads();  // every warp's products are done with the weight region
  const int nslabs = emb / kSlabCols;
  uint64_t* full = bars + 1;
  if (tid == 0)
    for (int s = 0; s < kStages && s < nslabs; ++s) {
      sm90::bar_expect_tx(full + s, kSlabBytes);
      sm90::bulk_load(wts + s * kSlabBytes, args.w5 + (size_t)s * kSlabBytes, kSlabBytes, full + s);
    }
  uint32_t cat[16][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    cat[0][r] = m1[0][r];
    cat[1][r] = m1[1][r];
    cat[2][r] = m2[0][r];
    cat[3][r] = m2[1][r];
#pragma unroll
    for (int c = 0; c < 4; ++c) cat[4 + c][r] = m3[c][r];
  }
#pragma unroll
  for (int c = 0; c < kM4Chunks; ++c) {
    const uint4 m = m4s[c * kThreads + tid];
    cat[8 + c][0] = m.x;
    cat[8 + c][1] = m.y;
    cat[8 + c][2] = m.z;
    cat[8 + c][3] = m.w;
  }
  const float* swb5 = args.swb[3];
  bf16* out = args.out + (size_t)cloud * n_pts * emb;
  const int row_top = q0 + row, row_bot = row_top + 8;
  for (int s = 0; s < nslabs; ++s) {
    const int st = s % kStages;
    sm90::bar_wait(full + st, (s / kStages) & 1);
    int acc[16];
    sm90::wgmma_fence();
    const uint64_t d_w5 = desc_sw128(wts + st * kSlabBytes, 16);
#pragma unroll
    for (int c = 0; c < 16; ++c) sm90::mma_s8_rs_n32(acc, cat[c], d_w5 + (c >> 2) * (4096 >> 4) + 2 * (c & 3), c > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();  // every warp is done reading stage st
    if (tid == 0 && s + kStages < nslabs) {
      sm90::bar_expect_tx(full + st, kSlabBytes);
      sm90::bulk_load(wts + st * kSlabBytes, args.w5 + (size_t)(s + kStages) * kSlabBytes, kSlabBytes, full + st);
    }
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      const int c = s * kSlabCols + 8 * jb + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(swb5 + c));
      const float2 bc = __ldg(reinterpret_cast<const float2*>(swb5 + emb + c));
      auto value = [&](int e) {
        return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * jb + e]), (e & 1) ? sc.y : sc.x),
                               (e & 1) ? bc.y : bc.x), 0.f);
      };
      if (row_top < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_top * emb + c) = sm90::pack_bf16(value(0), value(1));
      if (row_bot < n_pts)
        *reinterpret_cast<uint32_t*>(out + (size_t)row_bot * emb + c) = sm90::pack_bf16(value(2), value(3));
    }
  }
}

// The wrapper's quantization of xw1 (the plain version's `_xw1_int8` after
// its product) in two passes instead of torch's chain of launches: |xw1|'s max
// (an atomic max of the bits, which order as the non-negative floats), then
// s = max(amax, 1e-6) / 127 and q = round(xw1 / s) clamped to 127, each a
// true division and round half to even, as torch computes them.
__global__ void __launch_bounds__(256) xw1_amax_kernel(const float4* __restrict__ v, size_t n4,
                                                       u32* __restrict__ amax) {
  u32 m = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4; i += (size_t)gridDim.x * blockDim.x) {
    const float4 f = v[i];
    m = max(m, max(max(__float_as_uint(fabsf(f.x)), __float_as_uint(fabsf(f.y))),
                   max(__float_as_uint(fabsf(f.z)), __float_as_uint(fabsf(f.w)))));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) atomicMax(amax, m);
}

__global__ void __launch_bounds__(256) xw1_quant_kernel(const float4* __restrict__ v, size_t n4,
                                                        const u32* __restrict__ amax, char4* __restrict__ q,
                                                        float* __restrict__ scale) {
  const float s = __fdiv_rn(fmaxf(__uint_as_float(*amax), 1e-6f), 127.f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  auto one = [&](float x) { return static_cast<signed char>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f)); };
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4; i += (size_t)gridDim.x * blockDim.x) {
    const float4 f = v[i];
    q[i] = make_char4(one(f.x), one(f.y), one(f.z), one(f.w));
  }
}

}  // namespace

// C entry: xw1 (n floats, n % 4 == 0) f32 -> q (n) int8 and scale (a f32
// device scalar); amax is a device scratch of one u32. Three launches (a
// memset, the max, the quantization). Returns the CUDA error code.
extern "C" int dgcnn_quant_xw1(const float* xw1, void* q, float* scale, void* amax, long long n, void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, 4, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n4 = (size_t)n / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  xw1_amax_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(xw1), n4, static_cast<u32*>(amax));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xw1_quant_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(xw1), n4, static_cast<const u32*>(amax),
                                          static_cast<char4*>(q), scale);
  return (int)cudaGetLastError();
}

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; xw1q (B, N, 64) int8; s_xw1 a f32 device scalar;
// wc1 (3, 64) f32; b1 (64,) f32; w23, w4, w5 the packed images of
// DGCNNInt8Weights (16384, 32768 and 512 emb bytes); swb2..swb5 (2, out)
// f32; inv1..inv4 the reciprocals of the stage scales; out (B, N, emb)
// bf16; knn_scale null (exact kNN) or the scales of dgcnn_knn_scale at
// tile_n (approximate); idx a scratch of B * N * k int32 for the neighbors.
// Needs 1 <= k <= 32, k <= N <= 4096 and emb % 64 == 0. Two launches, the
// selection and the chain. Returns the CUDA error code (0 on success).
extern "C" int dgcnn_encode_int8(const float* x, const void* xw1q, const float* s_xw1, const float* wc1,
                                 const float* b1, const void* w23, const void* w4, const void* w5, const float* swb2,
                                 const float* swb3, const float* swb4, const float* swb5, float inv1, float inv2,
                                 float inv3, float inv4, void* out, const float* knn_scale, void* idx, int batch,
                                 int n_pts, int k, int emb, int tile_n, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxN || emb <= 0 || emb % 64 != 0 || tile_n <= 0)
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit (the largest k's), once a device
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(dgcnn_encode_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               1024 + smem_bytes(kMaxK));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_pts + kRows - 1) / kRows, batch);
  err = static_cast<cudaError_t>(dgcnn_select(x, knn_scale, static_cast<int*>(idx), batch, n_pts, k, tile_n, stream));
  if (err != cudaSuccess) return (int)err;
  Args args{x,
            static_cast<const int8_t*>(xw1q),
            s_xw1,
            wc1,
            b1,
            static_cast<const uint8_t*>(w23),
            static_cast<const uint8_t*>(w4),
            static_cast<const uint8_t*>(w5),
            {swb2, swb3, swb4, swb5},
            {inv1, inv2, inv3, inv4},
            static_cast<bf16*>(out),
            static_cast<const int*>(idx),
            n_pts,
            k,
            emb};
  dgcnn_encode_int8_kernel<<<grid, kThreads, 1024 + smem_bytes(k), s>>>(args);
  return (int)cudaGetLastError();
}
