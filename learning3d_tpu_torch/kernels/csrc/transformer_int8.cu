// Fused int8 pre-norm transformer layers for Hopper (sm_90a), K11a and K11b:
// the int8 DCP pointer's encoder layer (LN1 -> int8 self-attention ->
// residual -> LN2 -> int8 feed-forward -> residual) and decoder layer (the
// same with an int8 cross-attention block on the memory after LN2, and LN3
// before the feed-forward). x (B, N, d) bf16 or f32 in, the same out.
//
// Replaces the TPU kernels learning3d_tpu/kernels/transformer_int8.py::
// encoder_layer_int8 (body `_enc_kernel`) and ::decoder_layer_int8 (body
// `_dec_kernel`, attention `_attend`). Same math as the port's plain
// versions `encoder_layer_int8_reference` / `decoder_layer_int8_reference`.
//
// The split. The TPU kernel runs one whole layer per batch item inside its
// VMEM (~12 MB at the DCP shape). An SM has 227 KB of shared memory and one
// (1024, 512) f32 activation is 2 MB, so here a layer is a short chain of
// launches whose int8 and f32 intermediates go through device memory (L2
// mostly): encoder 7 (S1, S2 Q|K|V, S3, S2 Wo, S1, S2 FF1, S2 FF2), decoder
// 13 (S1, S2 QKV, S3, S2 Wo, S1, S1 memory, S2 Q, S2 KV, S3, S2 Wo, S1, S2
// FF1, S2 FF2); S3 with int8 P.V at d_k <= 256 is two (V^T, attention). The
// residual stream stays f32 between them and is written in x's dtype by the
// last GEMM only.
//   S1 `ln_quant`       one warp a row: LayerNorm, then quant (or quant
//                       alone, for the decoder's memory).
//   S2 `gemm_s8`        int8 x int8 -> int32 on wgmma m64n128k32 s8.s8 fed by
//                       TMA: 128 x 128 output tiles, a producer warp keeping
//                       a 3-stage mbarrier ring of 128-byte k-steps of A (the
//                       activations, (rows, k)) and B (the weight packed as
//                       (out, in)) in flight, two consumer warpgroups of 64
//                       rows, two blocks an SM so that one block's epilogue
//                       runs under the other's products. The epilogues (one
//                       template instance each, straight-line code): requant
//                       at a per-column output scale (Q|K|V in one GEMM, K|V
//                       for cross, Q alone for cross) or ReLU + requant
//                       (FF1), staged as an int8 tile in the freed stages and
//                       stored in whole rows; dequant + bias + f32 residual
//                       (Wo, FF2), staged as an f32 tile and summed with the
//                       residual row by row, every global access coalesced.
//                       The tile's columns of the per-column vectors are
//                       staged by the producer warp's other lanes. The
//                       epilogue, not the products, bounds S2.
//   S3 `attention`      int8 two-pass attention over Q, K and V read in place
//                       from the projection buffers by head maps (4-D TMA
//                       maps (columns, head, rows, batch): row stride 3d, or
//                       d and 2d for cross; csrc/attention_sm90.cuh), the
//                       epilogue rounding O / l to bf16 and quantizing it at
//                       s_att into Wo's input. Three instances, by d_k and
//                       mode (`layer_attention_instance` names the one that
//                       runs):
//     d_k <= 256, int8 P.V: K10's wgmma design (csrc/attention_int8.cu,
//                       sm90::s8_two_pass_consumers) with l in f64, after
//                       `values_t_kernel` writes V^T in key_order (a V^T
//                       scratch). Bound by the softmax on the CUDA cores, as
//                       K10, and the f64 l's conversions.
//     d_k <= 256, hybrid: Q K^T for both passes on int8 wgmma (64-key tiles,
//                       a K ring as deep as fits: pass 1 is bound by its
//                       loads' latency), then bf16(p) handed through shared
//                       memory to a chain on the CUDA cores: each thread owns
//                       4 rows x 16 columns of O and walks the keys in order,
//                       one FMA a key an output (exact product, one
//                       rounding), 64 FMAs to 5 16-byte shared loads (1 of P,
//                       4 of V in f32), no barrier inside the chain (a warp
//                       reads back only its own P rows: __syncwarp around
//                       the handover). The producer warpgroup's other three
//                       warps widen each TMA'd int8 V tile to f32 once, into
//                       a 2-stage ring. Bound by the chain's FMAs (2 B N M
//                       d_k at 128 a clock an SM, ~0.51 ms at the DCP shape),
//                       which issue at ~56% of that rate (PERF.md).
//     d_k > 256 (both): the mma.sync instance (a 128-row Q tile and two K
//                       stages do not fit 227 KB past d_k = 256): 64-key
//                       tiles through shared memory, mma.sync m16n8k32, the
//                       hybrid chain 64 FMAs to 8 shared loads between
//                       block-wide barriers.
//
// Numeric traps, each kept as the plain version (and the TPU kernel) has it.
// Only the int32 products may run in any order; every other operation is the
// plain version's, bit for bit:
// * The oracle is the *_reference functions, not the module path: for a
//   bf16 model the module path rounds each block's output to bf16 and adds
//   the residual in bf16, while the layer keeps f32 throughout.
// * quant is round(x / s) of the IEEE quotient, half to even, clamped to
//   +-127. Built without --use_fast_math, and every epilogue is written
//   with __fmul_rn/__fadd_rn so that nvcc does not contract it into FMAs: a
//   one-ulp difference flips a .5 tie. S2's requant epilogues take x s_r
//   (s_r = 1 / s rounded to f32) where that cannot change the rounded value
//   and the IEEE quotient where it can (requant_epilogue).
// * Association: projections acc * (f32(s_x) * s_w[c]) + b[c]; residual
//   blocks (x32 + acc * (f32(s_att) * s_wo[c])) + b_o[c]. The products of
//   scales are formed once, when the layer's weights are packed.
// * The attention output passes through bf16 before its s_att quant. P is
//   round(127 p) (int8 P.V) or bf16(p) (hybrid) against the exact row max,
//   the same expf; l sums the unrounded f32 p.
// * sscale = s_q s_k / sqrt(d_k) is taken in double by the caller and
//   rounded to f32 once; K and V keep separate requant scales, per column.
// * One flipped int8 value moves a whole row of the next GEMM, and through
//   K and V every row of its batch item: at the DCP shape a handful of
//   flips a layer moved 5-7% of the outputs past the tie-flip profile on
//   the H100. So every sum whose order the two versions could not share is
//   made order-free: the LayerNorm statistics and the softmax's l are
//   summed in f64 and rounded to f32 once, and the hybrid P.V (exact f32
//   products bf16(p) v) is summed in key order on the CUDA cores, as the
//   plain version sums it (a bf16 tensor-core P.V rounds otherwise). The
//   JAX package sums these in f32 in XLA's order; the CPU tests hold the
//   port's plain version to it.
//
// Bound. At the DCP shape (B=32, N=1024, d=512, 4 heads, ff 1024) an encoder
// layer is 2 * 32,768 * 512 * (3 * 512 + 512 + 2 * 1024) = 137 G int8
// operations in its GEMMs and 4 * 32 * 4 * 1024 * 1024 * 128 = 69 G in its
// attention (with the hybrid P.V half of those at the bf16 rate): about 0.10
// ms at the dense int8 peak (1,979 TOP/s); the decoder about 0.17 ms. Its
// bytes are a few tens of MB (0.01-0.03 ms at 3.35 TB/s). The hybrid's P.V
// has no tensor-core form that rounds as the plain version does, so its
// floor is the chain's 17.2 G FMAs a launch on the CUDA cores (~0.51 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "attention_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using sm90::pack_bf16;

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (static_cast<uint32_t>(b0) & 0xffu) | ((static_cast<uint32_t>(b1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(b2) & 0xffu) << 16) | (static_cast<uint32_t>(b3) << 24);
}

// round(y / s), half to even, clamped to +-127: the IEEE quotient, clamped,
// then rounded on the FP32 pipe by adding 1.5 * 2^23 (the ulp there is 1, so
// the add rounds to the nearest integer, ties to even, and the sum's bits
// hold it), where rintf and the conversion to int each take the quarter-rate
// conversion unit. y = 0 gives 0 without the division, whose check sends a
// zero dividend to its slow path.
__device__ __forceinline__ int quant(float y, float s) {
  const bool zero = y == 0.f;
  const float x = fminf(fmaxf(__fdiv_rn(zero ? s : y, s), -127.f), 127.f);
  const int q = __float_as_int(__fadd_rn(x, 12582912.f)) - 0x4B400000;
  return zero ? 0 : q;
}

// The attention epilogue's value: quant(bf16(x), s_att).
__device__ __forceinline__ int quant_bf16(float x, float s_att) {
  return quant(__bfloat162float(__float2bfloat16_rn(x)), s_att);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- S1 ----

constexpr int kLnRows = kThreads / 32;  // rows a block, one a warp
constexpr int kLnMaxD = 1024;

struct LnArgs {
  const void* x;  // (rows, d) f32 or bf16
  const float* a;
  const float* b;
  int8_t* out;    // (rows, d)
  int rows, d, x_bf16, do_ln;
  float ratio, eps, s;  // ratio = f32(d / (d - 1))
};

// Lane l holds columns 128 i + 4 l .. + 3 for i < d / 128.
__global__ void __launch_bounds__(kThreads) ln_quant_kernel(LnArgs args) {
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= args.rows) return;
  const int d = args.d, groups = d / 128;
  float v[kLnMaxD / 32];
#pragma unroll
  for (int i = 0; i < kLnMaxD / 128; ++i) {
    if (i >= groups) break;
    const int c = 128 * i + 4 * lane;
    if (args.x_bf16) {
      const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(args.x) + (size_t)row * d + c);
      v[4 * i] = __uint_as_float(w.x << 16);
      v[4 * i + 1] = __uint_as_float(w.x & 0xffff0000u);
      v[4 * i + 2] = __uint_as_float(w.y << 16);
      v[4 * i + 3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      const float4 w = *reinterpret_cast<const float4*>(static_cast<const float*>(args.x) + (size_t)row * d + c);
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  }
  float mean = 0.f, den = 1.f;
  if (args.do_ln) {
    // the statistics are summed in f64 and rounded to f32 once, as the
    // plain version sums them, so that both round alike whatever the order
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < kLnMaxD / 32; ++i)
      if (i < 4 * groups) sum += static_cast<double>(v[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    mean = __double2float_rn(sum / d);
    double sq = 0.0;
#pragma unroll
    for (int i = 0; i < kLnMaxD / 32; ++i) {
      if (i >= 4 * groups) break;
      const double c = __fsub_rn(v[i], mean);
      sq += c * c;  // exact: a product of two f32 values
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float var = __fmul_rn(__double2float_rn(sq / d), args.ratio);
    den = __fadd_rn(__fsqrt_rn(var), args.eps);
  }
#pragma unroll
  for (int i = 0; i < kLnMaxD / 128; ++i) {
    if (i >= groups) break;
    const int c = 128 * i + 4 * lane;
    int q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = v[4 * i + e];
      if (args.do_ln)
        y = __fadd_rn(__fdiv_rn(__fmul_rn(args.a[c + e], __fsub_rn(y, mean)), den), args.b[c + e]);
      q[e] = quant(y, args.s);
    }
    *reinterpret_cast<uint32_t*>(args.out + (size_t)row * d + c) = pack4(q[0], q[1], q[2], q[3]);
  }
}

// ---------------------------------------------------------------- S2 ----

namespace gemm {

constexpr int kBM = 128, kBN = 128;  // an output tile: two consumer warpgroups of 64 rows
constexpr int kBK = 128;             // k-step: one 128-byte swizzle row of A and of B
constexpr int kStages = 3;           // 96 KB a block: two blocks an SM
constexpr int kThreads = 288;        // two consumer warpgroups and the producer warp
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kBarBytes = 8 * (2 * kStages + 2);  // full[3], empty[3], vec_full, padding
constexpr int kVecFloats = 4 * kBN;               // the tile's columns of cs, bias, so, sr
constexpr int kSmem = kStages * kStageBytes + kBarBytes + 4 * kVecFloats + 1024;

enum Mode { kRequant = 0, kReluRequant = 1, kResidual = 2 };

struct Args {
  const float* cs;    // (n,) f32(s_x) * s_w
  const float* bias;  // (n,)
  const float* so;    // (n,) output scales (requant modes)
  const float* sr;    // (n,) 1 / so rounded to f32 (requant modes)
  const void* res;    // (m, n) residual, f32 or bf16 (residual mode)
  void* out;          // (m, n): int8 (requant modes), f32 or bf16 (residual mode)
  int m, n, k;
};

// The epilogues work in the accumulator layout: acc[4 j + 2 h + e] is row
// g + 8 h of the warp's 16, column 8 j + 2 t + e of the tile.

// (x32 + acc cs) + bias, in two steps: acc cs into the warpgroup's f32 tile
// in shared memory (64 rows of 512 bytes, 16-byte chunk q of row r at q ^
// (2 (r % 8)): conflict-free both ways), then row by row, four columns a
// thread and whole rows a warp, the residual read, the sums and the output
// written, all coalesced. `tile` may be written once both warpgroups are past
// their products; rows r0 + 8 h (h < 2) of the tile, columns n0 + 8 j + 2 t
// (+1).
template <bool RES_BF16, bool OUT_BF16>
__device__ __forceinline__ void residual_epilogue(const int (&acc)[64], const Args& args, const float* vec,
                                                  float* tile, int r0, int m0, int n0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 cs = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, q = 2 * j + (t >> 1);
      *reinterpret_cast<float2*>(tile + r * kBN + ((q ^ ((r & 7) << 1)) << 2) + 2 * (t & 1)) =
          make_float2(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), cs.x),
                      __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), cs.y));
    }
  }
  const int wg = threadIdx.x >> 7;
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int c = (threadIdx.x & 127) + 128 * it, r = c >> 5, q = c & 31;
    const int row = m0 + wg * 64 + r;
    if (row >= args.m) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * kBN + ((q ^ ((r & 7) << 1)) << 2));
    const float4 b = *reinterpret_cast<const float4*>(vec + kBN + 4 * q);
    const size_t at = (size_t)row * args.n + n0 + 4 * q;
    float x[4];
    if constexpr (RES_BF16) {
      const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(args.res) + at);
      x[0] = __uint_as_float(w.x << 16);
      x[1] = __uint_as_float(w.x & 0xffff0000u);
      x[2] = __uint_as_float(w.y << 16);
      x[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      const float4 w = *reinterpret_cast<const float4*>(static_cast<const float*>(args.res) + at);
      x[0] = w.x;
      x[1] = w.y;
      x[2] = w.z;
      x[3] = w.w;
    }
    const float y0 = __fadd_rn(__fadd_rn(x[0], v.x), b.x), y1 = __fadd_rn(__fadd_rn(x[1], v.y), b.y);
    const float y2 = __fadd_rn(__fadd_rn(x[2], v.z), b.z), y3 = __fadd_rn(__fadd_rn(x[3], v.w), b.w);
    if constexpr (OUT_BF16)
      *reinterpret_cast<uint2*>(static_cast<bf16*>(args.out) + at) = make_uint2(pack_bf16(y0, y1), pack_bf16(y2, y3));
    else
      *reinterpret_cast<float4*>(static_cast<float*>(args.out) + at) = make_float4(y0, y1, y2, y3);
  }
}

// quant(acc cs + bias (ReLU'd), so) into the warpgroup's staged int8 tile
// (64 rows of 128 bytes, 16-byte chunk c of row r at c ^ (r % 8)): rows r0
// and r0 + 8, columns 8 j + 2 t (+1) of the tile; vec holds the tile's
// columns of cs, bias, so and sr = 1 / so (f32). Without the division: x =
// y sr lies within 3 2^-24 |y / so| (< 2.3e-5 below the clamp) of the IEEE
// quotient, so rint(x) is rint(y / so) unless x lies within 2^-15 of a
// half-integer (a few elements in 10^5); past +-127 both clamp to +-127.
// Such an element is flagged in `near` and its y kept in ybuf (64 x 128
// f32), and the warps that have one redo those by the division afterwards,
// so that the loop stays branch-free (tests/test_torch_k11_layout.py pins
// the rule in numpy).
template <bool RELU>
__device__ __forceinline__ void requant_epilogue(const int (&acc)[64], const float* vec, uint8_t* tile, float* ybuf,
                                                 int r0, int t) {
  auto at = [&](int j, int h) {
    const int r = r0 + 8 * h;
    return tile + r * kBK + (((j >> 1) ^ (r & 7)) << 4) + 8 * (j & 1) + 2 * t;
  };
  uint64_t near = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 cs = *reinterpret_cast<const float2*>(vec + c);
    const float2 bias = *reinterpret_cast<const float2*>(vec + kBN + c);
    const float2 sr = *reinterpret_cast<const float2*>(vec + 3 * kBN + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), e ? cs.y : cs.x), e ? bias.y : bias.x);
        if (RELU) y = fmaxf(y, 0.f);
        const float x = fminf(fmaxf(__fmul_rn(y, e ? sr.y : sr.x), -127.f), 127.f);
        const float u = __fadd_rn(x, 12582912.f);  // rint(x) + 1.5 * 2^23
        const bool flag = fabsf(__fsub_rn(x, __fsub_rn(u, 12582912.f))) > 0.5f - 0x1p-15f;
        if (flag) ybuf[(r0 + 8 * h) * kBN + c + e] = y;
        near |= static_cast<uint64_t>(flag) << i;
        q[e] = __float_as_uint(u) & 0xffu;
      }
      *reinterpret_cast<uint16_t*>(at(j, h)) = static_cast<uint16_t>(q[0] | (q[1] << 8));
    }
  }
  if (__any_sync(0xffffffffu, near != 0)) {
    while (near != 0) {
      const int i = __ffsll(static_cast<long long>(near)) - 1;
      near &= near - 1;
      const int j = i >> 2, h = (i >> 1) & 1, e = i & 1, c = 8 * j + 2 * t + e;
      at(j, h)[e] = static_cast<uint8_t>(quant(ybuf[(r0 + 8 * h) * kBN + c], vec[2 * kBN + c]));
    }
  }
}

// Grid (n / 128, ceil(m / 128)). Stage s holds A's 128 rows then B's 128
// rows of one k-step, each a TMA box of 128-byte swizzled rows; full[s]
// takes the producer's arrival and the bytes, empty[s] one arrival from each
// consumer warp. A consumer warpgroup issues a k-step's four wgmma and
// retires the previous group (wait 1) before it frees that stage, so the
// tensor cores always hold one k-step of each warpgroup. One instance for
// each epilogue (MODE) and residual and output type, so that the epilogue is
// straight-line code.
template <int MODE, bool RES_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                   const Args args) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* vec_full = empty + kStages;
  float* vec = reinterpret_cast<float*>(smem + kStages * kStageBytes + kBarBytes);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (args.k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, 8);
    }
    sm90::bar_init(vec_full, 1);
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x > 256) {  // lanes 1-31: the tile's columns of cs, bias, so and sr into shared memory
      const float* src[4] = {args.cs, args.bias, args.so, args.sr};
      for (int i = threadIdx.x - 257; i < kVecFloats / 4; i += 31) {
        const int v = i / (kBN / 4), c = 4 * (i - v * (kBN / 4));
        if (src[v] != nullptr)
          *reinterpret_cast<float4*>(vec + v * kBN + c) = *reinterpret_cast<const float4*>(src[v] + n0 + c);
      }
      __syncwarp(0xfffffffeu);
      if (threadIdx.x == 257) sm90::bar_arrive(vec_full);
    } else {
      sm90::Ring r(kStages);
      for (int kt = 0; kt < nk; ++kt) {
        sm90::bar_wait(empty + r.stage, r.phase ^ 1u);
        sm90::bar_expect_tx(full + r.stage, kStageBytes);
        uint8_t* st = smem + r.stage * kStageBytes;
        sm90::tma_load_3d(st, &map_a, full + r.stage, kt * kBK, m0, 0);
        sm90::tma_load_3d(st + kBM * kBK, &map_b, full + r.stage, kt * kBK, n0, 0);
        r.next();
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  sm90::Ring r(kStages);
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    sm90::bar_wait(full + r.stage, r.phase);
    const uint8_t* st = smem + r.stage * kStageBytes;
    const uint64_t da = sm90::desc_sw128(st + wg * 64 * kBK, 16);
    const uint64_t db = sm90::desc_sw128(st + kBM * kBK, 16);
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::mma_s8_ss_n128(acc, da + 2 * kk, db + 2 * kk, 1);
    sm90::wgmma_commit();
    if (prev >= 0) {
      sm90::wgmma_wait<1>();
      sm90::fence_operands(acc);
      sm90::release(empty + prev, lane);
    }
    prev = r.stage;
    r.next();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);

  // Both warpgroups past their products: the stages are free. The residual
  // modes take 32 KB of them a warpgroup; the requant modes 8 KB for the
  // int8 tile and 32 KB for ybuf.
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  sm90::bar_wait(vec_full, 0);
  if constexpr (MODE == kResidual) {
    residual_epilogue<RES_BF16, OUT_BF16>(acc, args, vec, reinterpret_cast<float*>(smem + wg * kBM * kBN * 2),
                                          warp * 16 + g, m0, n0, t);
  } else {
    requant_epilogue<MODE == kReluRequant>(acc, vec, smem + wg * 64 * kBK,
                                           reinterpret_cast<float*>(smem + 2 * 64 * kBK + wg * 64 * kBN * 4),
                                           warp * 16 + g, t);
    // the warpgroup's 64 x 128 int8 tile out of shared memory, 16 bytes a
    // thread, each warp four whole 128-byte rows at a time
    if (wg == 0)  // named barriers 1 and 2, constant ids (a register id reserves all 16)
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
    const uint8_t* tile = smem + wg * 64 * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (threadIdx.x & 127) + 128 * i, r = c >> 3, ch = c & 7;
      const int row = m0 + wg * 64 + r;
      if (row < args.m)
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(args.out) + (size_t)row * args.n + n0 + 16 * ch) =
            *reinterpret_cast<const uint4*>(tile + r * kBK + ((ch ^ (r & 7)) << 4));
    }
  }
}

// The instance for (mode, res_bf16, out_bf16).
template <int MODE, bool RES_BF16, bool OUT_BF16>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Args& args, cudaStream_t stream) {
  auto kernel = gemm_s8_kernel<MODE, RES_BF16, OUT_BF16>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(args.n / kBN, (args.m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(ma, mb, args);
  return (int)cudaGetLastError();
}

}  // namespace gemm

// ---------------------------------------------------------------- S3 ----

struct AttArgs {
  const int8_t* q;  // head 0's first column of Q, rows of stride ldq
  const int8_t* k;  // head 0's first column of K, rows of stride ldkv
  const int8_t* v;  // head 0's first column of V, rows of stride ldkv
  int8_t* out;      // (batch * n, ldo), head h at columns h dk
  int n, m, dk, heads, ldq, ldkv, ldo;
  float sscale, oscale, s_att;
};

constexpr int kSm90MaxDk = 256;  // the wgmma instances: a 128-row Q tile and the rings fit 227 KB

// ---- d_k <= 256, int8 P.V: K10's design on head maps --------------------

// V^T (batch * heads, dk, Mp) in key_order from V read in place.
__global__ void __launch_bounds__(256) values_t_kernel(const int8_t* v, int8_t* vt, int m, int mp, int dk, int ldv,
                                                       int heads) {
  sm90::values_t_block(v, vt, m, mp, dk, ldv, heads);
}

// Grid (ceil(n / 128), batch * heads), 384 threads: Q and K through head
// maps, V^T (values_t_kernel's) through a 3-D map; the consumers are K10's
// (sm90::s8_two_pass_consumers) with l summed in f64, and the epilogue
// writes quant(bf16(O / l), s_att) into Wo's input.
__global__ void __launch_bounds__(sm90::kThreads, 1)
    attention_s8_pv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_vt, const AttArgs a, const sm90::Layout lay) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const sm90::Bars bars(smem, lay);
  const int bh = blockIdx.y, q0 = blockIdx.x * sm90::kRowsQ;
  if (threadIdx.x == 0) bars.init(lay);
  __syncthreads();

  if (threadIdx.x / 128 == 2) {  // the producer
    sm90::setmaxnreg_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      const int tile = sm90::kS8TileK;
      const sm90::Loads ld{&map_q,    &map_k, &map_vt, a.dk / 128, 128, tile, (a.m + tile - 1) / tile,
                           a.dk / sm90::kSlab, 1, 1, a.heads};
      sm90::produce(ld, lay, smem, bars, q0, bh);
    }
  } else {
    sm90::setmaxnreg_inc<sm90::kConsumerRegs>();
    const int item = bh / a.heads, head = bh - item * a.heads;
    int8_t* out = a.out + (size_t)item * a.n * a.ldo + head * a.dk;
    const float s_att = a.s_att;
    sm90::s8_two_pass_consumers<true, double>(
        lay, smem, bars, q0, a.n, a.m, a.dk, a.sscale, a.oscale, [&](int row, int col, float x0, float x1) {
          const int q0v = quant_bf16(x0, s_att), q1v = quant_bf16(x1, s_att);
          *reinterpret_cast<uint16_t*>(out + (size_t)row * a.ldo + col) =
              static_cast<uint16_t>((q0v & 0xff) | ((q1v & 0xff) << 8));
        });
  }
}

// ---- d_k <= 256, hybrid: int8 wgmma scores, the P.V chain on the CUDA cores

namespace hybrid {

constexpr int kTileK = 64;                      // keys a tile
constexpr int kSlab = 128;                      // output columns a slab
constexpr int kNv = 2;                          // int8 V stages and f32 V stages
constexpr int kLdP = 20;                        // a key's row of a warp's P: 16 rows, padded (conflict-free)
constexpr int kV8Bytes = kTileK * kSlab;        // an int8 V tile: 64 keys x 128 columns
constexpr int kVfBytes = kTileK * kSlab * 4;    // the same in f32
constexpr int kPBytes = kTileK * kLdP * 4;      // a warp's P tile
constexpr int kConverters = 96;                 // the producer warpgroup's warps 1-3

// Shared memory: the Q tile, the K ring, the int8 V ring, the f32 V ring,
// the eight consumer warps' P tiles, then the barriers: q_full, k_full[nk],
// k_empty[nk], v8_full[2], v8_empty[2], vf_full[2], vf_empty[2]. The K ring
// is as deep as fits (pass 1 is latency-bound on its loads): 6 stages at d_k
// = 128, 4 at 256.
struct Layout {
  int boxes, nk;
  __host__ __device__ explicit Layout(int dk) : boxes(dk / 128), nk(6) {
    while (total() > sm90::kMaxSmem) --nk;
  }
  __host__ __device__ int q_bytes() const { return boxes * sm90::kRowsQ * sm90::kRowBytes; }
  __host__ __device__ int k_bytes() const { return boxes * kTileK * sm90::kRowBytes; }
  __host__ __device__ int k_off(int s) const { return q_bytes() + s * k_bytes(); }
  __host__ __device__ int v8_off(int s) const { return k_off(nk) + s * kV8Bytes; }
  __host__ __device__ int vf_off(int s) const { return v8_off(kNv) + s * kVfBytes; }
  __host__ __device__ int p_off(int w) const { return vf_off(kNv) + w * kPBytes; }
  __host__ __device__ int bar_off() const { return p_off(8); }
  __host__ __device__ int total() const { return bar_off() + 8 * (1 + 2 * nk + 4 * kNv) + 1024; }
};

struct Bars {
  uint64_t *q_full, *k_full, *k_empty, *v8_full, *v8_empty, *vf_full, *vf_empty;
  __device__ Bars(uint8_t* smem, const Layout& l)
      : q_full(reinterpret_cast<uint64_t*>(smem + l.bar_off())),
        k_full(q_full + 1),
        k_empty(k_full + l.nk),
        v8_full(k_empty + l.nk),
        v8_empty(v8_full + kNv),
        vf_full(v8_empty + kNv),
        vf_empty(vf_full + kNv) {}
  __device__ void init(const Layout& l) const {
    sm90::bar_init(q_full, 1);
    for (int s = 0; s < l.nk; ++s) {
      sm90::bar_init(k_full + s, 1);
      sm90::bar_init(k_empty + s, 8);  // the consumer warps
    }
    for (int s = 0; s < kNv; ++s) {
      sm90::bar_init(v8_full + s, 1);
      sm90::bar_init(v8_empty + s, 3);  // the converter warps
      sm90::bar_init(vf_full + s, 3);
      sm90::bar_init(vf_empty + s, 8);
    }
    sm90::bar_fence_init();
  }
};

// The warpgroup's 64 x 64 int32 scores of one K tile (boxes 128-wide column
// boxes of Q's 64 rows and of the tile). The caller commits and waits.
__device__ __forceinline__ void issue_scores(int (&s)[32], const uint8_t* sq, const uint8_t* sk, int boxes) {
  sm90::fence_operands(s);
  sm90::wgmma_fence();
  for (int b = 0; b < boxes; ++b) {
    const uint64_t da = sm90::desc_sw128(sq + b * sm90::kRowsQ * sm90::kRowBytes, 16);
    const uint64_t db = sm90::desc_sw128(sk + b * kTileK * sm90::kRowBytes, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::mma_s8_ss_n64(s, da + 2 * kk, db + 2 * kk, b > 0 || kk > 0);
  }
}

// Grid (ceil(n / 128), batch * heads), 384 threads. Warpgroups 0 and 1:
// rows q0 + 64 wg + [0, 64); warp 8: the TMA producer; warps 9-11: widen
// each int8 V tile to f32. Pass 1 takes the exact row max (an integer max);
// pass 2, for every slab of 128 output columns and every 64-key tile: S =
// Q K^T, p = expf(s - m), l += p in f64, bf16(p) into the warp's P tile,
// then the chain O[r][c] = fma(P[r][k], V[k][c], O[r][c]) over the tile's
// keys in order.
__global__ void __launch_bounds__(sm90::kThreads, 1)
    attention_hybrid_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const AttArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const Layout lay(a.dk);
  const Bars bars(smem, lay);
  const int bh = blockIdx.y, q0 = blockIdx.x * sm90::kRowsQ;
  const int item = bh / a.heads, head = bh - item * a.heads;
  const int ntiles = (a.m + kTileK - 1) / kTileK, nslabs = a.dk / kSlab, steps = ntiles * nslabs;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) bars.init(lay);
  __syncthreads();

  if (threadIdx.x == 256) {  // the producer: Q; pass 1's K tiles; then each (slab, tile)'s K and V
    sm90::bar_expect_tx(bars.q_full, lay.q_bytes());
    for (int b = 0; b < lay.boxes; ++b)
      sm90::tma_load_4d(smem + b * sm90::kRowsQ * sm90::kRowBytes, &map_q, bars.q_full, 128 * b, head, q0, item);
    sm90::Ring kr(lay.nk), vr(kNv);
    auto load_k = [&](int t) {
      sm90::bar_wait(bars.k_empty + kr.stage, kr.phase ^ 1u);
      sm90::bar_expect_tx(bars.k_full + kr.stage, lay.k_bytes());
      for (int b = 0; b < lay.boxes; ++b)
        sm90::tma_load_4d(smem + lay.k_off(kr.stage) + b * kTileK * sm90::kRowBytes, &map_k, bars.k_full + kr.stage,
                          128 * b, head, t * kTileK, item);
      kr.next();
    };
    for (int t = 0; t < ntiles; ++t) load_k(t);
    for (int i = 0; i < steps; ++i) {
      const int slab = i / ntiles, t = i - slab * ntiles;
      load_k(t);
      sm90::bar_wait(bars.v8_empty + vr.stage, vr.phase ^ 1u);
      sm90::bar_expect_tx(bars.v8_full + vr.stage, kV8Bytes);
      sm90::tma_load_4d(smem + lay.v8_off(vr.stage), &map_v, bars.v8_full + vr.stage, kSlab * slab, head,
                        t * kTileK, item);
      vr.next();
    }
    return;
  }
  if (threadIdx.x > 256) {  // the converters: int8 V tile -> f32, a key a row of 128 columns
    if (threadIdx.x < 256 + 32) return;  // the producer warp's other lanes
    const int c = threadIdx.x - 288;
    sm90::Ring r(kNv);
    for (int i = 0; i < steps; ++i) {
      sm90::bar_wait(bars.v8_full + r.stage, r.phase);
      sm90::bar_wait(bars.vf_empty + r.stage, r.phase ^ 1u);
      const uint8_t* src = smem + lay.v8_off(r.stage);
      float* dst = reinterpret_cast<float*>(smem + lay.vf_off(r.stage));
      for (int chunk = c; chunk < kV8Bytes / 16; chunk += kConverters) {
        const uint4 w = *reinterpret_cast<const uint4*>(src + 16 * chunk);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        float4* row = reinterpret_cast<float4*>(dst + 16 * chunk);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          row[e] = make_float4(static_cast<float>(static_cast<int8_t>(words[e] & 0xffu)),
                               static_cast<float>(static_cast<int8_t>((words[e] >> 8) & 0xffu)),
                               static_cast<float>(static_cast<int8_t>((words[e] >> 16) & 0xffu)),
                               static_cast<float>(static_cast<int8_t>(words[e] >> 24)));
      }
      sm90::release(bars.v8_empty + r.stage, lane);
      sm90::release(bars.vf_full + r.stage, lane);
      r.next();
    }
    return;
  }
  // The consumers. In the accumulator layout, lane (g, tq) of warp w holds
  // rows 16 w + g + 8 h (h < 2) of its warpgroup's 64 and key columns 8 j +
  // 2 tq + e of a tile. The warp's P tile holds bf16(p) of its 16 rows a key
  // a row, row 2 g + h for accumulator row g + 8 h. In the chain, lane (rg,
  // cg) = (lane / 8, lane % 8) owns P rows 4 rg .. 4 rg + 3 (accumulator
  // rows 2 rg + i / 2 + 8 (i % 2)) and slab columns 32 c + 4 cg .. + 3 (c <
  // 4), so a warp reads back only the P rows it wrote, and a key costs 5
  // 16-byte shared loads (1 of P, 4 of V) for 64 FMAs.
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3, rg = lane >> 3, cg = lane & 7;
  const uint8_t* sq = smem + wg * 64 * sm90::kRowBytes;
  float* pw = reinterpret_cast<float*>(smem + lay.p_off(4 * wg + warp));
  sm90::Ring kr(lay.nk), vr(kNv);
  int s[32];
  // waits for the next K tile and issues its scores into s
  auto issue = [&]() {
    sm90::bar_wait(bars.k_full + kr.stage, kr.phase);
    issue_scores(s, sq, smem + lay.k_off(kr.stage), lay.boxes);
    sm90::wgmma_commit();
  };
  // waits for them and frees the K tile
  auto retire = [&]() {
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
    sm90::release(bars.k_empty + kr.stage, lane);
    kr.next();
  };
  const int left0 = a.m - 2 * tq;  // tile t: left0 - t kTileK of this thread's first column on lie before M
  sm90::bar_wait(bars.q_full, 0);

  // pass 1: the exact row max, an integer max of the accumulators,
  // converted and scaled once (rounding by sscale >= 0 is monotone)
  int imx[2] = {INT_MIN, INT_MIN};
  for (int t = 0; t < ntiles; ++t) {
    issue();
    retire();
    const int left = left0 - t * kTileK;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      imx[(j >> 1) & 1] = max(imx[(j >> 1) & 1], 8 * (j >> 2) + (j & 1) < left ? s[j] : INT_MIN);
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 1));
    imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 2));
    mx[h] = __fmul_rn(__int2float_rn(imx[h]), a.sscale);
  }

  // pass 2
  const float sscale = a.sscale, oscale = a.oscale, s_att = a.s_att;
  float o[4][16];
  double l[2];
  for (int i = 0; i < steps; ++i) {
    const int slab = i / ntiles, t = i - slab * ntiles;
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) o[r][c] = 0.f;
      l[0] = l[1] = 0.0;
    }
    issue();
    retire();
    // p = expf(s - m) (a column past M gets -inf: p = 0), l += p in f64,
    // bf16(p) as f32 into the warp's P tile
    const int left = left0 - t * kTileK;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      const float x = __fsub_rn(__fmul_rn(__int2float_rn(s[j]), sscale), mx[h]);
      const float p = expf(8 * (j >> 2) + (j & 1) < left ? x : -INFINITY);
      l[h] += static_cast<double>(p);
      s[j] = __float_as_int(__bfloat162float(__float2bfloat16_rn(p)));
    }
    __syncwarp();  // the warp's chain has read the previous tile's P
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(pw + (8 * j + 2 * tq + e) * kLdP + 2 * g) =
            make_float2(__int_as_float(s[4 * j + e]), __int_as_float(s[4 * j + 2 + e]));
    __syncwarp();

    // the chain: O[r][c] += P[r][k] V[k][c] for the tile's keys in order,
    // one rounding a key (the product bf16 x int8 is exact in f32)
    sm90::bar_wait(bars.vf_full + vr.stage, vr.phase);
    const float* vk = reinterpret_cast<const float*>(smem + lay.vf_off(vr.stage)) + 4 * cg;
    const float* pk = pw + 4 * rg;
#pragma unroll 4
    for (int k = 0; k < kTileK; ++k) {
      const float4 p4 = *reinterpret_cast<const float4*>(pk + k * kLdP);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v4 = *reinterpret_cast<const float4*>(vk + k * kSlab + 32 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][4 * c] = __fmaf_rn(pr[r], v4.x, o[r][4 * c]);
          o[r][4 * c + 1] = __fmaf_rn(pr[r], v4.y, o[r][4 * c + 1]);
          o[r][4 * c + 2] = __fmaf_rn(pr[r], v4.z, o[r][4 * c + 2]);
          o[r][4 * c + 3] = __fmaf_rn(pr[r], v4.w, o[r][4 * c + 3]);
        }
      }
    }
    sm90::release(bars.vf_empty + vr.stage, lane);
    vr.next();

    if (t == ntiles - 1) {  // the slab's epilogue: quant(bf16((O s_v) / l), s_att)
      float lf[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        lf[h] = __double2float_rn(l[h]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ga = 2 * rg + (r >> 1);  // accumulator row ga + 8 (r & 1)
        const float lr = __shfl_sync(0xffffffffu, lf[r & 1], 4 * ga);
        const int row = q0 + wg * 64 + warp * 16 + ga + 8 * (r & 1);
        if (row >= a.n) continue;
        int8_t* out = a.out + ((size_t)item * a.n + row) * a.ldo + head * a.dk + kSlab * slab + 4 * cg;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int qv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) qv[e] = quant_bf16(__fdiv_rn(__fmul_rn(o[r][4 * c + e], oscale), lr), s_att);
          *reinterpret_cast<uint32_t*>(out + 32 * c) = pack4(qv[0], qv[1], qv[2], qv[3]);
        }
      }
    }
  }
}

}  // namespace hybrid

// ---- d_k > 256 (both modes): the mma.sync instance ----------------------

namespace mma_sync {

constexpr int kMaxDk = 1024;
constexpr int kAttWarps = 8;
constexpr int kRowsQ = 16 * kAttWarps;  // query rows a block
constexpr int kTileK = 64;              // keys a tile
constexpr int kSlabV = 128;             // output columns a pass-2 slab
constexpr int kLdV8 = kTileK + 16;      // int8 V tile row (bytes), one row a column
constexpr int kLdP = kTileK + 4;        // hybrid: a warp's P rows (f32)

// Shared memory: the Q tile, then the K tile (in hybrid mode also the
// warps' P rows, after the scores are taken), then the V tile: int8 with a
// column a row (int8 mode), f32 with a key a row (hybrid). At d_k = 1024 the
// hybrid layout takes exactly the 232,448 bytes a block may have.
__host__ __device__ constexpr int att_k_region(int dk, bool int8_pv) {
  return int8_pv || kTileK * (dk + 16) >= kAttWarps * 16 * kLdP * 4 ? kTileK * (dk + 16) : kAttWarps * 16 * kLdP * 4;
}
__host__ __device__ constexpr int att_smem_bytes(int dk, bool int8_pv) {
  return kRowsQ * (dk + 16) + att_k_region(dk, int8_pv) + (int8_pv ? kSlabV * kLdV8 : kTileK * kSlabV * 4);
}

// Rows [r0, r0 + rows) of `dk` bytes, at stride `ld` in device memory, into
// shared rows of dk + 16 bytes; rows past `total` are zero.
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, int ld, int r0, int rows, int total,
                                          int dk) {
  const int chunks = dk / 16, lds = dk + 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < total) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// int8 mode: the V tile for output columns [v0, v0 + 128) and keys [kt,
// kt + 64), from row-major V (a key a row), transposed to a column a shared
// row. A thread takes 8 columns of 4 keys (four 8-byte loads) and
// transposes them with __byte_perm, 4 x 4 bytes at a time; the 4 keys are
// 2t, 2t+1, 8+2t, 9+2t of a 16-key group, stored at bytes 4t..4t+3 (the
// order of P's A fragments, as K10's).
__device__ __forceinline__ void load_v_int8(int8_t* dst, const int8_t* vg, int ldkv, int v0, int kt, int m) {
  const int cg = threadIdx.x >> 4, kq = threadIdx.x & 15;  // 16 column groups x 16 key quads
  const int base = 16 * (kq >> 2) + 2 * (kq & 3);
  const int keys[4] = {base, base + 1, base + 8, base + 9};
  uint2 w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = kt + keys[e];
    w[e] = key < m ? *reinterpret_cast<const uint2*>(vg + (size_t)key * ldkv + v0 + 8 * cg) : make_uint2(0u, 0u);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint32_t a0 = hh ? w[0].y : w[0].x, a1 = hh ? w[1].y : w[1].x;
    const uint32_t a2 = hh ? w[2].y : w[2].x, a3 = hh ? w[3].y : w[3].x;
    const uint32_t lo01 = __byte_perm(a0, a1, 0x5140), hi01 = __byte_perm(a0, a1, 0x7362);
    const uint32_t lo23 = __byte_perm(a2, a3, 0x5140), hi23 = __byte_perm(a2, a3, 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) *reinterpret_cast<uint32_t*>(dst + (8 * cg + 4 * hh + c) * kLdV8 + 4 * kq) = col[c];
  }
}

// Hybrid mode: the same V tile as f32, a key a row (no transposition).
__device__ __forceinline__ void load_v_f32(float* dst, const int8_t* vg, int ldkv, int v0, int kt, int m) {
  for (int i = threadIdx.x; i < kTileK * (kSlabV / 16); i += kThreads) {
    const int key = i >> 3, c = (i & 7) * 16;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (kt + key < m) w = *reinterpret_cast<const uint4*>(vg + (size_t)(kt + key) * ldkv + v0 + c);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    float4* row = reinterpret_cast<float4*>(dst + key * kSlabV + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      row[e] = make_float4(static_cast<float>(static_cast<int8_t>(words[e] & 0xffu)),
                           static_cast<float>(static_cast<int8_t>((words[e] >> 8) & 0xffu)),
                           static_cast<float>(static_cast<int8_t>((words[e] >> 16) & 0xffu)),
                           static_cast<float>(static_cast<int8_t>(words[e] >> 24)));
  }
}

// The warp's 16 x 64 int32 score tile S = Q[m0:m0+16] K_tile^T.
__device__ __forceinline__ void scores(int (&s)[8][4], const int8_t* qs, const int8_t* ks, int dk, int m0,
                                       int lane) {
  const int ld = dk + 16, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
  const int8_t* pa = qs + (m0 + g) * ld + 4 * t;
  const int8_t* pb = ks + g * ld + 4 * t;
  for (int kk = 0; kk < dk; kk += 32) {
    const uint32_t a[4] = {ld32(pa + kk), ld32(pa + 8 * ld + kk), ld32(pa + kk + 16), ld32(pa + 8 * ld + kk + 16)};
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_s8(s[j], a, ld32(pb + 8 * j * ld + kk), ld32(pb + 8 * j * ld + kk + 16));
  }
}

// Quantize 16 consecutive outputs of one row at s_att and store them.
__device__ __forceinline__ void store_q16(int8_t* out, const int (&q)[16]) {
  uint4 w;
  w.x = pack4(q[0], q[1], q[2], q[3]);
  w.y = pack4(q[4], q[5], q[6], q[7]);
  w.z = pack4(q[8], q[9], q[10], q[11]);
  w.w = pack4(q[12], q[13], q[14], q[15]);
  *reinterpret_cast<uint4*>(out) = w;
}

// Grid (ceil(n / 128), batch * heads), 8 warps of 16 query rows. K10's old
// design: pass 1 takes the exact row max, pass 2 per 128-column slab p, l
// and O, every K and V tile through shared memory between block barriers.
// So that the kernel and its plain version round alike (one flip of an int8
// value moves a whole row of the next GEMM, and through K and V every row
// of the batch item), l is summed in f64 and rounded to f32 once, and the
// hybrid P.V (bf16(p) times int8 v, exact products) is summed on the CUDA
// cores in f32 in key order, one fused multiply-add a key, as the plain
// version sums it; the int8 P.V is exact on the tensor cores.
template <bool INT8_PV>
__global__ void __launch_bounds__(kThreads, 2) attention_s8_kernel(AttArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dk = args.dk, ld = dk + 16;
  int8_t* qs = reinterpret_cast<int8_t*>(smem);
  int8_t* ks = qs + kRowsQ * ld;
  unsigned char* vs = reinterpret_cast<unsigned char*>(ks) + att_k_region(dk, INT8_PV);
  const int item = blockIdx.y / args.heads, head = blockIdx.y - item * args.heads;
  const int q0 = blockIdx.x * kRowsQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  float* ps = reinterpret_cast<float*>(ks) + warp * 16 * kLdP;  // hybrid: this warp's P rows
  const int rg = lane >> 3, cg = lane & 7;  // hybrid: rows 4 rg.., columns 16 cg.. of the slab
  const int8_t* kg = args.k + (size_t)item * args.m * args.ldkv + head * dk;
  const int8_t* vg = args.v + (size_t)item * args.m * args.ldkv + head * dk;
  load_rows(qs, args.q + (size_t)item * args.n * args.ldq + head * dk, args.ldq, q0, kRowsQ, args.n, dk);

  // pass 1: the exact row max of the scaled scores (rows g and g + 8)
  float mx[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < args.m; kt += kTileK) {
    __syncthreads();
    load_rows(ks, kg, args.ldkv, kt, kTileK, args.m, dk);
    __syncthreads();
    int s[8][4];
    scores(s, qs, ks, dk, m0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = kt + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + (e & 1) < args.m) mx[e >> 1] = fmaxf(mx[e >> 1], __fmul_rn(__int2float_rn(s[j][e]), args.sscale));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }

  // pass 2, per 128-column slab: p = expf(s - m), l = sum(p), O += P V
  for (int v0 = 0; v0 < dk; v0 += kSlabV) {
    double l[2] = {0.0, 0.0};
    int oi[16][4];     // int8 mode: the mma accumulators (rows g, g + 8)
    float of[4][16];   // hybrid: rows 4 rg + i, columns 16 cg + c
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        oi[j][e] = 0;
        of[e][j] = 0.f;
      }
    for (int kt = 0; kt < args.m; kt += kTileK) {
      __syncthreads();
      load_rows(ks, kg, args.ldkv, kt, kTileK, args.m, dk);
      if constexpr (INT8_PV)
        load_v_int8(reinterpret_cast<int8_t*>(vs), vg, args.ldkv, v0, kt, args.m);
      else
        load_v_f32(reinterpret_cast<float*>(vs), vg, args.ldkv, v0, kt, args.m);
      __syncthreads();
      int s[8][4];
      scores(s, qs, ks, dk, m0, lane);
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kt + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sf = __fmul_rn(__int2float_rn(s[j][e]), args.sscale);
          p[j][e] = c + (e & 1) < args.m ? expf(__fsub_rn(sf, mx[e >> 1])) : 0.f;
          l[e >> 1] += static_cast<double>(p[j][e]);
        }
      }
      if constexpr (INT8_PV) {
        int pq[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pq[j][e] = __float2int_rn(__fmul_rn(p[j][e], 127.f));
        const int8_t* pv = reinterpret_cast<const int8_t*>(vs) + g * kLdV8 + 4 * t;
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // 32-key chunks: score tiles 4c..4c+3
          const uint32_t a[4] = {pack4(pq[4 * c][0], pq[4 * c][1], pq[4 * c + 1][0], pq[4 * c + 1][1]),
                                 pack4(pq[4 * c][2], pq[4 * c][3], pq[4 * c + 1][2], pq[4 * c + 1][3]),
                                 pack4(pq[4 * c + 2][0], pq[4 * c + 2][1], pq[4 * c + 3][0], pq[4 * c + 3][1]),
                                 pack4(pq[4 * c + 2][2], pq[4 * c + 2][3], pq[4 * c + 3][2], pq[4 * c + 3][3])};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int8_t* q = pv + 8 * j * kLdV8 + 32 * c;
            mma_s8(oi[j], a, ld32(q), ld32(q + 16));
          }
        }
      } else {
        __syncthreads();  // every warp is done with the K tile, which the P rows overwrite
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ps[(g + 8 * (e >> 1)) * kLdP + 8 * j + 2 * t + (e & 1)] = __bfloat162float(__float2bfloat16_rn(p[j][e]));
        __syncwarp();
        const float* vf = reinterpret_cast<const float*>(vs) + 16 * cg;
        for (int kk = 0; kk < kTileK; ++kk) {
          float pr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[i] = ps[(4 * rg + i) * kLdP + kk];
          float vv[16];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 w = reinterpret_cast<const float4*>(vf + kk * kSlabV)[c];
            vv[4 * c] = w.x;
            vv[4 * c + 1] = w.y;
            vv[4 * c + 2] = w.z;
            vv[4 * c + 3] = w.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 16; ++c) of[i][c] = __fmaf_rn(pr[i], vv[c], of[i][c]);  // the product is exact
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const float lf[2] = {__double2float_rn(l[0]), __double2float_rn(l[1])};
    // O / l rounded to bf16, then quantized at s_att into the Wo GEMM's input
    if constexpr (INT8_PV) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + m0 + g + 8 * half;
        if (row >= args.n) continue;
        int8_t* out = args.out + ((size_t)item * args.n + row) * args.ldo + head * dk + v0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          int qv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float o = __fdiv_rn(__fmul_rn(__int2float_rn(oi[j][2 * half + e]), args.oscale), lf[half]);
            qv[e] = quant(__bfloat162float(__float2bfloat16_rn(o)), args.s_att);
          }
          *reinterpret_cast<uint16_t*>(out + 8 * j + 2 * t) =
              static_cast<uint16_t>((qv[0] & 0xff) | ((qv[1] & 0xff) << 8));
        }
      }
    } else {
      __syncwarp();
      if (t == 0) {  // the row sums, from the score layout to this warp's P rows
        ps[g * kLdP + kTileK] = lf[0];
        ps[(g + 8) * kLdP + kTileK] = lf[1];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i, row = q0 + m0 + r;
        const float lr = ps[r * kLdP + kTileK];
        int qv[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float o = __fdiv_rn(__fmul_rn(of[i][c], args.oscale), lr);
          qv[c] = quant(__bfloat162float(__float2bfloat16_rn(o)), args.s_att);
        }
        if (row < args.n) store_q16(args.out + ((size_t)item * args.n + row) * args.ldo + head * dk + v0 + 16 * cg, qv);
      }
    }
  }
}

template <bool INT8_PV>
int launch_attention(const AttArgs& args, int batch, cudaStream_t stream) {
  const int bytes = att_smem_bytes(args.dk, INT8_PV);
  cudaError_t err = cudaFuncSetAttribute(attention_s8_kernel<INT8_PV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((args.n + kRowsQ - 1) / kRowsQ, batch * args.heads);
  attention_s8_kernel<INT8_PV><<<grid, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}


}  // namespace mma_sync

// ---- launches --------------------------------------------------------------

int launch_s8_pv(const AttArgs& a, int batch, int8_t* vt, int mp, cudaStream_t stream) {
  values_t_kernel<<<dim3((mp + 63) / 64, a.dk / 64, batch * a.heads), 256, 0, stream>>>(a.v, vt, a.m, mp, a.dk,
                                                                                       a.ldkv, a.heads);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const sm90::Layout lay = sm90::s8_layout(a.dk, true);
  CUtensorMap mq, mk, mv;
  err = sm90::make_head_map(&mq, a.q, sm90::HeadMap(a.dk, a.heads, a.n, batch, a.ldq, sm90::kRowsQ),
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = sm90::make_head_map(&mk, a.k, sm90::HeadMap(a.dk, a.heads, a.m, batch, a.ldkv, sm90::kS8TileK),
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)  // V^T (batch * heads, dk, Mp): boxes of 128 keys x 128 columns
    err = sm90::make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, vt, mp, a.dk, batch * a.heads, sm90::kS8TileK,
                         sm90::kSlab);
  if (err != 0) return err;
  const cudaError_t e =
      cudaFuncSetAttribute(attention_s8_pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + sm90::kRowsQ - 1) / sm90::kRowsQ, batch * a.heads);
  attention_s8_pv_kernel<<<grid, sm90::kThreads, lay.total(), stream>>>(mq, mk, mv, a, lay);
  return (int)cudaGetLastError();
}

int launch_hybrid(const AttArgs& a, int batch, cudaStream_t stream) {
  const hybrid::Layout lay(a.dk);
  CUtensorMap mq, mk, mv;
  int err = sm90::make_head_map(&mq, a.q, sm90::HeadMap(a.dk, a.heads, a.n, batch, a.ldq, sm90::kRowsQ),
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = sm90::make_head_map(&mk, a.k, sm90::HeadMap(a.dk, a.heads, a.m, batch, a.ldkv, hybrid::kTileK),
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)  // int8 V as stored, a key a row, for the converters: no swizzle
    err = sm90::make_head_map(&mv, a.v, sm90::HeadMap(a.dk, a.heads, a.m, batch, a.ldkv, hybrid::kTileK),
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(hybrid::attention_hybrid_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + sm90::kRowsQ - 1) / sm90::kRowsQ, batch * a.heads);
  hybrid::attention_hybrid_kernel<<<grid, sm90::kThreads, lay.total(), stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes; all pointers are device pointers, every
// entry launches on `stream` and returns the CUDA error code of the launch
// (0 on success).

// S1. x (rows, d) f32 (x_bf16 = 0) or bf16, contiguous; a, b (d,) f32;
// out (rows, d) int8. do_ln: quant(LN(x)) with ratio = f32(d / (d - 1)) and
// eps; else quant(x). Needs d % 128 == 0 and d <= 1024.
extern "C" int layer_ln_quant(const void* x, const float* a, const float* b, void* out, int rows, int d, int x_bf16,
                              int do_ln, float ratio, float eps, float s, void* stream) {
  if (rows <= 0 || d <= 0 || d % 128 != 0 || d > kLnMaxD) return (int)cudaErrorInvalidValue;
  const LnArgs args{x, a, b, static_cast<int8_t*>(out), rows, d, x_bf16, do_ln, ratio, eps, s};
  ln_quant_kernel<<<(rows + kLnRows - 1) / kLnRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// S2. a (m, k) int8, bt (n, k) int8, cs/bias/so/sr (n,) f32 (sr = 1 / so
// rounded to f32), contiguous, a and bt 16-byte aligned, cs, bias, so and sr
// 8-byte aligned. mode 0: out int8 = quant(acc cs + bias, so); mode 1:
// the same after ReLU; mode 2: out = (res + acc cs) + bias, res f32
// (res_bf16 = 0) or bf16, out f32 (out_bf16 = 0) or bf16, both (m, n).
// Needs n % 128 == 0 and k % 16 == 0.
extern "C" int layer_gemm_s8(const void* a, const void* bt, const float* cs, const float* bias, const float* so,
                             const float* sr, const void* res, void* out, int m, int n, int k, int mode, int res_bf16,
                             int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % gemm::kBN != 0 || k % 16 != 0 || mode < gemm::kRequant ||
      mode > gemm::kResidual)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int err = sm90::make_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, k, m, 1, gemm::kBK, gemm::kBM);
  if (err == 0) err = sm90::make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bt, k, n, 1, gemm::kBK, gemm::kBN);
  if (err != 0) return err;
  const gemm::Args args{cs, bias, so, sr, res, out, m, n, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace gemm;
  if (mode == kRequant) return launch<kRequant, false, false>(ma, mb, args, s);
  if (mode == kReluRequant) return launch<kReluRequant, false, false>(ma, mb, args, s);
  if (res_bf16)
    return out_bf16 ? launch<kResidual, true, true>(ma, mb, args, s) : launch<kResidual, true, false>(ma, mb, args, s);
  return out_bf16 ? launch<kResidual, false, true>(ma, mb, args, s) : launch<kResidual, false, false>(ma, mb, args, s);
}

// S3. q, k, v point at head 0's first column of Q, K and V inside their
// projection buffers: rows of stride ldq (queries, batch * n of them) and
// ldkv (keys and values, batch * m); out (batch * n, ldo) int8, head h at
// columns h dk. sscale = s_q s_k / sqrt(dk); oscale = s_v / 127 with
// int8_pv, s_v without. vt: with int8_pv and dk <= 256, a scratch of
// (batch * heads, dk, mp) int8 for V^T, mp a multiple of 32 >= m (else
// unused). Needs dk % 128 == 0, dk <= 1024, 16-byte aligned q, k and v and
// strides that are multiples of 16. Launches the instance that
// layer_attention_instance names.
extern "C" int layer_attention_s8(const void* q, const void* k, const void* v, void* out, void* vt, int mp, int batch,
                                  int heads, int n, int m, int dk, int ldq, int ldkv, int ldo, float sscale,
                                  float oscale, float s_att, int int8_pv, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || m <= 0 || dk <= 0 || dk % 128 != 0 || dk > mma_sync::kMaxDk ||
      ldq % 16 != 0 || ldkv % 16 != 0 || ldo % 16 != 0 || !(sscale >= 0.f))
    return (int)cudaErrorInvalidValue;
  const AttArgs args{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                     static_cast<int8_t*>(out), n, m, dk, heads, ldq, ldkv, ldo, sscale, oscale, s_att};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk > kSm90MaxDk)
    return int8_pv ? mma_sync::launch_attention<true>(args, batch, s)
                   : mma_sync::launch_attention<false>(args, batch, s);
  if (!int8_pv) return launch_hybrid(args, batch, s);
  if (vt == nullptr || mp < m || mp % 32 != 0) return (int)cudaErrorInvalidValue;
  return launch_s8_pv(args, batch, static_cast<int8_t*>(vt), mp, s);
}

// The S3 instance that layer_attention_s8 launches for (dk, int8_pv).
extern "C" const char* layer_attention_instance(int dk, int int8_pv) {
  static thread_local char name[128];
  if (dk > kSm90MaxDk) {
    snprintf(name, sizeof name, "mma.sync, 64-key tiles");
  } else if (int8_pv) {
    const sm90::Layout lay = sm90::s8_layout(dk, true);
    snprintf(name, sizeof name, "wgmma+TMA two-pass, int8 P.V on V^T, %d-key tiles, %d K + %d V stages",
             sm90::kS8TileK, lay.nk, lay.nv);
  } else {
    snprintf(name, sizeof name, "wgmma+TMA scores, key-order CUDA-core P.V chain, %d-key tiles, %d K stages",
             hybrid::kTileK, hybrid::Layout(dk).nk);
  }
  return name;
}

// The head map (csrc/attention_sm90.cuh) that S3 encodes for a projection
// buffer (batch, rows, ld) of heads of width dk: out[0..11) = its dims (4),
// byte strides (3) and box (4), for the tests.
extern "C" int layer_head_map(int dk, int heads, int rows, int batch, int ld, int box_rows, long long* out) {
  const sm90::HeadMap h(dk, heads, rows, batch, ld, box_rows);
  for (int i = 0; i < 4; ++i) out[i] = (long long)h.dims[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = (long long)h.strides[i];
  for (int i = 0; i < 4; ++i) out[7 + i] = (long long)h.box[i];
  return 0;
}
