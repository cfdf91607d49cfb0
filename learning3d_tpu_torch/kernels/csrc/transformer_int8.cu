// Fused int8 pre-norm transformer layers for Hopper (sm_90a), K11a and K11b:
// the int8 DCP pointer's encoder layer (LN1 -> int8 self-attention ->
// residual -> LN2 -> int8 feed-forward -> residual) and decoder layer (the
// same with an int8 cross-attention block on the memory after LN2, and LN3
// before the feed-forward). x (B, N, d) bf16 or f32 in, the same out.
//
// Replaces the TPU kernels learning3d_tpu/kernels/transformer_int8.py::
// encoder_layer_int8 (body `_enc_kernel`) and ::decoder_layer_int8 (body
// `_dec_kernel`). Same math as the port's plain versions
// `encoder_layer_int8_reference` / `decoder_layer_int8_reference`.
//
// The split. The TPU kernel runs one whole layer per batch item inside its
// VMEM (~12 MB at the DCP shape). An SM has 227 KB of shared memory and one
// (1024, 512) f32 activation is 2 MB, so here a layer is a short chain of
// launches whose int8 and f32 intermediates go through device memory (L2
// mostly: 0.5-2 MB a batch item):
//   S1 `ln_quant`      one warp a row: LayerNorm in f32, then quant (or quant
//                      alone, for the decoder's memory);
//   S2 `gemm_s8`       int8 x int8 -> int32 on mma.sync m16n8k32, 128 x 128
//                      block tiles, cp.async double buffering, and one of
//                      three epilogues: requant at a per-column output scale
//                      (Q|K|V in one GEMM for self-attention, K|V for cross,
//                      Q alone for cross), ReLU + requant (FF1), dequant +
//                      bias + f32 residual (Wo, FF2);
//   S3 `attention_s8`  K10's two-pass int8 attention (csrc/attention_int8.cu)
//                      reading Q, K and V by head in place from the
//                      projection buffers (row stride 3d, or d and 2d for
//                      cross); int8 P.V on the tensor cores with V
//                      transposed inside its shared-memory tile load, the
//                      hybrid P.V on the CUDA cores (below); its epilogue
//                      rounds O to bf16 and quantizes it at s_att.
// Launches a layer: encoder 7 (S1, S2 QKV, S3, S2 Wo, S1, S2 FF1, S2 FF2),
// decoder 13 (S1, S2 QKV, S3, S2 Wo, S1, S1 memory, S2 Q, S2 KV, S3, S2 Wo,
// S1, S2 FF1, S2 FF2). The residual stream stays f32 between them and is
// written in x's dtype by the last GEMM only. Fusing further is later work.
//
// Numeric traps, each kept as the plain version (and the TPU kernel) has it:
// * The oracle is the *_reference functions, not the module path: for a
//   bf16 model the module path rounds each block's output to bf16 and adds
//   the residual in bf16, while the layer keeps f32 throughout.
// * quant is round(x / s) by IEEE division (__fdiv_rn), half to even
//   (rintf), clamped to +-127. Built without --use_fast_math, and every
//   epilogue is written with __fmul_rn/__fadd_rn so that nvcc does not
//   contract it into FMAs: a one-ulp difference flips a .5 tie.
// * Association: projections acc * (f32(s_x) * s_w[c]) + b[c]; residual
//   blocks (x32 + acc * (f32(s_att) * s_wo[c])) + b_o[c]. The products of
//   scales are formed once, when the layer's weights are packed.
// * The attention output passes through bf16 before its s_att quant. P is
//   round(127 p) against the exact row max; l sums the unrounded f32 p.
// * sscale = s_q s_k / sqrt(d_k) is taken in double by the caller and
//   rounded to f32 once; K and V keep separate requant scales, per column.
// * One flipped int8 value moves a whole row of the next GEMM, and through
//   K and V every row of its batch item: at the DCP shape a handful of
//   flips a layer moved 5-7% of the outputs past the tie-flip profile on
//   the H100. So every sum whose order the two versions could not share is
//   made order-free: the LayerNorm statistics and the softmax's l are
//   summed in f64 and rounded to f32 once, and the hybrid P.V (exact f32
//   products bf16(p) v) is summed in key order on the CUDA cores, as the
//   plain version sums it. The JAX package sums these in f32 in XLA's
//   order; the CPU tests hold the port's plain version to it.
//
// Bound. At the DCP shape (B=32, N=1024, d=512, 4 heads, ff 1024) an encoder
// layer is 2 * 32,768 * 512 * (3 * 512 + 512 + 2 * 1024) = 137 G int8
// operations in its GEMMs and 4 * 32 * 4 * 1024 * 1024 * 128 = 69 G in its
// attention (with the hybrid P.V half of those at the bf16 rate): about 0.10
// ms at the dense int8 peak (1,979 TOP/s); the decoder about 0.17 ms. Its
// bytes are a few tens of MB (0.01-0.03 ms at 3.35 TB/s). So it is bound by
// operations; mma.sync from shared memory reaches a fraction of that peak
// (wgmma is the later step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return (static_cast<uint32_t>(b0) & 0xffu) | ((static_cast<uint32_t>(b1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(b2) & 0xffu) << 16) | (static_cast<uint32_t>(b3) << 24);
}

// round(y / s), half to even, clamped to +-127.
__device__ __forceinline__ int quant(float y, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLdS = kBK + 16;  // shared rows of 80 bytes: conflict-free fragment loads

enum GemmMode { kRequant = 0, kReluRequant = 1, kResidual = 2 };

struct GemmArgs {
  const int8_t* a;    // (m, k) int8
  const int8_t* bt;   // (n, k) int8: the weight transposed, (out, in)
  const float* cs;    // (n,) f32(s_x) * s_w
  const float* bias;  // (n,)
  const float* so;    // (n,) output scales (requant modes)
  const void* res;    // (m, n) residual, f32 or bf16 (residual mode)
  void* out;          // (m, n): int8 (requant modes), f32 or bf16 (residual mode)
  int m, n, k, mode, res_bf16, out_bf16;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// Grid (n / 128, ceil(m / 128)); 8 warps as 2 x 4, each a 64 x 32 tile.
__global__ void __launch_bounds__(kThreads) gemm_s8_kernel(GemmArgs args) {
  __shared__ __align__(16) int8_t as[2][kBM * kLdS];
  __shared__ __align__(16) int8_t bs[2][kBN * kLdS];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = args.k / kBK;

  auto load = [&](int buf, int kt) {
    const int k0 = kt * kBK;
    for (int i = threadIdx.x; i < kBM * (kBK / 16); i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool valid = m0 + r < args.m;  // rows past m are zero-filled
      cp_async16(&as[buf][r * kLdS + c], args.a + (size_t)(valid ? m0 + r : 0) * args.k + k0 + c, valid);
      cp_async16(&bs[buf][r * kLdS + c], args.bt + (size_t)(n0 + r) * args.k + k0 + c, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int8_t* A = as[kt & 1];
    const int8_t* Bs = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = A + (wm + 16 * i + g) * kLdS + kk + 4 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * kLdS);
        a[i][2] = ld32(p + 16);
        a[i][3] = ld32(p + 8 * kLdS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* q = Bs + (wn + 8 * j + g) * kLdS + kk + 4 * t;
        b[j][0] = ld32(q);
        b[j][1] = ld32(q + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the buffer is refilled by the next iteration's load
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    const float cs0 = args.cs[col], cs1 = args.cs[col + 1];
    const float b0 = args.bias[col], b1 = args.bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * i + g + 8 * half;
        if (row >= args.m) continue;
        const float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * half]), cs0);
        const float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), cs1);
        const size_t at = (size_t)row * args.n + col;
        if (args.mode == kResidual) {
          float r0, r1;
          if (args.res_bf16) {
            const uint32_t w = ld32(static_cast<const bf16*>(args.res) + at);
            r0 = __uint_as_float(w << 16);
            r1 = __uint_as_float(w & 0xffff0000u);
          } else {
            const float2 w = *reinterpret_cast<const float2*>(static_cast<const float*>(args.res) + at);
            r0 = w.x;
            r1 = w.y;
          }
          const float y0 = __fadd_rn(__fadd_rn(r0, v0), b0), y1 = __fadd_rn(__fadd_rn(r1, v1), b1);
          if (args.out_bf16)
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(args.out) + at) = pack_bf16(y0, y1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(args.out) + at) = make_float2(y0, y1);
        } else {
          float y0 = __fadd_rn(v0, b0), y1 = __fadd_rn(v1, b1);
          if (args.mode == kReluRequant) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          const int q0 = quant(y0, args.so[col]), q1 = quant(y1, args.so[col + 1]);
          *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(args.out) + at) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- S3 ----

constexpr int kAttWarps = 8;
constexpr int kRowsQ = 16 * kAttWarps;  // query rows a block
constexpr int kTileK = 64;              // keys a tile
constexpr int kSlabV = 128;             // output columns a pass-2 slab
constexpr int kMaxDk = 1024;
constexpr int kLdV8 = kTileK + 16;      // int8 V tile row (bytes), one row a column
constexpr int kLdP = kTileK + 4;        // hybrid: a warp's P rows (f32)

struct AttArgs {
  const int8_t* q;  // head 0's first column of Q, rows of stride ldq
  const int8_t* k;  // head 0's first column of K, rows of stride ldkv
  const int8_t* v;  // head 0's first column of V, rows of stride ldkv
  int8_t* out;      // (batch * n, ldo), head h at columns h dk
  int n, m, dk, heads, ldq, ldkv, ldo;
  float sscale, oscale, s_att;
};

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

// Grid (ceil(n / 128), batch * heads). K10's design (csrc/attention_int8.cu):
// pass 1 takes the exact row max, pass 2 per 128-column slab p, l and O.
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

// S2. a (m, k) int8, bt (n, k) int8, cs/bias/so (n,) f32, contiguous.
// mode 0: out int8 = quant(acc cs + bias, so); mode 1: the same after ReLU;
// mode 2: out = (res + acc cs) + bias, res f32 (res_bf16 = 0) or bf16, out
// f32 (out_bf16 = 0) or bf16, both (m, n). Needs n % 128 == 0, k % 64 == 0.
extern "C" int layer_gemm_s8(const void* a, const void* bt, const float* cs, const float* bias, const float* so,
                             const void* res, void* out, int m, int n, int k, int mode, int res_bf16, int out_bf16,
                             void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % kBN != 0 || k % kBK != 0 || mode < kRequant || mode > kResidual)
    return (int)cudaErrorInvalidValue;
  const GemmArgs args{static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt), cs, bias, so, res, out,
                      m, n, k, mode, res_bf16, out_bf16};
  dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  gemm_s8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// S3. q, k, v point at head 0's first column of Q, K and V inside their
// projection buffers: rows of stride ldq (queries, batch * n of them) and
// ldkv (keys and values, batch * m); out (batch * n, ldo) int8, head h at
// columns h dk. sscale = s_q s_k / sqrt(dk); oscale = s_v / 127 with
// int8_pv, s_v without. Needs dk % 128 == 0, dk <= 1024 and strides that
// are multiples of 16.
extern "C" int layer_attention_s8(const void* q, const void* k, const void* v, void* out, int batch, int heads,
                                  int n, int m, int dk, int ldq, int ldkv, int ldo, float sscale, float oscale,
                                  float s_att, int int8_pv, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || m <= 0 || dk <= 0 || dk % kSlabV != 0 || dk > kMaxDk ||
      ldq % 16 != 0 || ldkv % 16 != 0 || ldo % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const AttArgs args{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                     static_cast<int8_t*>(out), n, m, dk, heads, ldq, ldkv, ldo, sscale, oscale, s_att};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8_pv ? launch_attention<true>(args, batch, s) : launch_attention<false>(args, batch, s);
}
