// Fused softmax attention for Hopper (sm_90a), the DCP pointer's and SVD
// head's softmax(Q K^T / sqrt(D)) V. q, k (BH, N|M, D) bf16, v (BH, M, Dv)
// bf16 in, (BH, N, Dv) out in bf16 or f32 (the caller's q dtype, as the TPU
// kernel writes q.dtype: f32 DCP keeps its f32 output).
//
// Replaces the TPU kernel learning3d_tpu/kernels/attention.py::
// attention_pallas (body `_attn_kernel`). Same math as the port's plain
// version `attention_reference`: bf16 operands, f32 scores times the float
// 1/sqrt(D), the exact row max m, p = expf(s - m) in f32 (expf, not the
// fast __expf), l = sum(p) in f32, P rounded to bf16 before it is
// normalized, O = (P_bf16 @ V) / l, stored in f32 or rounded once to bf16.
// The scaling and the subtraction of m
// are written with __fmul_rn/__fsub_rn so that nvcc does not contract them
// into one FMA, which would round otherwise than the plain version.
//
// Bound. The pointer's call (B=32, H=4, N=M=1024, D=Dv=128) is
// 4 * 128 * 1024 * 1024 * 128 = 68.7 GFLOP, 69 us at the dense bf16 peak
// (989 TFLOP/s); its bytes (4 x 8.4 MB) take 10 us at 3.35 TB/s. The head's
// call (B=32, H=1, D=512, Dv=3) is 34 GFLOP. Both are bound by operations;
// the 134 M exponentials of a pointer call are below that on the SFUs.
//
// Design (simple: mma.sync with ldmatrix fragments from shared memory,
// plain 16-byte loads; wgmma, TMA and overlapped copies come later). The
// TPU kernel keeps K and V whole on chip; at M=1024, D=128 they are 512 KB
// of bf16, more than an SM holds, so K and V are streamed in tiles of 64
// keys.
// * Grid (ceil(N / 128), B * H): one block of 8 warps per 128 query rows,
//   each warp 16 rows; the Q tile stays in shared memory.
// * Two passes over the key tiles, so that P is rounded exactly as the TPU
//   rounds it: pass 1 takes the exact row max of S = Q K^T * scale; pass 2
//   recomputes S, takes p = expf(s - m), sums l in f32 from the unrounded p,
//   and accumulates O += bf16(P) @ V with P taken straight from the score
//   accumulators as mma A fragments. The price is a second Q K^T (1.5x the
//   operations of one pass at D = Dv; an online softmax would round P
//   against a running max instead).
// * D up to 512 is tiled in k-steps of 16 out of shared memory (a 128 x 520
//   Q tile and a 64 x 520 K tile: 197 KB at D=512, one block per SM; 68 KB
//   with the V tile at D=128). __launch_bounds__(256, 2) caps a thread at
//   128 registers so that two blocks share an SM at D=128 (a few bytes of
//   spills at Dv=128); uncapped (182 registers, one block per SM) the
//   pointer's call took 1.5x as long on the H100 (PERF.md).
// * The V tile stays row-major in shared memory (16-byte copies when Dv is
//   a multiple of 8) and its B fragments come from ldmatrix.trans. Dv=3
//   (the head's xyz values) is padded to the mma width inside the kernel:
//   the tile's columns past Dv are zero, never padded in device memory.
//   Dv up to 512: Dv > 128 runs pass 2 once per 128-wide slab of output
//   columns (S recomputed per slab, as K10 does for D > 128), so the V tile
//   and the O accumulators stay at 128 columns and no third instance is
//   built. DCP over DGCNN(emb 1024) has d_k = Dv = 256: two slabs.
// * Ragged N and M: query rows past N are zero and not written; key columns
//   past M are -inf in pass 1 and p = 0 in pass 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsQ = 16 * kWarps;  // query rows per block
constexpr int kTileK = 64;           // keys per tile
constexpr int kMaxD = 512;
constexpr int kMaxDv = 512;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* out;  // float* if out_f32, else bf16*
  int out_f32;
  int n, m, d, dv;
  float scale;
};

// Q tile, K tile, V tile; rows padded by 8 elements (16 bytes) so that the
// eight rows an ldmatrix reads fall in different banks.
__host__ __device__ constexpr int smem_bytes(int d, int ntv) {
  return 2 * (kRowsQ + kTileK) * (d + 8) + 2 * kTileK * (8 * ntv + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
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

// Rows [r0, r0 + rows) of a (total, d) bf16 matrix into padded shared rows;
// rows past `total` are zero. With `width` < d, only columns [c0, c0 +
// width) of each source row (width % 8 == 0).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int rows,
                                          int total, int d, int c0 = 0, int width = 0) {
  if (width == 0) width = d;
  const int chunks = width / 8, ld = width + 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < total) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The warp's 16 x 64 score tile S = Q[m0:m0+16] K_tile^T, unscaled. A
// fragments: lane l addresses Q row m0 + l % 16, column kk + 8 (l / 16).
// B fragments of key tiles j, j+1: lane l addresses K row 8j + (l / 16) 8
// + l % 8, column kk + 8 ((l / 8) % 2).
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* qs, const bf16* ks, int d,
                                       int m0, int lane) {
  const int ld = d + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const bf16* pa = qs + (m0 + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* pb = ks + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < d; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + kk);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, pb + 8 * j * ld + kk);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NTV>
__global__ void __launch_bounds__(kThreads, 2) attention_bf16_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = args.d, ld = d + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRowsQ * ld;
  bf16* vs = ks + kTileK * ld;
  constexpr int kLdV = 8 * NTV + 8;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  const bf16* kg = args.k + (size_t)bh * args.m * d;
  const bf16* vg = args.v + (size_t)bh * args.m * args.dv;
  load_tile(qs, args.q + (size_t)bh * args.n * d, q0, kRowsQ, args.n, d);

  // pass 1: the exact row max of the scaled scores (rows g and g + 8)
  float mx[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < args.m; kt += kTileK) {
    __syncthreads();
    load_tile(ks, kg, kt, kTileK, args.m, d);
    __syncthreads();
    float s[8][4];
    scores(s, qs, ks, d, m0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = kt + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + (e & 1) < args.m) mx[e >> 1] = fmaxf(mx[e >> 1], __fmul_rn(s[j][e], args.scale));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }

  // pass 2, per slab of 8 NTV output columns: p = expf(s - m), l = sum(p),
  // O += bf16(P) @ V
  const size_t out0 = (size_t)bh * args.n * args.dv;
  for (int v0 = 0; v0 < args.dv; v0 += 8 * NTV) {
    float l[2] = {0.f, 0.f};
    float o[NTV][4];
#pragma unroll
    for (int j = 0; j < NTV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int kt = 0; kt < args.m; kt += kTileK) {
      __syncthreads();
      load_tile(ks, kg, kt, kTileK, args.m, d);
      if (args.dv % 8 == 0 && v0 + 8 * NTV <= args.dv) {
        load_tile(vs, vg, kt, kTileK, args.m, args.dv, v0, 8 * NTV);
      } else {
        for (int i = threadIdx.x; i < kTileK * 8 * NTV; i += kThreads) {
          const int key = i / (8 * NTV), col = i - key * (8 * NTV);
          bf16 val = __float2bfloat16_rn(0.f);
          if (v0 + col < args.dv && kt + key < args.m) val = vg[(size_t)(kt + key) * args.dv + v0 + col];
          vs[key * kLdV + col] = val;
        }
      }
      __syncthreads();
      float s[8][4];
      scores(s, qs, ks, d, m0, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kt + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = c + (e & 1) < args.m ? expf(__fsub_rn(__fmul_rn(s[j][e], args.scale), mx[e >> 1])) : 0.f;
          s[j][e] = p;
          l[e >> 1] += p;
        }
      }
      // B fragments of V (row-major [key][col]) by ldmatrix.trans: lane l
      // addresses key row 16 kk + l % 16, column 8j + 8 (l / 16).
      const bf16* pv = vs + (lane & 15) * kLdV + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        if constexpr (NTV == 1) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, pv + 16 * kk * kLdV);
          mma_bf16(o[0], a, b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NTV; j += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, pv + 16 * kk * kLdV + 8 * j);
            mma_bf16(o[j], a, b[0], b[1]);
            mma_bf16(o[j + 1], a, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + m0 + g + 8 * half;
      if (row >= args.n) continue;
#pragma unroll
      for (int j = 0; j < NTV; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = v0 + 8 * j + 2 * t + e;
          if (c >= args.dv) continue;
          const float val = o[j][2 * half + e] / l[half];
          const size_t at = out0 + (size_t)row * args.dv + c;
          if (args.out_f32)
            static_cast<float*>(args.out)[at] = val;
          else
            static_cast<bf16*>(args.out)[at] = __float2bfloat16_rn(val);
        }
      }
    }
  }
}

template <int NTV>
int launch(const Args& args, int bh, cudaStream_t stream) {
  const int bytes = smem_bytes(args.d, NTV);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<NTV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((args.n + kRowsQ - 1) / kRowsQ, bh);
  attention_bf16_kernel<NTV><<<grid, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: q (BH, N, D), k (BH, M, D), v (BH, M, Dv) bf16, out (BH, N, Dv)
// f32 if out_f32 is nonzero, else bf16.
// Needs D % 16 == 0, D <= 512 and 1 <= Dv <= 512. `scale` is 1/sqrt(D) as a
// float. Returns the CUDA error code of the launch (0 on success).
extern "C" int attention_bf16(const void* q, const void* k, const void* v, void* out, int out_f32,
                              int bh, int n, int m, int d, int dv, float scale, void* stream) {
  if (bh <= 0 || n <= 0 || m <= 0 || d <= 0 || d % 16 != 0 || d > kMaxD || dv <= 0 ||
      dv > kMaxDv)
    return (int)cudaErrorInvalidValue;
  const Args args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), out, out_f32, n, m, d, dv, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two instances: the head's Dv <= 8 and 128-wide slabs (the pointer's);
  // each instance costs build time, and other widths run on the wider one
  return dv <= 8 ? launch<1>(args, bh, s) : launch<16>(args, bh, s);
}
