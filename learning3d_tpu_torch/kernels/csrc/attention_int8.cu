// Fused int8 softmax attention for Hopper (sm_90a), K10: the int8 pointer's
// softmax((q s_q)(k s_k)^T / sqrt(D)) (v s_v). q, k (BH, N|M, D) int8 and V
// transposed, vt (BH, D, Mp) int8 with the keys zero-padded to Mp (a multiple
// of 64), in; (BH, N, D) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/attention.py::
// attention_int8 (body `_attn_kernel_int8`). Same math as the port's plain
// version `attention_int8_reference`: S = float(int32(q k^T)) * sscale
// (sscale = s_q s_k / sqrt(D) as a float), the exact row max m,
// p = expf(s - m) in f32 (the row max of p is exactly 1), l = sum(p) in f32;
// with INT8_PV, P = round(127 p) (round half to even) and
// O = float(int32(P V)) * oscale / l with oscale = s_v / 127; otherwise
// ("hybrid") P = bf16(p), O = (P @ bf16(V) in f32) * oscale / l with oscale =
// s_v (int8 values are exact in bf16). P is rounded against the exact row
// max, unnormalized, as the TPU kernel rounds it. Scale, subtraction and the
// epilogue are written with __fmul_rn/__fsub_rn/__fdiv_rn so that nvcc does
// not contract them.
//
// Bound. The pointer's call (B=32, H=4, N=M=1024, D=128) is
// 4 * 128 * 1024 * 1024 * 128 = 68.7 G operations: with INT8_PV all int8,
// 35 us at the dense int8 peak (1,979 TOP/s); hybrid, QK^T at the int8 rate
// and PV at the bf16 rate (989 TFLOP/s), 52 us. Its bytes (4 x 4.2 MB in, 8.4
// MB out) take 5 us at 3.35 TB/s. The 134 M exponentials take about 30 us of
// SFU time on their own (16 a cycle an SM at 1.98 GHz), beside the bound.
//
// Design, K6's (csrc/attention.cu) with int8 operands: mma.sync m16n8k32
// s8 -> s32 for QK^T (and PV with INT8_PV), m16n8k16 bf16 for the hybrid PV.
// * Grid (ceil(N / 128), BH): one block of 8 warps per 128 query rows, each
//   warp 16 rows; the Q tile stays in shared memory; K and V stream in tiles
//   of 64 keys. Two passes over the key tiles: pass 1 takes the exact row
//   max, pass 2 recomputes S and accumulates O. D > 128 runs pass 2 once per
//   128-wide slab of output columns (S recomputed per slab).
// * P goes from the score accumulators straight into A fragments. A score
//   tile gives a thread keys 2t, 2t+1 of each 8-key tile, while the int8 A
//   fragment wants 4 consecutive k: so the k order inside each 32-key chunk
//   is permuted (logical 4t..4t+3 = keys 2t, 2t+1, 8+2t, 9+2t of a 16-key
//   half), and V is stored in shared memory in the same order. The sum over
//   keys does not depend on their order.
// * V: ldmatrix.trans works on 16-bit elements only, so int8 V cannot be
//   transposed into the B layout that way. The wrapper hands V over already
//   transposed (one copy, (D, Mp) per head), so a tile row is 64 keys of one
//   column: a 16-byte load, four __byte_perm into the permuted order (int8
//   mode) or a widening to bf16 (hybrid), a 16-byte store. No element-wise
//   transpose.
// * Ragged N and M: query rows past N are zero and not written; key columns
//   past M are -inf in pass 1 and p = 0 in pass 2 (their V columns are the
//   wrapper's zero padding).

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
constexpr int kSlabV = 128;          // output columns per pass-2 slab
constexpr int kMaxD = 512;
constexpr int kLdV8 = kTileK + 16;   // int8 V tile row (bytes)
constexpr int kLdVb = kTileK + 8;    // bf16 V tile row (elements)

struct Args {
  const int8_t* q;
  const int8_t* k;
  const int8_t* vt;
  bf16* out;
  int n, m, mp, d;
  float sscale, oscale;
};

__host__ __device__ constexpr int smem_bytes(int d) {
  return (kRowsQ + kTileK) * (d + 16) + 2 * kSlabV * kLdVb;  // Q, K tiles; the V tile (either form)
}

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
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

// Rows [r0, r0 + rows) of a (total, d) int8 matrix into shared rows of d + 16
// bytes; rows past `total` are zero.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int r0, int rows, int total, int d) {
  const int chunks = d / 16, ld = d + 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < total) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The V tile: columns [v0, v0 + 128) (rows of vt) for keys [kt, kt + 64).
// int8: each 16-key group permuted so that bytes 4t..4t+3 hold keys 2t,
// 2t+1, 8+2t, 9+2t (the order of P's A fragments). bf16: widened, in order.
template <bool INT8_PV>
__device__ __forceinline__ void load_v(void* dst, const int8_t* vt, int v0, int kt, int mp) {
  for (int i = threadIdx.x; i < kSlabV * (kTileK / 16); i += kThreads) {
    const int r = i >> 2, c = (i & 3) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(vt + (size_t)(v0 + r) * mp + kt + c);
    if constexpr (INT8_PV) {
      const uint4 p = make_uint4(__byte_perm(w.x, w.z, 0x5410), __byte_perm(w.x, w.z, 0x7632),
                                 __byte_perm(w.y, w.w, 0x5410), __byte_perm(w.y, w.w, 0x7632));
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(dst) + r * kLdV8 + c) = p;
    } else {
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f0 = static_cast<float>(static_cast<int8_t>(words[e] & 0xffu));
        const float f1 = static_cast<float>(static_cast<int8_t>((words[e] >> 8) & 0xffu));
        const float f2 = static_cast<float>(static_cast<int8_t>((words[e] >> 16) & 0xffu));
        const float f3 = static_cast<float>(static_cast<int8_t>(words[e] >> 24));
        h[2 * e] = pack_bf16(f0, f1);
        h[2 * e + 1] = pack_bf16(f2, f3);
      }
      uint4* out = reinterpret_cast<uint4*>(static_cast<bf16*>(dst) + r * kLdVb + c);
      out[0] = make_uint4(h[0], h[1], h[2], h[3]);
      out[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
}

// The warp's 16 x 64 int32 score tile S = Q[m0:m0+16] K_tile^T.
__device__ __forceinline__ void scores(int (&s)[8][4], const int8_t* qs, const int8_t* ks, int d, int m0,
                                       int lane) {
  const int ld = d + 16, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
  const int8_t* pa = qs + (m0 + g) * ld + 4 * t;
  const int8_t* pb = ks + g * ld + 4 * t;
  for (int kk = 0; kk < d; kk += 32) {
    const uint32_t a[4] = {ld32(pa + kk), ld32(pa + 8 * ld + kk), ld32(pa + kk + 16), ld32(pa + 8 * ld + kk + 16)};
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_s8(s[j], a, ld32(pb + 8 * j * ld + kk), ld32(pb + 8 * j * ld + kk + 16));
  }
}

template <bool INT8_PV>
__global__ void __launch_bounds__(kThreads, 2) attention_int8_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = args.d, ld = d + 16;
  int8_t* qs = reinterpret_cast<int8_t*>(smem);
  int8_t* ks = qs + kRowsQ * ld;
  void* vs = ks + kTileK * ld;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  const int8_t* kg = args.k + (size_t)bh * args.m * d;
  const int8_t* vg = args.vt + (size_t)bh * d * args.mp;
  load_tile(qs, args.q + (size_t)bh * args.n * d, q0, kRowsQ, args.n, d);

  // pass 1: the exact row max of the scaled scores (rows g and g + 8)
  float mx[2] = {-INFINITY, -INFINITY};
  for (int kt = 0; kt < args.m; kt += kTileK) {
    __syncthreads();
    load_tile(ks, kg, kt, kTileK, args.m, d);
    __syncthreads();
    int s[8][4];
    scores(s, qs, ks, d, m0, lane);
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
  bf16* out = args.out + (size_t)bh * args.n * d;
  for (int v0 = 0; v0 < d; v0 += kSlabV) {
    float l[2] = {0.f, 0.f};
    int oi[16][4];
    float of[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        oi[j][e] = 0;
        of[j][e] = 0.f;
      }
    for (int kt = 0; kt < args.m; kt += kTileK) {
      __syncthreads();
      load_tile(ks, kg, kt, kTileK, args.m, d);
      load_v<INT8_PV>(vs, vg, v0, kt, args.mp);
      __syncthreads();
      int s[8][4];
      scores(s, qs, ks, d, m0, lane);
      float p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kt + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sf = __fmul_rn(__int2float_rn(s[j][e]), args.sscale);
          p[j][e] = c + (e & 1) < args.m ? expf(__fsub_rn(sf, mx[e >> 1])) : 0.f;
          l[e >> 1] += p[j][e];
        }
      }
      if constexpr (INT8_PV) {
        int pq[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pq[j][e] = __float2int_rn(__fmul_rn(p[j][e], 127.f));
        const int8_t* pv = static_cast<const int8_t*>(vs) + g * kLdV8 + 4 * t;
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
        const bf16* pv = static_cast<const bf16*>(vs) + g * kLdVb + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                                 pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                                 pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const bf16* q = pv + 8 * j * kLdVb + 16 * kk;
            mma_bf16(of[j], a, ld32(q), ld32(q + 8));
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
      for (int j = 0; j < 16; ++j) {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float acc = INT8_PV ? __int2float_rn(oi[j][2 * half + e]) : of[j][2 * half + e];
          o[e] = __fdiv_rn(__fmul_rn(acc, args.oscale), l[half]);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)row * d + v0 + 8 * j + 2 * t) = pack_bf16(o[0], o[1]);
      }
    }
  }
}

template <bool INT8_PV>
int launch(const Args& args, int bh, cudaStream_t stream) {
  const int bytes = smem_bytes(args.d);
  cudaError_t err = cudaFuncSetAttribute(attention_int8_kernel<INT8_PV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((args.n + kRowsQ - 1) / kRowsQ, bh);
  attention_int8_kernel<INT8_PV><<<grid, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: q (BH, N, D) int8, k (BH, M, D) int8, vt (BH, D, Mp) int8 (V
// transposed, keys zero-padded to Mp, a multiple of 64 >= M), out (BH, N, D)
// bf16. Needs D % 128 == 0 and D <= 512. sscale = s_q s_k / sqrt(D); oscale =
// s_v / 127 with int8_pv, s_v without. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int attention_int8(const void* q, const void* k, const void* vt, void* out, int bh, int n, int m,
                              int mp, int d, float sscale, float oscale, int int8_pv, void* stream) {
  if (bh <= 0 || n <= 0 || m <= 0 || d <= 0 || d % kSlabV != 0 || d > kMaxD || mp < m || mp % kTileK != 0)
    return (int)cudaErrorInvalidValue;
  const Args args{static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(vt),
                  static_cast<bf16*>(out), n, m, mp, d, sscale, oscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8_pv ? launch<true>(args, bh, s) : launch<false>(args, bh, s);
}
