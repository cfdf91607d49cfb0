// Fused int8 eval PointNet encoder for Hopper (sm_90a), K2: the BN-folded
// 3->64->64->64->128->emb per-point chain with conv2..conv5 as int8 x int8
// -> int32 products, the requantizing epilogues, and the max over points, in
// one kernel. x (B, N, 3) f32 in, pooled (B, emb) f32 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/pointnet_fused.py::
// pointnet_pooled_int8 (body `_pn_int8_kernel`). Same math as the port's
// plain version `pn_int8_reference`: stage 1 on bf16-rounded operands with
// f32 sums (an fmaf chain of exact products is the sequential sum), bias,
// ReLU, kept in f32; before each int8 stage the activation is requantized as
// round(h * inv_s) (round half to even, __float2int_rn) clamped to 127 (h is
// ReLU'd, so never negative); each stage's epilogue is
// acc * swb[0] + swb[1] as two roundings (__fmul_rn, __fadd_rn; swb[0] =
// s_w * s_x), ReLU except after conv5; relu(max over points) of conv5's
// output. swb[0] > 0, so acc -> acc * swb[0] + swb[1] is monotone: the max is
// taken over the int32 accumulators and the epilogue applied once to it,
// which rounds exactly as the max of the rounded values.
//
// Bound. At B=256, N=1024, emb=1024 the int8 chain is 2 * 262,144 points *
// 147,456 MAC = 77.3 G int8 operations, about 39 us at the dense int8
// tensor-core peak (1,979 TOP/s); stage 1 adds 0.1 G f32 operations; the
// bytes (input 3 MB, output 1 MB) take about 1.2 us at 3.35 TB/s. It is bound
// by operations.
//
// Design, K1's (csrc/pointnet_fused.cu) with int8 operands: mma.sync
// m16n8k32 s8 -> s32 from shared memory (wgmma comes later).
// * Grid (B, ceil(emb / 512)): one block of 8 warps per (cloud, group of up
//   to 512 output channels); the block's 128 x 512 int8 slice of W5 (64 KB)
//   sits in shared memory beside the small weights.
// * The points are walked in tiles of 64; each stage's int8 output goes to
//   shared memory in rows padded by 16 bytes (the row stride is then 4 mod 32
//   words, so fragment loads are free of bank conflicts).
// * Stage 5: warp w owns 1/8 of the block's channels for every point and
//   keeps their running int32 max in registers over 32-row steps (8
//   independent accumulators, each B fragment feeding two mma); one shuffle
//   reduction at the end, then the epilogue and ReLU. Rows past N are left
//   out of the max.
// * The int8 weights arrive transposed, (out, in), from the wrapper, which
//   builds them once per model (PointNetInt8Weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kC1 = 64, kC2 = 64, kC3 = 64, kC4 = 128;
constexpr int kGroup = 512;     // output channels per block, at most
constexpr int kPad5 = 256;      // stage 5 columns: 8 warps x 4 tiles of 8 channels
constexpr int kLd64 = 64 + 16;  // padded row, in bytes, of K=64 int8 operands
constexpr int kLd128 = 128 + 16;

struct Args {
  const float* x;
  const float* w1;       // (3, 64) f32
  const float* b1;       // (64,)
  const int8_t* wt[4];   // conv2..conv5 int8, (out, in)
  const float* swb[4];   // (2, out): [s_w * s_x; b]
  float inv[4];          // 1 / s_x of each int8 stage's input
  float* out;            // (B, emb)
  int n, emb;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ constexpr int smem_bytes(int group) {
  return (kC2 + kC3 + kC4) * kLd64              // w2t, w3t, w4t
         + group * kLd128                        // w5t
         + 4 * (3 * kC1 + kC1)                   // w1, b1
         + 4 * 2 * (kC2 + kC3 + kC4 + group)     // swb2..swb5 (swb5: the group's slice)
         + 4 * kTile * 3                         // x tile
         + 2 * kTile * kLd64                     // ping-pong h1..h3
         + kTile * kLd128;                       // h4
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 rows from m0, all K) of a row-major int8 operand: register
// r holds 4 consecutive k of row g (r even) or g + 8 (r odd), from column
// 4t (r < 2) or 4t + 16.
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 32][4], const int8_t* h, int ld, int m0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = h + (m0 + g) * ld + 4 * t;
#pragma unroll
  for (int kk = 0; kk < K / 32; ++kk) {
    a[kk][0] = ld32(p + kk * 32);
    a[kk][1] = ld32(p + 8 * ld + kk * 32);
    a[kk][2] = ld32(p + kk * 32 + 16);
    a[kk][3] = ld32(p + 8 * ld + kk * 32 + 16);
  }
}

// requantize a non-negative activation: round(v * inv) clamped to 127
__device__ __forceinline__ int requant(float v, float inv) {
  return min(__float2int_rn(__fmul_rn(v, inv)), 127);
}

__device__ __forceinline__ float epilogue(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// out[m0:m0+16, n0:n0+8*NT] = requant(relu(in @ W * s + b)), W given as wt[n][k].
template <int K, int NT>
__device__ __forceinline__ void small_stage(const int8_t* in, int ldi, const int8_t* wt,
                                            const float* swb, int cout, float inv, int8_t* out,
                                            int ldo, int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[K / 32][4];
  load_a<K>(a, in, ldi, m0, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    int acc[4] = {0, 0, 0, 0};
    const int n = n0 + 8 * j;
    const int8_t* q = wt + (n + g) * kLd64 + 4 * t;
#pragma unroll
    for (int kk = 0; kk < K / 32; ++kk) mma_s8(acc, a[kk], ld32(q + kk * 32), ld32(q + kk * 32 + 16));
    const int c = n + 2 * t;
    const float s0 = swb[c], s1 = swb[c + 1], b0 = swb[cout + c], b1 = swb[cout + c + 1];
    const int q00 = requant(fmaxf(epilogue(acc[0], s0, b0), 0.f), inv);
    const int q01 = requant(fmaxf(epilogue(acc[1], s1, b1), 0.f), inv);
    const int q10 = requant(fmaxf(epilogue(acc[2], s0, b0), 0.f), inv);
    const int q11 = requant(fmaxf(epilogue(acc[3], s1, b1), 0.f), inv);
    *reinterpret_cast<uint16_t*>(out + (m0 + g) * ldo + c) = static_cast<uint16_t>(q00 | (q01 << 8));
    *reinterpret_cast<uint16_t*>(out + (m0 + g + 8) * ldo + c) = static_cast<uint16_t>(q10 | (q11 << 8));
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

__global__ void __launch_bounds__(kThreads, 1) pointnet_pooled_int8_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pts = args.n, emb = args.emb;
  const int cloud = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int cols = min(kGroup, emb - c0);
  const int group = min(kGroup, round_up(emb, kPad5));

  int8_t* w2t = reinterpret_cast<int8_t*>(smem);
  int8_t* w3t = w2t + kC2 * kLd64;
  int8_t* w4t = w3t + kC3 * kLd64;
  int8_t* w5t = w4t + kC4 * kLd64;
  float* w1 = reinterpret_cast<float*>(w5t + group * kLd128);
  float* b1 = w1 + 3 * kC1;
  float* s2 = b1 + kC1;
  float* s3 = s2 + 2 * kC2;
  float* s4 = s3 + 2 * kC3;
  float* s5 = s4 + 2 * kC4;  // [scales of the group's columns | their biases]
  float* xs = s5 + 2 * group;
  int8_t* ha = reinterpret_cast<int8_t*>(xs + kTile * 3);
  int8_t* hb = ha + kTile * kLd64;
  int8_t* h4 = hb + kTile * kLd64;

  copy_rows(w2t, kLd64, args.wt[0], kC2, kC1);
  copy_rows(w3t, kLd64, args.wt[1], kC3, kC2);
  copy_rows(w4t, kLd64, args.wt[2], kC4, kC3);
  copy_rows(w5t, kLd128, args.wt[3] + (size_t)c0 * kC4, cols, kC4);
  for (int i = cols * kLd128 + threadIdx.x; i < group * kLd128; i += kThreads) w5t[i] = 0;
  for (int i = threadIdx.x; i < 3 * kC1; i += kThreads) w1[i] = bf16_round(args.w1[i]);
  for (int i = threadIdx.x; i < kC1; i += kThreads) b1[i] = args.b1[i];
  for (int i = threadIdx.x; i < 2 * kC2; i += kThreads) s2[i] = args.swb[0][i];
  for (int i = threadIdx.x; i < 2 * kC3; i += kThreads) s3[i] = args.swb[1][i];
  for (int i = threadIdx.x; i < 2 * kC4; i += kThreads) s4[i] = args.swb[2][i];
  for (int i = threadIdx.x; i < group; i += kThreads) {
    s5[i] = i < cols ? args.swb[3][c0 + i] : 0.f;
    s5[group + i] = i < cols ? args.swb[3][emb + c0 + i] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_cols = round_up(cols, kPad5) / kWarps;
  const int wc0 = warp * warp_cols;
  int mx[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j][0] = mx[j][1] = INT_MIN;

  const float inv1 = args.inv[0], inv2 = args.inv[1], inv3 = args.inv[2], inv4 = args.inv[3];
  const float* xc = args.x + (size_t)cloud * n_pts * 3;
  for (int p0 = 0; p0 < n_pts; p0 += kTile) {
    const int valid = min(kTile, n_pts - p0);
    __syncthreads();  // the weights are in shared memory before the first tile
    for (int i = threadIdx.x; i < kTile * 3; i += kThreads)
      xs[i] = i < valid * 3 ? bf16_round(xc[(size_t)p0 * 3 + i]) : 0.f;
    __syncthreads();
    // stage 1: 3 -> 64 in f32 on the FMA units, requantized for conv2
    for (int i = threadIdx.x; i < kTile * kC1; i += kThreads) {
      const int p = i / kC1, c = i - p * kC1;
      float z = xs[3 * p] * w1[c];
      z = fmaf(xs[3 * p + 1], w1[kC1 + c], z);
      z = fmaf(xs[3 * p + 2], w1[2 * kC1 + c], z);
      ha[p * kLd64 + c] = static_cast<int8_t>(requant(fmaxf(__fadd_rn(z, b1[c]), 0.f), inv1));
    }
    __syncthreads();
    const int m0 = (warp >> 1) * 16;
    small_stage<64, 4>(ha, kLd64, w2t, s2, kC2, inv2, hb, kLd64, m0, (warp & 1) * 32, lane);
    __syncthreads();
    small_stage<64, 4>(hb, kLd64, w3t, s3, kC3, inv3, ha, kLd64, m0, (warp & 1) * 32, lane);
    __syncthreads();
    small_stage<64, 8>(ha, kLd64, w4t, s4, kC4, inv4, h4, kLd128, m0, (warp & 1) * 64, lane);
    __syncthreads();
    // stage 5: 128 -> this warp's channels, folded into the running max
#pragma unroll 1
    for (int r0 = 0; r0 < valid; r0 += 32) {
      uint32_t a[2][4][4];
      load_a<128>(a[0], h4, kLd128, r0, lane);
      load_a<128>(a[1], h4, kLd128, r0 + 16, lane);
      const bool ok[2][2] = {{r0 + g < valid, r0 + g + 8 < valid},
                             {r0 + g + 16 < valid, r0 + g + 24 < valid}};
#pragma unroll
      for (int jg = 0; jg < 8; jg += 4) {
        if (jg * 8 >= warp_cols) break;
        int acc[2][4][4] = {};
        const int8_t* q = w5t + (wc0 + jg * 8 + g) * kLd128 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = ld32(q + j * 8 * kLd128 + kk * 32);
            const uint32_t b1 = ld32(q + j * 8 * kLd128 + kk * 32 + 16);
            mma_s8(acc[0][j], a[0][kk], b0, b1);
            mma_s8(acc[1][j], a[1][kk], b0, b1);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ok[i][0]) {
              mx[jg + j][0] = max(mx[jg + j][0], acc[i][j][0]);
              mx[jg + j][1] = max(mx[jg + j][1], acc[i][j][1]);
            }
            if (ok[i][1]) {
              mx[jg + j][0] = max(mx[jg + j][0], acc[i][j][2]);
              mx[jg + j][1] = max(mx[jg + j][1], acc[i][j][3]);
            }
          }
      }
    }
  }

  float* out = args.out + (size_t)cloud * emb + c0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= warp_cols) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int v = mx[j][e];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int c = wc0 + 8 * j + 2 * t + e;
      if (g == 0 && c < cols) out[c] = fmaxf(epilogue(v, s5[c], s5[group + c]), 0.f);
    }
  }
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; w1 (3, 64) f32, b1 (64,) f32; w2t..w5t int8
// (out, in) of widths 64x64, 64x64, 128x64, emb x 128; swb2..swb5 (2, out)
// f32; inv2..inv5 the reciprocals of the stages' input scales; out (B, emb)
// f32. emb % 64 == 0. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int pointnet_pooled_int8(const float* x, const float* w1, const float* b1,
                                    const void* w2t, const float* swb2, const void* w3t,
                                    const float* swb3, const void* w4t, const float* swb4,
                                    const void* w5t, const float* swb5, float inv2, float inv3,
                                    float inv4, float inv5, float* out, int batch, int n_pts,
                                    int emb, void* stream) {
  if (batch <= 0 || n_pts <= 0 || emb <= 0 || emb % (8 * kWarps) != 0)
    return (int)cudaErrorInvalidValue;
  const int group = round_up(emb, kPad5) < kGroup ? round_up(emb, kPad5) : kGroup;
  const int bytes = smem_bytes(group);
  cudaError_t err = cudaFuncSetAttribute(pointnet_pooled_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Args args{x,
            w1,
            b1,
            {static_cast<const int8_t*>(w2t), static_cast<const int8_t*>(w3t),
             static_cast<const int8_t*>(w4t), static_cast<const int8_t*>(w5t)},
            {swb2, swb3, swb4, swb5},
            {inv2, inv3, inv4, inv5},
            out,
            n_pts,
            emb};
  dim3 grid(batch, (emb + kGroup - 1) / kGroup);
  pointnet_pooled_int8_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
