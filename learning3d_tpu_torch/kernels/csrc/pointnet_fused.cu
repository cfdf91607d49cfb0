// Fused eval-mode PointNet encoder for Hopper (sm_90a): the BN-folded
// 3->64->64->64->128->emb per-point chain, ReLU, and the max over points,
// in one kernel. x (B, N, 3) f32 in, pooled (B, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/pointnet_fused.py::
// pointnet_pooled_kernel (body `_pn_kernel`). Same math as the port's plain
// version `oracle_chain`: operands rounded to bf16, f32 accumulation, f32
// bias, ReLU, h_{i+1} rounded to bf16; the last stage's pre-activation is
// max-reduced over the points and relu(max) is written (relu and max
// commute), so no (N, emb) tensor ever leaves the SM.
//
// Bound. At B=256, N=1024, emb=1024 the chain is 2 * 262,144 points *
// 147,648 MAC = 77.4 GFLOP, about 78 us at the dense bf16 tensor-core peak
// (989 TFLOP/s); its bytes (input 3 MB, weights 0.6 MB, output 0.5 MB) take
// about 1.2 us at 3.35 TB/s. So it is bound by operations, and 89% of them
// are in the last 128->emb stage.
//
// Design (simple: mma.sync from shared memory; wgmma/TMA come later).
// * Grid (B, ceil(emb / 512)): one block per (cloud, group of up to 512
//   output channels), 8 warps. With emb=1024 that is 512 blocks, 3.9 waves
//   on 132 SMs at one block per SM. Splitting the channels in two makes each
//   block recompute the four small stages (16,576 MAC a point), about 11%
//   more MACs than one block per cloud; in return the block's 128 x 512 bf16
//   slice of W5 fits in shared memory beside the small weights, so stage 5
//   reads its operands from shared memory only.
// * The points are walked in tiles of 64. Stage 1 (K=3) runs as f32 FMAs on
//   bf16-rounded operands; stages 2-5 run on the tensor cores with
//   mma.sync.m16n8k16 bf16 -> f32. Each stage's output goes to shared memory
//   as bf16; rows are padded by 8 elements so that fragment loads are free of
//   bank conflicts.
// * Stage 5: warp w owns 1/8 of the block's channels for every point; the
//   f32 products are folded into a running max in registers, rows past N
//   masked out. A warp works on 32 rows x 32 channels at a time: 8
//   independent accumulators keep the tensor pipe busy across mma latency,
//   and each B fragment read from shared memory feeds two mma. The bias is
//   added after the max: rounding is monotonic, so max(acc) + b rounds to
//   max(acc + b). One shuffle reduction at the end, no atomics, no second
//   pass. (One 16x8 tile at a time, 8 dependent mma each, took 1.3x as
//   long on the H100; PERF.md.)
// * Ragged N is masked here: the last tile's missing points read x = 0 and
//   are left out of the max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // points per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kC1 = 64, kC2 = 64, kC3 = 64, kC4 = 128;
constexpr int kGroup = 512;     // output channels per block, at most
constexpr int kPad5 = 256;      // stage 5 columns: 8 warps x 4 tiles of 8 channels
constexpr int kLd64 = 64 + 8;   // padded row (bf16 elements) of K=64 operands
constexpr int kLd128 = 128 + 8; // padded row of K=128 operands

typedef __nv_bfloat16 bf16;

struct Args {
  const float* x;
  const float* w[5];
  const float* b[5];
  bf16* out;
  int n, emb;
};

__host__ __device__ constexpr int smem_bytes(int group) {
  return 2 * (kC2 + kC3 + kC4) * kLd64        // w2t, w3t, w4t
         + 2 * group * kLd128                  // w5t
         + 4 * (3 * kC1 + kC1 + kC2 + kC3 + kC4)  // w1, b1..b4
         + 4 * kTile * 3                       // x tile
         + 2 * 2 * kTile * kLd64               // ping-pong h1..h3
         + 2 * kTile * kLd128;                 // h4
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 rows from m0, all K) of a row-major bf16 operand.
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4], const bf16* h,
                                       int ld, int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = h + (m0 + g) * ld + 2 * t;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = ld32(p + kk * 16);
    a[kk][1] = ld32(p + 8 * ld + kk * 16);
    a[kk][2] = ld32(p + kk * 16 + 8);
    a[kk][3] = ld32(p + 8 * ld + kk * 16 + 8);
  }
}

// One 16x8 output tile: A fragments times the transposed weight wt[n][k].
template <int K>
__device__ __forceinline__ void tile_mma(float (&acc)[4], const uint32_t (&a)[K / 16][4],
                                         const bf16* wt, int ld, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* q = wt + (n0 + g) * ld + 2 * t;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) mma_bf16(acc, a[kk], ld32(q + kk * 16), ld32(q + kk * 16 + 8));
}

// out[m0:m0+16, n0:n0+8*NT] = bf16(relu(in @ W + b)), W given as wt[n][k].
template <int K, int NT>
__device__ __forceinline__ void small_stage(const bf16* in, int ldi, const bf16* wt,
                                            const float* bias, bf16* out, int ldo,
                                            int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[K / 16][4];
  load_a<K>(a, in, ldi, m0, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float acc[4];
    const int n = n0 + 8 * j;
    tile_mma<K>(acc, a, wt, kLd64, n, lane);
    const int c = n + 2 * t;
    const float bb0 = bias[c], bb1 = bias[c + 1];
    *reinterpret_cast<__nv_bfloat162*>(out + (m0 + g) * ldo + c) =
        __floats2bfloat162_rn(fmaxf(acc[0] + bb0, 0.f), fmaxf(acc[1] + bb1, 0.f));
    *reinterpret_cast<__nv_bfloat162*>(out + (m0 + g + 8) * ldo + c) =
        __floats2bfloat162_rn(fmaxf(acc[2] + bb0, 0.f), fmaxf(acc[3] + bb1, 0.f));
  }
}

// Copy W (K, O) f32, columns [c0, c0 + cols), into wt[o][k] bf16.
__device__ void load_weight_t(bf16* wt, int ld, const float* w, int k_dim, int o_dim,
                              int c0, int cols) {
  for (int i = threadIdx.x; i < k_dim * cols; i += kThreads) {
    const int k = i / cols, o = i - k * cols;
    wt[o * ld + k] = __float2bfloat16_rn(w[k * o_dim + c0 + o]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) pointnet_pooled_bf16_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pts = args.n, emb = args.emb;
  const int cloud = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int cols = min(kGroup, emb - c0);
  const int group = min(kGroup, round_up(emb, kPad5));

  bf16* w2t = reinterpret_cast<bf16*>(smem);
  bf16* w3t = w2t + kC2 * kLd64;
  bf16* w4t = w3t + kC3 * kLd64;
  bf16* w5t = w4t + kC4 * kLd64;
  float* w1 = reinterpret_cast<float*>(w5t + group * kLd128);
  float* b1 = w1 + 3 * kC1;
  float* b2 = b1 + kC1;
  float* b3 = b2 + kC2;
  float* b4 = b3 + kC3;
  float* xs = b4 + kC4;
  bf16* ha = reinterpret_cast<bf16*>(xs + kTile * 3);
  bf16* hb = ha + kTile * kLd64;
  bf16* h4 = hb + kTile * kLd64;

  load_weight_t(w2t, kLd64, args.w[1], kC1, kC2, 0, kC2);
  load_weight_t(w3t, kLd64, args.w[2], kC2, kC3, 0, kC3);
  load_weight_t(w4t, kLd64, args.w[3], kC3, kC4, 0, kC4);
  load_weight_t(w5t, kLd128, args.w[4], kC4, emb, c0, cols);
  for (int i = cols * kLd128 + threadIdx.x; i < group * kLd128; i += kThreads)
    w5t[i] = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < 3 * kC1; i += kThreads) w1[i] = bf16_round(args.w[0][i]);
  for (int i = threadIdx.x; i < kC1; i += kThreads) b1[i] = args.b[0][i];
  for (int i = threadIdx.x; i < kC2; i += kThreads) b2[i] = args.b[1][i];
  for (int i = threadIdx.x; i < kC3; i += kThreads) b3[i] = args.b[2][i];
  for (int i = threadIdx.x; i < kC4; i += kThreads) b4[i] = args.b[3][i];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Stage 5 runs on the group's columns rounded up to kPad5 (W5 rows past
  // `cols` are zero), so each warp owns 32 or 64 channels: 1 or 2 sets of
  // four 8-channel tiles.
  const int warp_cols = round_up(cols, kPad5) / kWarps;
  const int wc0 = warp * warp_cols;          // warp's first channel in the group
  float mx[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx[j][0] = mx[j][1] = -INFINITY;

  const float* xc = args.x + (size_t)cloud * n_pts * 3;
  for (int p0 = 0; p0 < n_pts; p0 += kTile) {
    const int valid = min(kTile, n_pts - p0);
    __syncthreads();  // the weights are in shared memory before the first tile
    for (int i = threadIdx.x; i < kTile * 3; i += kThreads)
      xs[i] = i < valid * 3 ? bf16_round(xc[(size_t)p0 * 3 + i]) : 0.f;
    __syncthreads();
    // stage 1: 3 -> 64 on the FMA units
    for (int i = threadIdx.x; i < kTile * kC1; i += kThreads) {
      const int p = i / kC1, c = i - p * kC1;
      float z = xs[3 * p] * w1[c];
      z = fmaf(xs[3 * p + 1], w1[kC1 + c], z);
      z = fmaf(xs[3 * p + 2], w1[2 * kC1 + c], z);
      ha[p * kLd64 + c] = __float2bfloat16_rn(fmaxf(z + b1[c], 0.f));
    }
    __syncthreads();
    const int m0 = (warp >> 1) * 16;
    small_stage<64, 4>(ha, kLd64, w2t, b2, hb, kLd64, m0, (warp & 1) * 32, lane);
    __syncthreads();
    small_stage<64, 4>(hb, kLd64, w3t, b3, ha, kLd64, m0, (warp & 1) * 32, lane);
    __syncthreads();
    small_stage<64, 8>(ha, kLd64, w4t, b4, h4, kLd128, m0, (warp & 1) * 64, lane);
    __syncthreads();
    // stage 5: 128 -> this warp's channels, folded into the running max.
    // Two 16-row tiles at a time, so every B fragment feeds two mma, and
    // four channel tiles at a time: 8 independent accumulators in flight.
#pragma unroll 1
    for (int r0 = 0; r0 < valid; r0 += 32) {
      uint32_t a[2][8][4];
      load_a<128>(a[0], h4, kLd128, r0, lane);
      load_a<128>(a[1], h4, kLd128, r0 + 16, lane);
      const bool ok[2][2] = {{r0 + g < valid, r0 + g + 8 < valid},
                             {r0 + g + 16 < valid, r0 + g + 24 < valid}};
#pragma unroll
      for (int jg = 0; jg < 8; jg += 4) {
        if (jg * 8 >= warp_cols) break;
        float acc[2][4][4] = {};
        const bf16* q = w5t + (wc0 + jg * 8 + g) * kLd128 + 2 * t;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = ld32(q + j * 8 * kLd128 + kk * 16);
            const uint32_t b1 = ld32(q + j * 8 * kLd128 + kk * 16 + 8);
            mma_bf16(acc[0][j], a[0][kk], b0, b1);
            mma_bf16(acc[1][j], a[1][kk], b0, b1);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ok[i][0]) {
              mx[jg + j][0] = fmaxf(mx[jg + j][0], acc[i][j][0]);
              mx[jg + j][1] = fmaxf(mx[jg + j][1], acc[i][j][1]);
            }
            if (ok[i][1]) {
              mx[jg + j][0] = fmaxf(mx[jg + j][0], acc[i][j][2]);
              mx[jg + j][1] = fmaxf(mx[jg + j][1], acc[i][j][3]);
            }
          }
      }
    }
  }

  const float* b5 = args.b[4];
  bf16* out = args.out + (size_t)cloud * emb + c0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j * 8 >= warp_cols) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = mx[j][e];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int c = wc0 + 8 * j + 2 * t + e;
      if (g == 0 && c < cols) out[c] = __float2bfloat16_rn(fmaxf(v + b5[c0 + c], 0.f));
    }
  }
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; w1..w5 (in, out) f32 BN-folded; b1..b5 (out,) f32;
// out (B, emb) bf16. Widths 3, 64, 64, 64, 128, emb with emb % 64 == 0.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int pointnet_pooled_bf16(const float* x, const float* w1, const float* b1,
                                    const float* w2, const float* b2, const float* w3,
                                    const float* b3, const float* w4, const float* b4,
                                    const float* w5, const float* b5, void* out, int batch,
                                    int n_pts, int emb, void* stream) {
  if (batch <= 0 || n_pts <= 0 || emb <= 0 || emb % (8 * kWarps) != 0)
    return (int)cudaErrorInvalidValue;
  const int group = round_up(emb, kPad5) < kGroup ? round_up(emb, kPad5) : kGroup;
  const int bytes = smem_bytes(group);
  cudaError_t err = cudaFuncSetAttribute(
      pointnet_pooled_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Args args{x, {w1, w2, w3, w4, w5}, {b1, b2, b3, b4, b5}, static_cast<bf16*>(out), n_pts, emb};
  dim3 grid(batch, (emb + kGroup - 1) / kGroup);
  pointnet_pooled_bf16_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
