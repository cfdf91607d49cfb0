// Fused int8 eval PointNet encoder for Hopper (sm_90a), K2: the BN-folded
// 3->64->64->64->128->emb per-point chain with conv2..conv5 as int8 x int8
// -> int32 products, the requantizing epilogues, and the max over points, in
// one kernel. x (B, N, 3) f32 in, pooled (B, emb) f32 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/pointnet_fused.py::
// pointnet_pooled_int8 (body `_pn_int8_kernel`). Same math as the port's
// plain version `pn_int8_reference`, bit for bit: stage 1 on bf16-rounded
// operands with f32 sums (x0 w0, then two fmaf of exact products: the
// sequential sum), bias, ReLU, kept in f32; before each int8 stage the
// activation is requantized as round(h * inv_s) (round half to even)
// clamped to 127 (h is ReLU'd, so never negative); each stage's epilogue is
// acc * swb[0] + swb[1] as two roundings (__fmul_rn, __fadd_rn; swb[0] =
// s_w * s_x), ReLU except after conv5; relu(max over points) of conv5's
// output. swb[0] > 0, so acc -> acc * swb[0] + swb[1] is monotone: the max is
// taken over the int32 accumulators and the epilogue applied once to it,
// which rounds exactly as the max of the rounded values. Integer products
// sum exactly in any order.
//
// Bound. At B=256, N=1024, emb=1024 the int8 chain is 2 * 262,144 points *
// 147,456 MAC = 77.3 G int8 operations, about 39 us at the dense int8
// tensor-core peak (1,979 TOP/s); stage 1 adds 0.1 G f32 operations; the
// bytes (input 3 MB, output 1 MB) take about 1.2 us at 3.35 TB/s. It is bound
// by operations, 89% of them in the last 128->emb stage.
//
// Design: K1's (csrc/pointnet_fused.cu) with int8 operands.
// * Weights. PointNetInt8Weights packs the int8 weights once per model into
//   the image wgmma reads (kernels/pointnet_fused.py, `k2_image`): K-major
//   rows of 128 bytes with the 128-byte swizzle; W4^T (rows 0..127, bytes
//   0..63), W2^T (rows 0..63, bytes 64..127), W3^T (rows 64..127, bytes
//   64..127), then W5^T, one 128-byte row an output channel. Every
//   contracted index but W2's is in the accumulator layout's key order
//   (attention_sm90.cuh's s8_pack_p; position 16h + 4t + i of a 16-channel
//   group holds channel 16h + 2t + i for i < 2, 16h + 8 + 2t + i - 2 for
//   i >= 2), so a stage's requantized accumulators are the next stage's A
//   fragments in the thread that holds them (K9's hand-off). A block takes
//   its weights with two bulk copies (TMA engine, one mbarrier).
// * Grid. The emb channels are split into groups of at most 1024; an item is
//   (cloud, group), a whole cloud, so every output has one writer. A
//   persistent grid of blocks, one an SM (at most 224 KB of shared memory),
//   each bound to one group: it keeps that group's W5^T rows (at most 128
//   KB: int8 is half of K1's bf16) resident with W2..W4 (16 KB) and walks
//   its group's clouds. The group count is chosen per call (`plan`) from the
//   rounds of items per block and an item's cost (stages 1-4 recomputed per
//   group): one group of 1024 at B=256 (256 items, two rounds on 132 SMs),
//   four of 256 at B=32 (128 blocks, one round).
// * Two consumer warpgroups, each on its 256-point half of a 512-point tile,
//   in four 64-point passes through stages 1-4. Stage 1 (K=3) runs as f32
//   FMAs on the CUDA cores, straight into stage 2's A fragments. Stages 2-4
//   are int8 wgmma with A from registers (m64n64k32, m64n64k32, m64n128k32)
//   and B from shared memory; the epilogues round to integers with the 1.5 *
//   2^23 trick on the FP32 pipe. Stage 4's output goes, key-ordered, to the
//   warpgroup's swizzled h4 tile (256 points x 128 channels).
// * Stage 5 is transposed: D (64 channels x 256 points) = W5^T (A, shared
//   memory) x h4^T (B, shared memory; h4's rows are K-major as they stand),
//   m64n256k32, a wgmma group a 64-channel block (256 points a product
//   read A's 2 KB once for 8 KB of B: 0.109 ms at B=256 on an H100 SXM at
//   700 W, where 64 points a product took 0.147 and 128 took 0.116). With
//   channels as rows, the max over points is a max over a thread's own
//   int32 accumulator columns (two running maxima a channel block, DPX
//   three-way maxima).
// * The two warpgroups take turns at stage 5 (sm90::PingPong): one
//   warpgroup's stage 1 and stages 2-4 run while the other's stage-5
//   products are on the tensor cores.
// * Ragged N is masked: missing points read x = 0 and are left out of the
//   max; a warpgroup whose half lies past N only adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using sm90::desc_sw128;
using sm90::fence_operands;

typedef unsigned int u32;

constexpr int kC1 = 64;
constexpr int kThreads = 256;          // two consumer warpgroups
constexpr int kSub = 4;                // 64-point stage 1-4 passes a warpgroup tile
constexpr int kWgPts = 64 * kSub;      // points a warpgroup tile: stage 5's N (m64n256k32)
constexpr int kTilePts = 2 * kWgPts;   // points a tile of both warpgroups
constexpr int kMaxGroup = 1024;        // W5 rows resident in a block
constexpr int kW234Bytes = 16384;      // W4^T | W2^T, W3^T: 128 rows of 128 bytes
constexpr int kBlockBytes = 8192;      // 64 rows of 128 bytes: a channel block of W5^T
constexpr int kH4Bytes = kWgPts * 128; // a warpgroup's h4 tile
constexpr float kMagicF = 12582912.f;  // 1.5 * 2^23
// An item's stages 1-4 against a 1024-channel stage 5, for `plan`: the CUDA
// cores' stage 1 and epilogues against the tensor cores' stage 5
constexpr double kStages14Cost = 0.5;
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  const uint8_t* img;  // PointNetInt8Weights' image
  const float* w1;     // (3, 64) f32
  const float* b1;     // (64,)
  const float* swb[4]; // conv2..conv5 (2, out): [s_w * s_x; b]
  float inv[4];        // 1 / s_x of each int8 stage's input
  float* out;          // (B, emb)
  int n, emb, batch;
  int group, ngroups;  // W5 rows a group (a multiple of 64), groups
  int cpg;             // blocks a group
};

// The dynamic shared memory a block needs past the 1024-byte alignment: the
// weights, an h4 tile a warpgroup, stage 1's weights and bias as float4, the
// epilogues' [scales | biases], warpgroup 1's maxima for warpgroup 0, the
// mbarrier.
__host__ __device__ constexpr int smem_bytes(int group) {
  return kW234Bytes + group * 128 + 2 * kH4Bytes + 16 * kC1 + 4 * (2 * 64 + 2 * 64 + 2 * 128 + 2 * group) +
         4 * group + 8;
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// A named barrier of one warpgroup's 128 threads (ids 3 and 4; PingPong
// holds 1 and 2, __syncthreads 0).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 128;\n" ::: "memory");
}

// requant(z) = min(round(relu(z) * inv), 127), round half to even, in the
// low byte of the result's bits: relu(z) * inv is clamped to 127 first, and
// adding 1.5 * 2^23 rounds it to an integer (exact below 2^22).
__device__ __forceinline__ u32 requant_bits(float z, float inv) {
  return __float_as_uint(__fadd_rn(fminf(__fmul_rn(fmaxf(z, 0.f), inv), 127.f), kMagicF));
}

// The low bytes of four values, in order.
__device__ __forceinline__ u32 pack4(u32 a, u32 b, u32 c, u32 d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float epilogue(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// x of points p and p + 8 (a thread's two A-fragment rows), bf16-rounded;
// zeros past N.
__device__ __forceinline__ void load_x(float (&x)[2][3], const float* xc, int p, int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 3; ++e) x[h][e] = p + 8 * h < n ? bf16_round(__ldg(xc + 3 * (p + 8 * h) + e)) : 0.f;
}

// Stage 1 (3 -> 64) on the FMA units, requantized into stage 2's A
// fragments (W2 in natural order): k-step c, register r holds row g (r
// even) or g + 8 (r odd), channels 32c + 16 (r >> 1) + 4t + i in byte i.
// w1b[ch] = (w0, w1, w2, b1) of channel ch, the weights bf16-rounded.
__device__ __forceinline__ void stage1(uint32_t (&a)[2][4], const float (&x)[2][3], const float4* w1b, float inv,
                                       int t) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = w1b[32 * c + 16 * hh + 4 * t + i];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        u32 q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float z = __fmul_rn(x[row][0], w[i].x);
          z = fmaf(x[row][1], w[i].y, z);
          z = fmaf(x[row][2], w[i].z, z);
          q[i] = requant_bits(__fadd_rn(z, w[i].w), inv);
        }
        a[c][2 * hh + row] = pack4(q[0], q[1], q[2], q[3]);
      }
    }
}

// acc (64 x 64) = A (two k-steps from registers) B (the descriptor's 64
// rows, k-step c at +32 bytes), waited for.
__device__ __forceinline__ void product_n64(int (&acc)[32], const uint32_t (&a)[2][4], uint64_t desc) {
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < 2; ++c) sm90::mma_s8_rs_n64(acc, a[c], desc + 2 * c, c > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_operands(acc);
}

// An m64n64 s32 accumulator through the epilogue (swb = [scales(64) |
// biases(64)] in shared memory), ReLU and the requantization, packed as the
// next stage's A fragments in key order: of chunk c, accumulators 16c +
// {0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}.
__device__ __forceinline__ void requant_pack(uint32_t (&a)[2][4], const int (&acc)[32], const float* swb, float inv,
                                             int t) {
  u32 q[32];
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int c = 8 * jb + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(swb + c);
    const float2 b = *reinterpret_cast<const float2*>(swb + 64 + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[4 * jb + e] = requant_bits(epilogue(acc[4 * jb + e], (e & 1) ? s.y : s.x, (e & 1) ? b.y : b.x), inv);
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

__global__ void __launch_bounds__(kThreads, 1) pointnet_pooled_int8_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % a.ngroups;
  const int c_lo = grp * a.group;
  const int cols = min(a.group, a.emb - c_lo);
  const int nmb = cols >> 6;  // 64-channel blocks of this group

  uint8_t* w234 = smem;
  uint8_t* w5 = smem + kW234Bytes;
  uint8_t* h4 = w5 + a.group * 128 + wg * kH4Bytes;
  float4* w1b = reinterpret_cast<float4*>(w5 + a.group * 128 + 2 * kH4Bytes);
  float* s2 = reinterpret_cast<float*>(w1b + kC1);
  float* s3 = s2 + 2 * 64;
  float* s4 = s3 + 2 * 64;
  float* s5 = s4 + 2 * 128;  // [scales of the group's channels | their biases]
  int* xch = reinterpret_cast<int*>(s5 + 2 * a.group);  // warpgroup 1's maxima
  uint64_t* bar = reinterpret_cast<uint64_t*>(xch + a.group);

  if (tid == 0) {
    sm90::bar_init(bar, 1);
    sm90::bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::bar_expect_tx(bar, kW234Bytes + cols * 128);
    sm90::bulk_load(w234, a.img, kW234Bytes, bar);
    sm90::bulk_load(w5, a.img + kW234Bytes + (size_t)c_lo * 128, cols * 128, bar);
  }
  for (int i = tid; i < kC1; i += kThreads)
    w1b[i] = make_float4(bf16_round(a.w1[i]), bf16_round(a.w1[kC1 + i]), bf16_round(a.w1[2 * kC1 + i]), a.b1[i]);
  for (int i = tid; i < 2 * 64; i += kThreads) {
    s2[i] = a.swb[0][i];
    s3[i] = a.swb[1][i];
  }
  for (int i = tid; i < 2 * 128; i += kThreads) s4[i] = a.swb[2][i];
  for (int i = tid; i < cols; i += kThreads) {
    s5[i] = a.swb[3][c_lo + i];
    s5[a.group + i] = a.swb[3][a.emb + c_lo + i];
  }
  __syncthreads();
  sm90::bar_wait(bar, 0);

  // W2^T: rows 0..63 at byte 64; W3^T: rows 64..127 at byte 64; W4^T: rows
  // 0..127 at byte 0 (a descriptor's start address in 16-byte units)
  const uint64_t d_w4 = desc_sw128(w234, 16);
  const uint64_t d_w2 = d_w4 + (64 >> 4), d_w3 = d_w4 + ((kBlockBytes + 64) >> 4);
  const float inv1 = a.inv[0], inv2 = a.inv[1], inv3 = a.inv[2], inv4 = a.inv[3];
  const sm90::PingPong turns(wg);
  turns.open();
  const int ntiles = (a.n + kTilePts - 1) / kTilePts;
  const int row = 16 * warp + g;  // the thread's first A-fragment row of a 64-point pass
  for (int cloud = blockIdx.x / a.ngroups; cloud < a.batch; cloud += a.cpg) {
    const float* xc = a.x + (size_t)cloud * a.n * 3;
    int mx[16][2];
#pragma unroll
    for (int mb = 0; mb < 16; ++mb) mx[mb][0] = mx[mb][1] = INT_MIN;
    float x[2][3];
    load_x(x, xc, wg * kWgPts + row, a.n);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int pbase = tile * kTilePts + wg * kWgPts;
#pragma unroll 1
      for (int u = 0; u < kSub; ++u) {  // stages 1-4 of points pbase + 64u .., into h4 rows 64u ..
        uint32_t af[2][4];
        stage1(af, x, w1b, inv1, t);
        if (u + 1 < kSub)
          load_x(x, xc, pbase + 64 * (u + 1) + row, a.n);
        else if (tile + 1 < ntiles)
          load_x(x, xc, pbase + kTilePts + row, a.n);
        {
          int d[32];
          product_n64(d, af, d_w2);
          requant_pack(af, d, s2, inv2, t);
          product_n64(d, af, d_w3);
          requant_pack(af, d, s3, inv3, t);
        }
        int d[64];  // stage 4 (64 -> 128) into the warpgroup's h4 tile, key-ordered
        sm90::wgmma_fence();
#pragma unroll
        for (int c = 0; c < 2; ++c) sm90::mma_s8_rs_n128(d, af[c], d_w4 + 2 * c, c > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        fence_operands(d);
#pragma unroll
        for (int h = 0; h < 8; ++h) {  // 16-channel group h: columns 16h + 2t (+1), 16h + 8 + 2t (+1)
          const int c0 = 16 * h + 2 * t;
          const float2 sa = *reinterpret_cast<const float2*>(s4 + c0);
          const float2 sb = *reinterpret_cast<const float2*>(s4 + c0 + 8);
          const float2 ba = *reinterpret_cast<const float2*>(s4 + 128 + c0);
          const float2 bb = *reinterpret_cast<const float2*>(s4 + 128 + c0 + 8);
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // rows g, g + 8: accumulators 8h + 2r + {0, 1}, 8h + 4 + 2r + {0, 1}
            const int k = 8 * h + 2 * r;
            const u32 w = pack4(requant_bits(epilogue(d[k], sa.x, ba.x), inv4),
                                requant_bits(epilogue(d[k + 1], sa.y, ba.y), inv4),
                                requant_bits(epilogue(d[k + 4], sb.x, bb.x), inv4),
                                requant_bits(epilogue(d[k + 5], sb.y, bb.y), inv4));
            const int pr = 64 * u + row + 8 * r;
            *reinterpret_cast<u32*>(h4 + pr * 128 + ((h ^ (pr & 7)) << 4) + 4 * t) = w;
          }
        }
      }
      sm90::fence_proxy_async();
      wg_sync(wg);

      // stage 5: D (64 channels x kWgPts points) = W5^T h4^T, a wgmma group
      // a channel block, folded into the running maxima
      const bool full = pbase + kWgPts <= a.n;
      const uint64_t d_h4 = desc_sw128(h4, 16);
      turns.turn();
#pragma unroll
      for (int mb = 0; mb < 16; ++mb) {
        if (mb >= nmb) break;
        int acc[128];
        fence_operands(acc);
        sm90::wgmma_fence();
        const uint64_t d_w5 = desc_sw128(w5 + mb * kBlockBytes, 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sm90::mma_s8_ss_n256(acc, d_w5 + 2 * kk, d_h4 + 2 * kk, kk > 0);
        sm90::wgmma_commit();
        if (mb + 1 == nmb) turns.pass();  // the last group of this tile is issued
        sm90::wgmma_wait<0>();
        fence_operands(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // channel rows g, g + 8: accumulators 4j + 2h + e, point 8j + 2t + e
          int m = mx[mb][h];
          if (full) {
#pragma unroll
            for (int j = 0; j < 32; ++j) m = __vimax3_s32(m, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const int p = pbase + 8 * j + 2 * t;
              m = __vimax3_s32(m, p < a.n ? acc[4 * j + 2 * h] : INT_MIN,
                               p + 1 < a.n ? acc[4 * j + 2 * h + 1] : INT_MIN);
            }
          }
          mx[mb][h] = m;
        }
      }
    }

    // the cloud's maxima: over the quad's columns (lane t of a quad then
    // takes every fourth channel row); warpgroup 1 hands its half's to
    // warpgroup 0, which applies the epilogue to the larger and stores it
    int best[16][2];
#pragma unroll
    for (int mb = 0; mb < 16; ++mb) {
      if (mb >= nmb) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = mx[mb][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        best[mb][h] = v;
        if (wg == 1 && ((2 * mb + h) & 3) == t) xch[64 * mb + row + 8 * h] = v;
      }
    }
    __syncthreads();
    if (wg == 0) {
      float* out = a.out + (size_t)cloud * a.emb + c_lo;
#pragma unroll
      for (int mb = 0; mb < 16; ++mb) {
        if (mb >= nmb) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (((2 * mb + h) & 3) != t) continue;
          const int c = 64 * mb + row + 8 * h;
          out[c] = fmaxf(epilogue(max(best[mb][h], xch[c]), s5[c], s5[a.group + c]), 0.f);
        }
      }
    }
    __syncthreads();  // the exchange is read before the next cloud's
  }
  turns.close();
}

// The work split of a call (see Design: Grid): the group count that
// minimizes (rounds of clouds a block) x (an item's cost), an item costing
// its stages 1-4 (kStages14Cost of a 1024-channel stage 5) plus its stage 5
// (in proportion to the group's channels). Stated in Python as
// kernels/pointnet_fused.py's `k2_plan`.
struct Plan {
  int group, ngroups, cpg, smem;
};

inline Plan plan(int batch, int emb, int sms) {
  Plan best{0, 0, 0, 0};
  double best_cost = 0.0;
  for (int ng = (emb + kMaxGroup - 1) / kMaxGroup; ng <= emb / 64; ++ng) {
    const int group = ((emb + ng - 1) / ng + 63) / 64 * 64;
    const int groups = (emb + group - 1) / group;
    const int cpg = sms / groups < 1 ? 1 : sms / groups < batch ? sms / groups : batch;
    const double cost = (double)((batch + cpg - 1) / cpg) * (kStages14Cost + group / 1024.0);
    if (best.group == 0 || cost < best_cost - 1e-9) {
      best = Plan{group, groups, cpg, 1024 + smem_bytes(group)};
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// C entry: the group size `plan` picks for (batch, emb) on `sms` SMs, or 0
// for arguments the kernel refuses.
extern "C" int pointnet_int8_group(int batch, int emb, int sms) {
  if (batch <= 0 || emb <= 0 || emb % 64 != 0 || sms <= 0) return 0;
  return plan(batch, emb, sms).group;
}

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; w1 (3, 64) f32, b1 (64,) f32; img the 16384 +
// 128 emb bytes of PointNetInt8Weights' image (16-byte aligned); swb2..swb5
// (2, out) f32; inv2..inv5 the reciprocals of the stages' input scales; out
// (B, emb) f32. emb % 64 == 0. Returns the CUDA error code of the launch (0
// on success).
extern "C" int pointnet_pooled_int8(const float* x, const float* w1, const float* b1, const void* img,
                                    const float* swb2, const float* swb3, const float* swb4, const float* swb5,
                                    float inv2, float inv3, float inv4, float inv5, float* out, int batch, int n_pts,
                                    int emb, void* stream) {
  if (batch <= 0 || n_pts <= 0 || emb <= 0 || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  // the SM count and the shared-memory limit (the largest group's), once a
  // device
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pointnet_pooled_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 1024 + smem_bytes(kMaxGroup));
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const Plan p = plan(batch, emb, sms_of[dev]);
  Args args{x,   static_cast<const uint8_t*>(img), w1, b1, {swb2, swb3, swb4, swb5}, {inv2, inv3, inv4, inv5},
            out, n_pts, emb, batch, p.group, p.ngroups, p.cpg};
  pointnet_pooled_int8_kernel<<<p.cpg * p.ngroups, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
