// Fused eval-mode PointNet encoder for Hopper (sm_90a): the BN-folded
// 3->64->64->64->128->emb per-point chain, ReLU, and the max over points,
// in one kernel. x (B, N, 3) f32 in, pooled (B, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/pointnet_fused.py::
// pointnet_pooled_kernel (body `_pn_kernel`). Same math as the port's plain
// version `oracle_chain`: operands rounded to bf16, f32 accumulation, f32
// bias, ReLU, h_{i+1} rounded to bf16; the last stage's pre-activation is
// max-reduced over the points and relu(max + b) is written (rounding and
// relu are monotonic, so they commute with the max), so no (N, emb) tensor
// ever leaves the SM.
//
// Bound. At B=256, N=1024, emb=1024 the chain is 2 * 262,144 points *
// 147,648 MAC = 77.4 GFLOP, about 78 us at the dense bf16 tensor-core peak
// (989 TFLOP/s); its bytes (input 3 MB, weights 0.6 MB, output 0.5 MB) take
// about 1.2 us at 3.35 TB/s. So it is bound by operations, and 89% of them
// are in the last 128->emb stage.
//
// Design.
// * Weights. One small launch before the chain (`pack_kernel`, from the same
//   C entry) writes W2^T, W3^T, W4^T and W5^T once per call as bf16 in the
//   exact shared-memory image that wgmma reads (K-major rows of 128 bytes
//   with the 128-byte swizzle, see attention_sm90.cuh). Once per call and
//   not once per model: the autograd entry folds
//   BatchNorm into new tensors on every call, and a per-call pack can never
//   go stale after an in-place update of the weights; it moves 0.9 MB, a few
//   microseconds. A block then takes its weights with two bulk copies (TMA
//   engine, one mbarrier) and converts nothing.
// * Grid. The emb channels are split into groups of at most 512; an item is
//   (cloud, group), a whole cloud, so every output has one writer and no
//   atomics are needed. A persistent grid of blocks, one an SM (at most 202
//   KB of shared memory), each bound to one group: it keeps that group's
//   W5^T slice (at most 128 KB) resident with W2..W4 (32 KB) and walks its
//   group's clouds. The group count is chosen per call (`plan`) from the
//   rounds of items per block and the work an item costs (stages 1-4 are
//   recomputed per group): two groups of 512 at B=256 (512 items, four
//   rounds on 132 SMs), four of 256 at B=32 (128 blocks, one round), so that
//   a small batch fills the card too.
// * Two consumer warpgroups, each on its 64-point half of a 128-point tile.
//   Stage 1 (K=3) runs as f32 FMAs on bf16-rounded operands, straight into
//   stage 2's A fragments in registers. Stages 2-4 are wgmma with A from
//   registers (each stage's accumulators, biased, ReLU'd and rounded, are
//   the next stage's A fragments) and B (W^T) from shared memory. Stage 4's
//   output goes to the warpgroup's own swizzled h4 tile in shared memory.
// * Stage 5 is transposed: D (64 channels x 64 points) = W5^T (A, shared
//   memory) x h4^T (B, shared memory), m64n64k16, four 64-channel blocks a
//   wgmma group. With channels as rows, the max over points is a max over a
//   thread's own accumulator columns; a thread keeps 2 running maxima a
//   channel block (16 registers for 512 channels) where the untransposed
//   product would need 128. The bias is added after the max.
// * The two warpgroups take turns at stage 5 (FA3's ping-pong,
//   sm90::PingPong): one warpgroup's stage 1 on the CUDA cores and its
//   stages 2-4 run while the other's stage-5 products are on the tensor
//   cores.
// * Ragged N is masked: missing points read x = 0 and are left out of the
//   max; a warpgroup whose half lies past N only adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using sm90::desc_sw128;
using sm90::fence_operands;
using sm90::pack_bf16;

typedef __nv_bfloat16 bf16;

constexpr int kC1 = 64;
constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kTilePts = 128;       // points a tile, 64 a warpgroup
constexpr int kS5Batch = 4;         // 64-channel blocks a stage-5 wgmma group
constexpr int kMaxGroup = 512;      // W5 columns resident in a block
constexpr int kBox = 8192;          // 64 rows of 128 bytes
constexpr int kW234Bytes = 32768;   // W2^T, W3^T (64 x 64), W4^T (128 x 64)
constexpr int kMBlockBytes = 16384; // 64 W5 columns x 128 k: two boxes
constexpr int kH4Bytes = 16384;     // 64 points x 128 channels: two boxes
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  const uint8_t* img;  // the packed weights (pack_kernel)
  const float* w1;
  const float* b[5];
  bf16* out;
  int n, emb, batch;
  int group, ngroups;  // W5 columns a group (a multiple of 64), groups
  int cpg;             // blocks a group
};

// The dynamic shared memory a block needs, past the 1024-byte alignment:
// weights, an h4 tile a warpgroup, w1 and the biases, warpgroup 1's maxima
// for warpgroup 0, the mbarrier.
__host__ __device__ constexpr int smem_bytes(int group) {
  return kW234Bytes + group / 64 * kMBlockBytes + 2 * kH4Bytes + 4 * (3 * kC1 + 3 * 64 + 128 + group) + 2 * group +
         8;
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

// W^T rows (out channels) of 64 k (bf16, 128 bytes), 16-byte chunk c of row
// r at chunk c ^ (r % 8): the image W2^T, W3^T, W4^T, then W5^T in blocks of
// 64 channels, each two boxes (k 0..63, 64..127). One thread a 16-byte
// chunk.
__global__ void pack_kernel(const float* __restrict__ w2, const float* __restrict__ w3,
                            const float* __restrict__ w4, const float* __restrict__ w5, int emb,
                            uint8_t* __restrict__ img) {
  const int chunks = (kW234Bytes + emb * 256) / 16;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < chunks; i += gridDim.x * blockDim.x) {
    const int off = 16 * i;
    const float* w;
    int o_dim, n, k0;
    if (off < kW234Bytes) {
      const int which = min(off / kBox, 2);  // W2^T, W3^T, W4^T (two boxes)
      const int rel = off - which * kBox;
      w = which == 0 ? w2 : which == 1 ? w3 : w4;
      o_dim = which == 2 ? 128 : 64;
      n = rel >> 7;
      k0 = 8 * (((rel >> 4) & 7) ^ (n & 7));
    } else {
      const int rel = off - kW234Bytes;
      const int mb = rel / kMBlockBytes, box = (rel / kBox) & 1, rr = (rel >> 7) & 63;
      w = w5;
      o_dim = emb;
      n = 64 * mb + rr;
      k0 = 64 * box + 8 * (((rel >> 4) & 7) ^ (rr & 7));
    }
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = pack_bf16(w[(size_t)(k0 + 2 * e) * o_dim + n], w[(size_t)(k0 + 2 * e + 1) * o_dim + n]);
    *reinterpret_cast<uint4*>(img + off) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// x of points p and p + 8 (a thread's two A-fragment rows), bf16-rounded;
// zeros past N.
__device__ __forceinline__ void load_x(float (&x)[2][3], const float* xc, int p, int n) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 3; ++e) x[h][e] = p + 8 * h < n ? bf16_round(__ldg(xc + 3 * (p + 8 * h) + e)) : 0.f;
}

// Stage 1 (3 -> 64) on the FMA units, written as stage 2's A fragments:
// k-step kk holds rows g, g + 8 and columns 16 kk + 2t (+1), 16 kk + 8 + 2t
// (+1).
__device__ __forceinline__ void stage1(uint32_t (&a)[4][4], const float (&x)[2][3], const float* w1,
                                       const float* b1, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = q & 1, col = 16 * kk + 8 * (q >> 1) + 2 * t;
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + e;
        float z = x[row][0] * w1[c];
        z = fmaf(x[row][1], w1[kC1 + c], z);
        z = fmaf(x[row][2], w1[2 * kC1 + c], z);
        h[e] = fmaxf(z + b1[c], 0.f);
      }
      a[kk][q] = pack_bf16(h[0], h[1]);
    }
}

// d (64 x 64) = A (registers, K = 64) W^T (shared memory), one wgmma group.
__device__ __forceinline__ void stage_n64(float (&d)[32], const uint32_t (&a)[4][4], uint64_t db) {
  fence_operands(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::mma_bf16_rs_n64(d, a[kk], db + 2 * kk, kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_operands(d);
}

// bias, ReLU, bf16: the accumulators of a 64-column stage as the next
// stage's A fragments (k-step kk takes accumulators 8 kk .. 8 kk + 7).
__device__ __forceinline__ void relu_to_frags(uint32_t (&a)[4][4], const float (&d)[32], const float* bias, int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int col = 8 * (i >> 2) + 2 * t;
    a[i >> 3][(i >> 1) & 3] = pack_bf16(fmaxf(d[i] + bias[col], 0.f), fmaxf(d[i + 1] + bias[col + 1], 0.f));
  }
}

__global__ void __launch_bounds__(kThreads, 1) pointnet_pooled_bf16_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % a.ngroups;
  const int c_lo = grp * a.group;
  const int nmb = min(a.group, a.emb - c_lo) >> 6;  // 64-channel blocks of this group

  uint8_t* w234 = smem;
  uint8_t* w5 = smem + kW234Bytes;
  uint8_t* h4 = w5 + (a.group >> 6) * kMBlockBytes + wg * kH4Bytes;
  float* w1s = reinterpret_cast<float*>(w5 + (a.group >> 6) * kMBlockBytes + 2 * kH4Bytes);
  float* b1s = w1s + 3 * kC1;
  float* b2s = b1s + 64;
  float* b3s = b2s + 64;
  float* b4s = b3s + 64;
  float* b5s = b4s + 128;
  unsigned short* xch = reinterpret_cast<unsigned short*>(b5s + a.group);  // warpgroup 1's maxima, as bf16 bits
  uint64_t* bar = reinterpret_cast<uint64_t*>(xch + a.group);

  if (tid == 0) {
    sm90::bar_init(bar, 1);
    sm90::bar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::bar_expect_tx(bar, kW234Bytes + nmb * kMBlockBytes);
    sm90::bulk_load(w234, a.img, kW234Bytes, bar);
    sm90::bulk_load(w5, a.img + kW234Bytes + (size_t)c_lo * 256, nmb * kMBlockBytes, bar);
  }
  for (int i = tid; i < 3 * kC1; i += kThreads) w1s[i] = bf16_round(a.w1[i]);
  for (int i = tid; i < 64; i += kThreads) {
    b1s[i] = a.b[0][i];
    b2s[i] = a.b[1][i];
    b3s[i] = a.b[2][i];
  }
  for (int i = tid; i < 128; i += kThreads) b4s[i] = a.b[3][i];
  for (int i = tid; i < 64 * nmb; i += kThreads) b5s[i] = a.b[4][c_lo + i];
  __syncthreads();
  sm90::bar_wait(bar, 0);

  const uint64_t d_w2 = desc_sw128(w234, 16), d_w3 = desc_sw128(w234 + kBox, 16);
  const uint64_t d_w4 = desc_sw128(w234 + 2 * kBox, 16);
  const sm90::PingPong turns(wg);
  turns.open();
  const int ntiles = (a.n + kTilePts - 1) / kTilePts;
  const int row = 16 * warp + g;  // the thread's first A-fragment row of its warpgroup's 64
  for (int cloud = blockIdx.x / a.ngroups; cloud < a.batch; cloud += a.cpg) {
    const float* xc = a.x + (size_t)cloud * a.n * 3;
    float mx[8][2];
#pragma unroll
    for (int mb = 0; mb < 8; ++mb) mx[mb][0] = mx[mb][1] = -INFINITY;
    float x[2][3];
    load_x(x, xc, wg * 64 + row, a.n);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int pbase = tile * kTilePts + wg * 64;
      uint32_t af[4][4];
      stage1(af, x, w1s, b1s, t);
      if (tile + 1 < ntiles) load_x(x, xc, pbase + kTilePts + row, a.n);
      {
        float d[32];
        stage_n64(d, af, d_w2);
        relu_to_frags(af, d, b2s, t);
        stage_n64(d, af, d_w3);
        relu_to_frags(af, d, b3s, t);
      }
      {  // stage 4 (64 -> 128) into the warpgroup's h4 tile
        float d[64];
        fence_operands(d);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sm90::mma_bf16_rs_n128(d, af[kk], d_w4 + 2 * kk, kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        fence_operands(d);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h;
            const uint32_t v = pack_bf16(fmaxf(d[4 * j + 2 * h] + b4s[col], 0.f),
                                         fmaxf(d[4 * j + 2 * h + 1] + b4s[col + 1], 0.f));
            *reinterpret_cast<uint32_t*>(h4 + (j >> 3) * kBox + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t) = v;
          }
        }
      }
      sm90::fence_proxy_async();
      wg_sync(wg);

      // stage 5: D (channels x points) = W5^T h4^T, kS5Batch channel blocks
      // a wgmma group, folded into the running maxima
      const bool full = pbase + 64 <= a.n;
      turns.turn();
#pragma unroll
      for (int b0 = 0; b0 < 8; b0 += kS5Batch) {
        if (b0 >= nmb) break;
        float acc[kS5Batch][32];
#pragma unroll
        for (int i = 0; i < kS5Batch; ++i) fence_operands(acc[i]);
        sm90::wgmma_fence();
#pragma unroll
        for (int i = 0; i < kS5Batch; ++i) {
          if (b0 + i >= nmb) break;
          const uint8_t* wa = w5 + (b0 + i) * kMBlockBytes;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            sm90::mma_bf16_ss_n64(acc[i], desc_sw128(wa + (kk >> 2) * kBox, 16) + 2 * (kk & 3),
                                  desc_sw128(h4 + (kk >> 2) * kBox, 16) + 2 * (kk & 3), kk > 0);
        }
        sm90::wgmma_commit();
        if (b0 + kS5Batch >= nmb) turns.pass();  // the last group of this tile is issued
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kS5Batch; ++i) {
          if (b0 + i >= nmb) break;
          fence_operands(acc[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = full || pbase + 8 * j + 2 * t + e < a.n;
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mx[b0 + i][h] = fmaxf(mx[b0 + i][h], ok ? acc[i][4 * j + 2 * h + e] : -INFINITY);
            }
        }
      }
    }

    // the cloud's maxima: over the quad's columns (lane t of a quad then
    // takes every fourth channel), as bf16(relu(m + b)) bits, which order
    // as the values do; warpgroup 1 hands its half's to warpgroup 0, which
    // stores the larger
    unsigned short bits[8][2];
#pragma unroll
    for (int mb = 0; mb < 8; ++mb) {
      if (mb >= nmb) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[mb][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float o = v + b5s[64 * mb + row + 8 * h];
        bits[mb][h] = __bfloat16_as_ushort(__float2bfloat16_rn(o > 0.f ? o : 0.f));
        if (wg == 1 && ((2 * mb + h) & 3) == t) xch[64 * mb + row + 8 * h] = bits[mb][h];
      }
    }
    __syncthreads();
    if (wg == 0) {
      bf16* out = a.out + (size_t)cloud * a.emb + c_lo + row;
#pragma unroll
      for (int mb = 0; mb < 8; ++mb) {
        if (mb >= nmb) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (((2 * mb + h) & 3) != t) continue;
          const int c = 64 * mb + 8 * h;
          out[c] = __ushort_as_bfloat16(max(bits[mb][h], xch[c + row]));
        }
      }
    }
    __syncthreads();  // the exchange is read before the next cloud's
  }
  turns.close();
}

// The work split of a call (see Design: Grid): the group count that
// minimizes (rounds of clouds a block) x (an item's cost), an item costing
// its stages 1-4 (2/3 of a 512-channel stage 5, as measured on the H100)
// plus its stage 5 (in proportion to the group's channels).
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
    const double cost = (double)((batch + cpg - 1) / cpg) * (2.0 / 3.0 + group / 512.0);
    if (best.group == 0 || cost < best_cost - 1e-9) {
      best = Plan{group, groups, cpg, 1024 + smem_bytes(group)};
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// C entry, bound with ctypes: the weight pack alone. w2..w5 (in, out) f32;
// img receives 32768 + 256 emb bytes (16-byte aligned). Returns the launch's
// CUDA error code.
extern "C" int pointnet_pack_bf16(const float* w2, const float* w3, const float* w4, const float* w5, int emb,
                                  void* img, void* stream) {
  if (emb <= 0 || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  const int chunks = (kW234Bytes + emb * 256) / 16;
  pack_kernel<<<(chunks + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(w2, w3, w4, w5, emb,
                                                                                 static_cast<uint8_t*>(img));
  return (int)cudaGetLastError();
}

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; w1..w5 (in, out) f32 BN-folded; b1..b5 (out,) f32;
// out (B, emb) bf16; img a scratch of 32768 + 256 emb bytes for the packed
// weights. Widths 3, 64, 64, 64, 128, emb with emb % 64 == 0. Two launches:
// the pack, then the chain. Returns the CUDA error code (0 on success).
extern "C" int pointnet_pooled_bf16(const float* x, const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* w3, const float* b3, const float* w4,
                                    const float* b4, const float* w5, const float* b5, void* out, void* img,
                                    int batch, int n_pts, int emb, void* stream) {
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
      err = cudaFuncSetAttribute(pointnet_pooled_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 1024 + smem_bytes(kMaxGroup));
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const Plan p = plan(batch, emb, sms_of[dev]);
  const int e = pointnet_pack_bf16(w2, w3, w4, w5, emb, img, stream);
  if (e != 0) return e;
  Args args{x, static_cast<const uint8_t*>(img), w1, {b1, b2, b3, b4, b5}, static_cast<bf16*>(out),
            n_pts, emb, batch, p.group, p.ngroups, p.cpg};
  pointnet_pooled_bf16_kernel<<<p.cpg * p.ngroups, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
