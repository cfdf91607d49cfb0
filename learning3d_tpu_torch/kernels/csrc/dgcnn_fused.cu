// Fused eval-mode DGCNN encoder for Hopper (sm_90a), K5: exact kNN, the edge
// gather, the BN-folded conv stages 6->64->64->128->256 with a max over the
// k neighbors after each, and conv5 512->emb. x (B, N, 3) f32 and the
// per-point stage-1 product xw1 (B, N, 64) bf16 in, (B, N, emb) bf16 out.
//
// Replaces the TPU kernel learning3d_tpu/kernels/dgcnn_fused.py::
// dgcnn_encode_fused (body `_fused_kernel`). Same math as the port's plain
// version `dgcnn_encode_reference`: the neighbor selection shared with K9
// (dgcnn_select.cu: exact f32 squared differences, nearest first, ties to
// the smaller index); bf16 operands, f32 sums, f32 bias, ReLU, each stage's
// output rounded to bf16; conv5 on the bf16 concatenation of the four
// k-maxes (the max of bf16-rounded values is the rounding of the max, and
// ReLU makes 0 a valid start).
//
// Bound. At B=32, N=1024, k=20, emb=512 the conv chain is
// 2 * 32,768 points * [20 * (64*64 + 64*128 + 128*256) + 512*512] MAC
// = 76 GFLOP, about 77 us at the dense bf16 tensor-core peak (989 TFLOP/s);
// the output (33.5 MB bf16) takes 10 us at 3.35 TB/s. So it is bound by
// operations. Distances and selection add about 0.3 G f32 operations on the
// CUDA cores.
//
// Design: two launches from one C entry, as K9's. The selection
// (dgcnn_select, shared with K9) writes the neighbors to a (B, N, k) int32
// scratch; the chain (dgcnn_encode_bf16_kernel) reads them.
// * The chain: grid (ceil(N / 128), B), a block of two consumer warpgroups
//   (256 threads), each on 64 query rows, one block an SM. The two share
//   the weights: W2^T, W3^T and W4^T (88 KB) arrive by one bulk copy (TMA)
//   in wgmma's 128-byte-swizzled K-major image, packed once a model
//   (DGCNNBf16Weights). z4's running max (256 channels) lives in shared
//   memory, 32 KB a warpgroup; the other maxes in registers. (One warpgroup
//   a block with both in shared memory would need 240 KB for two blocks an
//   SM; z4's max in registers does not fit beside the chain's.)
// * One neighbor at a time, on bf16 wgmma with A from registers, no barrier
//   at all: each thread forms its own A fragments of e1 (rows g and g + 8 of
//   its warp's 16) from two gathered 16-byte loads a row (xw1's columns are
//   stored in fragment order, `xw1_order`, so that a quad's thread t reads
//   bytes 32t..32t+31), the next neighbor's in flight. Stage 2 is
//   m64n64k16 x 4, stage 3 m64n128k16 x 4, stage 4 four m64n64 quarters over
//   K=128 (accumulators at 32 registers). For 16-bit operands the f32
//   accumulator of one product, rounded to bf16 pairs, is the next
//   product's A fragment (k-step kk takes accumulators 8 kk .. 8 kk + 7), as
//   in FlashAttention-3's P.V: no value crosses a lane, and the weights stay
//   in their natural order. Each epilogue is bias, then ReLU and the
//   rounding in one cvt.rn.relu.bf16x2.f32 for two values, then __hmax2
//   into the running max.
// * conv5: the maxes are the A fragments of the (64, 512) concatenation
//   (32 k-steps, 128 registers); W5 (512 x emb bf16) streams in slabs of 64
//   output channels (64 KB) through a 2-stage ring of bulk copies and
//   mbarriers in the freed weight and z4 regions, the next slab in flight;
//   m64n64k16 x 32 a slab; bias, ReLU, bf16, stored.
// * Rows past N get neighbor 0 and the origin as center: computed, not
//   written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attention_sm90.cuh"
#include "dgcnn_select.cuh"

namespace {

using sm90::desc_sw128;
using sm90::fence_operands;

typedef __nv_bfloat16 bf16;
typedef unsigned int u32;

constexpr int kWgRows = 64;  // query rows a consumer warpgroup
constexpr int kRows = 128;   // a block: two warpgroups
constexpr int kThreads = 256;
constexpr int kC1 = 64;
constexpr int kCat = 512;
constexpr int kMaxK = 32;
constexpr int kMaxN = 4096;
constexpr int kBox = 8192;                                // 64 rows of 128 bytes
constexpr int kW2Bytes = 8192;                            // W2^T: 64 rows x 64 k
constexpr int kW3Bytes = 16384;                           // W3^T: 128 rows x 64 k
constexpr int kW4Box = 32768;                             // W4^T: 256 rows x 64 k, two boxes (k 0..63, 64..127)
constexpr int kWBytes = kW2Bytes + kW3Bytes + 2 * kW4Box;  // the image of DGCNNBf16Weights.img
constexpr int kM4Chunks = 16;                             // z4's max: 16 A-fragment k-steps a thread
constexpr int kM4Bytes = kThreads * kM4Chunks * 16;
constexpr int kSlabCols = 64;                     // conv5 output channels a W5 slab
constexpr int kSlabBytes = kSlabCols * kCat * 2;  // eight boxes of 64 rows x 64 k
constexpr int kStages = 2;                        // the W5 ring, in the weight and z4 regions
static_assert(kStages * kSlabBytes <= kWBytes + kM4Bytes, "the W5 ring must fit the freed regions");

struct Args {
  const float* x;      // (B, N, 3)
  const bf16* xw1;     // (B, N, 64), columns in xw1_order
  const float* wc1;    // (3, 64) f32, rounded to bf16 here
  const float* b1;     // (64,)
  const uint8_t* w;    // W2^T | W3^T | W4^T images (kWBytes)
  const uint8_t* w5;   // W5^T in slabs of 64 output channels (emb * 1024 bytes)
  const float* b[4];   // conv2..conv5 biases, f32
  bf16* out;           // (B, N, emb)
  const int* idx;      // (B, N, k): dgcnn_select's neighbors
  int n, k, emb;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// The chain's dynamic shared memory past the 1024-byte alignment: the
// weights (then the W5 ring), z4's maxes, the index table and the
// mbarriers (the weights', the ring's).
__host__ __device__ constexpr int smem_bytes(int k) {
  return kWBytes + kM4Bytes + align16(4 * kRows * k) + 8 * (1 + kStages);
}

// relu(lo), relu(hi) rounded to a bf16 pair, lo in the low half (the lower
// column of a fragment): one cvt.
__device__ __forceinline__ u32 relu_bf16x2(float lo, float hi) {
  u32 r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ u32 hmax2(u32 a, u32 b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 r = __hmax2(x, y);
  u32 u;
  memcpy(&u, &r, 4);
  return u;
}

template <int KS>
__device__ __forceinline__ void max_into(u32 (*m)[4], const u32 (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) m[kk][r] = hmax2(m[kk][r], a[kk][r]);
}

// d (64 x 64) = A (KS k-steps from registers) . B (K-major image: k-step kk
// at +32 bytes in box kk / 4, boxes `box` bytes apart), waited for.
template <int KS>
__device__ __forceinline__ void product_n64(float (&d)[32], const u32 (*a)[4], uint64_t desc, int box) {
  fence_operands(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sm90::mma_bf16_rs_n64(d, a[kk], desc + (kk >> 2) * (box >> 4) + 2 * (kk & 3), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_operands(d);
}

// bias, ReLU and bf16 of the accumulators of 8 KS columns from `bias` on:
// the A fragments of KS k-steps (k-step kk takes accumulators 8 kk .. 8 kk
// + 7: register r holds row g + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2t
// and + 1).
template <int KS>
__device__ __forceinline__ void to_frags(u32 (*a)[4], const float (&d)[8 * KS], const float* __restrict__ bias,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 16 * kk + 8 * (r >> 1) + 2 * t));
      const int i = 8 * kk + 2 * r;
      a[kk][r] = relu_bf16x2(__fadd_rn(d[i], b.x), __fadd_rn(d[i + 1], b.y));
    }
}

__global__ void __launch_bounds__(kThreads, 1) dgcnn_encode_bf16_kernel(Args args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int n_pts = args.n, k = args.k, emb = args.emb;
  const int cloud = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  uint8_t* wts = smem;                                         // W2 | W3 | W4; then conv5's ring
  uint4* m4s = reinterpret_cast<uint4*>(smem + kWBytes);       // z4's max: k-step c of thread tid at c * kThreads + tid
  int* idx = reinterpret_cast<int*>(smem + kWBytes + kM4Bytes);  // the block's rows' neighbors
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(idx) + align16(4 * kRows * k));
  const float* xc = args.x + (size_t)cloud * n_pts * 3;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) sm90::bar_init(bars + i, 1);
    sm90::bar_fence_init();
  }
  for (int i = tid; i < kRows * k; i += kThreads) {
    const int q = q0 + i / k;
    idx[i] = q < n_pts ? args.idx[((size_t)cloud * n_pts + q0) * k + i] : 0;
  }
#pragma unroll
  for (int c = 0; c < kM4Chunks; ++c) m4s[c * kThreads + tid] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid == 0) {
    sm90::bar_expect_tx(bars, kWBytes);
    sm90::bulk_load(wts, args.w, kWBytes, bars);
  }

  // the center half of stage 1 for this thread's A-fragment elements: row
  // 64 wg + 16 warp + g + 8h, word w (channels 16 (w >> 1) + 8 (w & 1) + 2t
  // and + 1): c1 = bf16(center) . bf16(Wc1) + b1 in f32, at c1v[h][2w + e]
  const int row = kWgRows * wg + 16 * warp + g;
  float c1v[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cen[3] = {0.f, 0.f, 0.f};
    if (q0 + row + 8 * h < n_pts)
      for (int d = 0; d < 3; ++d)
        cen[d] = __bfloat162float(__float2bfloat16_rn(xc[(size_t)(q0 + row + 8 * h) * 3 + d]));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ch = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * t + (j & 1);
      float w[3];
      for (int d = 0; d < 3; ++d) w[d] = __bfloat162float(__float2bfloat16_rn(args.wc1[d * kC1 + ch]));
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(cen[0], w[0]), __fmul_rn(cen[1], w[1])),
                                __fmul_rn(cen[2], w[2]));
      c1v[h][j] = __fadd_rn(z, args.b1[ch]);
    }
  }

  // ---- the chain, one neighbor at a time ----
  u32 m1[4][4], m2[4][4], m3[8][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) m1[kk][r] = m2[kk][r] = 0u;  // bf16 +0.0 pairs
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) m3[kk][r] = 0u;
  }
  const bf16* xw1 = args.xw1 + (size_t)cloud * n_pts * kC1;
  const int* nbr0 = idx + row * k;
  const int* nbr1 = idx + (row + 8) * k;
  // gathered words [h][w]: row + 8h's neighbor, word w of the thread's 32
  // bytes (xw1_order: channels 16 (w >> 1) + 8 (w & 1) + 2t and + 1)
  u32 nxt[2][8];
  auto gather = [&](int j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4* src = reinterpret_cast<const uint4*>(xw1 + (size_t)(h ? nbr1 : nbr0)[j] * kC1) + 2 * t;
      const uint4 v0 = __ldg(src), v1 = __ldg(src + 1);
      nxt[h][0] = v0.x;
      nxt[h][1] = v0.y;
      nxt[h][2] = v0.z;
      nxt[h][3] = v0.w;
      nxt[h][4] = v1.x;
      nxt[h][5] = v1.y;
      nxt[h][6] = v1.z;
      nxt[h][7] = v1.w;
    }
  };
  gather(0);
  sm90::bar_wait(bars, 0);
  const uint64_t d_w2 = desc_sw128(wts, 16), d_w3 = desc_sw128(wts + kW2Bytes, 16);
  const uint64_t d_w4 = desc_sw128(wts + kW2Bytes + kW3Bytes, 16);
  const float *b2 = args.b[0], *b3 = args.b[1], *b4 = args.b[2];
  uint4* m4 = m4s + tid;
  for (int j = 0; j < k; ++j) {
    // e1 = bf16(relu(xw1[nbr] + c1)): k-step kk's registers 0..3 are words
    // 2kk of row g, 2kk of row g + 8, 2kk + 1 of row g, 2kk + 1 of row g + 8
    u32 a2[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, w = 2 * kk + (r >> 1);
        const u32 v = nxt[h][w];
        a2[kk][r] = relu_bf16x2(__fadd_rn(__uint_as_float(v << 16), c1v[h][2 * w]),
                                __fadd_rn(__uint_as_float(v & 0xffff0000u), c1v[h][2 * w + 1]));
      }
    max_into<4>(m1, a2);
    if (j + 1 < k) gather(j + 1);  // in flight during the stages

    u32 a3[4][4], a4[8][4];
    {
      float acc[32];
      product_n64<4>(acc, a2, d_w2, kBox);  // stage 2: 64 -> 64
      to_frags<4>(a3, acc, b2, t);
    }
    max_into<4>(m2, a3);
    {
      float acc[64];  // stage 3: 64 -> 128
      fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::mma_bf16_rs_n128(acc, a3[kk], d_w3 + 2 * kk, kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_operands(acc);
      to_frags<8>(a4, acc, b3, t);
    }
    max_into<8>(m3, a4);
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {  // stage 4: 128 -> 256, rows 64 qr.. of both W4 boxes
      float acc[32];
      product_n64<8>(acc, a4, d_w4 + qr * (kBox >> 4), kW4Box);
      u32 z4[4][4];
      to_frags<4>(z4, acc, b4 + 64 * qr, t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint4 m = m4[(4 * qr + kk) * kThreads];
        m.x = hmax2(m.x, z4[kk][0]);
        m.y = hmax2(m.y, z4[kk][1]);
        m.z = hmax2(m.z, z4[kk][2]);
        m.w = hmax2(m.w, z4[kk][3]);
        m4[(4 * qr + kk) * kThreads] = m;
      }
    }
  }

  // ---- conv5 on the (64, 512) concatenation of the maxes ----
  u32 cat[32][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      cat[kk][r] = m1[kk][r];
      cat[4 + kk][r] = m2[kk][r];
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) cat[8 + kk][r] = m3[kk][r];
  }
#pragma unroll
  for (int c = 0; c < kM4Chunks; ++c) {
    const uint4 m = m4[c * kThreads];
    cat[16 + c][0] = m.x;
    cat[16 + c][1] = m.y;
    cat[16 + c][2] = m.z;
    cat[16 + c][3] = m.w;
  }
  sm90::fence_proxy_async();  // the z4 region's stores before the bulk copies that overwrite it
  __syncthreads();            // both warpgroups are done with the weights and their maxes
  const int nslabs = emb / kSlabCols;
  uint64_t* full = bars + 1;
  if (tid == 0)
    for (int s = 0; s < kStages && s < nslabs; ++s) {
      sm90::bar_expect_tx(full + s, kSlabBytes);
      sm90::bulk_load(wts + s * kSlabBytes, args.w5 + (size_t)s * kSlabBytes, kSlabBytes, full + s);
    }
  const float* b5 = args.b[3];
  bf16* out = args.out + (size_t)cloud * n_pts * emb;
  const int row_top = q0 + row, row_bot = row_top + 8;
  for (int s = 0; s < nslabs; ++s) {
    const int st = s % kStages;
    sm90::bar_wait(full + st, (s / kStages) & 1);
    float acc[32];
    fence_operands(acc);
    sm90::wgmma_fence();
    const uint64_t d_w5 = desc_sw128(wts + st * kSlabBytes, 16);
#pragma unroll
    for (int kk = 0; kk < 32; ++kk)
      sm90::mma_bf16_rs_n64(acc, cat[kk], d_w5 + (kk >> 2) * (kBox >> 4) + 2 * (kk & 3), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();  // both warpgroups are done reading stage st
    if (tid == 0 && s + kStages < nslabs) {
      sm90::bar_expect_tx(full + st, kSlabBytes);
      sm90::bulk_load(wts + st * kSlabBytes, args.w5 + (size_t)(s + kStages) * kSlabBytes, kSlabBytes, full + st);
    }
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int c = s * kSlabCols + 8 * jb + 2 * t;
      const float2 bc = __ldg(reinterpret_cast<const float2*>(b5 + c));
      if (row_top < n_pts)
        *reinterpret_cast<u32*>(out + (size_t)row_top * emb + c) =
            relu_bf16x2(__fadd_rn(acc[4 * jb], bc.x), __fadd_rn(acc[4 * jb + 1], bc.y));
      if (row_bot < n_pts)
        *reinterpret_cast<u32*>(out + (size_t)row_bot * emb + c) =
            relu_bf16x2(__fadd_rn(acc[4 * jb + 2], bc.x), __fadd_rn(acc[4 * jb + 3], bc.y));
    }
  }
}

constexpr int kMaxDevices = 64;

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors: x (B, N, 3) f32; xw1 (B, N, 64) bf16 in xw1_order; wc1 (3, 64)
// f32; b1 (64,) f32; w and w5 the images of DGCNNBf16Weights (90112 and
// 1024 emb bytes); b2..b5 f32; out (B, N, emb) bf16; knn_scale null (exact
// kNN) or the scales of dgcnn_knn_scale at tile_n (approximate); idx a
// scratch of B * N * k int32 for the neighbors. Needs 1 <= k <= 32, k <= N
// <= 4096 and emb % 64 == 0. Two launches, the selection and the chain.
// Returns the CUDA error code (0 on success).
extern "C" int dgcnn_encode_bf16(const float* x, const void* xw1, const float* wc1, const float* b1, const void* w,
                                 const void* w5, const float* b2, const float* b3, const float* b4, const float* b5,
                                 void* out, const float* knn_scale, void* idx, int batch, int n_pts, int k, int emb,
                                 int tile_n, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxN || emb <= 0 || emb % kSlabCols != 0 ||
      tile_n <= 0)
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit (the largest k's), once a device
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(dgcnn_encode_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               1024 + smem_bytes(kMaxK));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  err = static_cast<cudaError_t>(dgcnn_select(x, knn_scale, static_cast<int*>(idx), batch, n_pts, k, tile_n, stream));
  if (err != cudaSuccess) return (int)err;
  Args args{x,
            static_cast<const bf16*>(xw1),
            wc1,
            b1,
            static_cast<const uint8_t*>(w),
            static_cast<const uint8_t*>(w5),
            {b2, b3, b4, b5},
            static_cast<bf16*>(out),
            static_cast<const int*>(idx),
            n_pts,
            k,
            emb};
  const dim3 grid((n_pts + kRows - 1) / kRows, batch);
  dgcnn_encode_bf16_kernel<<<grid, kThreads, 1024 + smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
