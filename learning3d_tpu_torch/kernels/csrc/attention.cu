// Fused softmax attention for Hopper (sm_90a), K6: the DCP pointer's,
// PRNet's pointer's and the SVD head's softmax(Q K^T / sqrt(D)) V. q, k
// (BH, N|M, D) bf16, v (BH, M, Dv) bf16 in, (BH, N, Dv) out in bf16 or f32
// (the caller's q dtype, as the TPU kernel writes q.dtype: f32 DCP and
// PRNet keep their f32 output).
//
// Replaces the TPU kernel learning3d_tpu/kernels/attention.py::
// attention_pallas (body `_attn_kernel`). Same math as the port's plain
// version `attention_reference`: bf16 operands, f32 scores times the float
// 1/sqrt(D), the exact row max m, p = expf(s - m) in f32 (expf, not the
// fast __expf), l = sum(p) in f32 from the unrounded p, P rounded to bf16
// before it is normalized, O = (P_bf16 @ V) / l, stored in f32 or rounded
// once to bf16. The scaling, the subtraction of m and the division are
// written with __fmul_rn/__fsub_rn/__fdiv_rn so that nvcc does not contract
// them into FMAs, which would round otherwise than the plain version.
//
// Bound. The pointer's call (B=32, H=4, N=M=1024, D=Dv=128) is two
// products, 4 * 128 * 1024 * 1024 * 128 = 68.7 GFLOP: 69 us at the dense
// bf16 peak (989 TFLOP/s); its bytes (4 x 8.4 MB) take 10 us at 3.35 TB/s.
// Bound by operations. The 134 M exponentials take ~32 us of SFU time,
// beside the tensor cores.
//
// Why two passes, and the 3-product floor. The TPU kernel rounds P to bf16
// unnormalized against the EXACT row max, so the max has to be known
// before any P is formed: pass 1 computes S = Q K^T once to take it, pass 2
// computes S again to form P. An online softmax would round P against a
// running max, 1.3e-3 of max off at the pointer's distribution, more than
// K6_F32_TOL. The floor is therefore three products, 104 us at the
// pointer's shape. Pass 1's max is taken over the raw f32 accumulators and
// scaled once: rounding x * scale is monotone in x for scale > 0, so
// fl(max(S) * scale) is the max of the scaled scores bit for bit, and pass
// 2, which computes the same S from the same tiles in the same order,
// gives exp(0) = 1 at the max.
//
// Design (the wgmma instance, every D <= 256 with Dv % 8 == 0: the pointer
// in bf16 and f32, PRNet's 768 <-> 1024 keys, Dv = 256):
// * Grid (ceil(N / 128), B * H), 384 threads: two consumer warpgroups of 64
//   query rows each and one producer warpgroup, of which one thread issues
//   every TMA load (csrc/attention_sm90.cuh: Q once, then the K tiles of
//   pass 1, then K and V tiles of pass 2, through mbarrier rings: 3 K and 2
//   V stages of 128 keys at D <= 128, 2 and 1 at D = 256). setmaxnreg gives
//   the producer 40 registers and the consumers 232.
// * S = Q K^T by wgmma m64n128k16 from the swizzled Q and K tiles; each
//   warpgroup reads the K tile once for its 64 rows. (A 64-key tile,
//   m64n64k16, ran 18% slower on the H100.)
// * Pass 2: p = expf(s * scale - m) in place in the accumulators, packed to
//   bf16 wgmma A registers (for 16-bit types the accumulator layout is the
//   A-fragment layout); O += P V by wgmma m64n128k16 with V the MN-major B
//   operand (row-major V, the transpose bit). A tile's P V and the next
//   tile's Q K^T go out as one wgmma group; the next exponentials follow
//   its wait. Dv > 128 runs pass 2 once per 128-column slab (S recomputed
//   per slab).
// * What bounds it on the H100 is the softmax on the CUDA cores, not the
//   tensor cores: the accurate expf is 8 dependent instructions an element
//   (with the unfused scale and subtraction, ~12), where an online-softmax
//   kernel spends one FFMA and one ex2. So the exponentials are kept free of
//   branches (a column past M gets the argument -inf, expf gives exactly 0;
//   a branch around each expf serialized them, 1.4x the time), only the
//   last tile is masked, and the two consumer warpgroups take turns at
//   issuing their products (named barriers, FA3's ping-pong), so that one
//   warpgroup's exponentials overlap the other's products instead of both
//   warpgroups doing the same thing at once. Overlapping a warpgroup's own
//   next product with its exponentials (two score buffers) made ptxas
//   serialize the wgmma's (C7514) and ran slower.
// * Ragged N and M: the 3-D tensor maps give zeros past N, M and Dv of one
//   head (never the next head's rows); key columns past M are -inf in pass
//   1 (a zero would raise a negative max) and p = 0 in pass 2.
//
// The mma.sync instance (mma_sync:: below) keeps every other shape: the
// SVD head (D = 512, Dv = 3: a 6-byte V row no TMA map takes; 0.470 ms,
// faster than its library call) and D > 256 or Dv % 8 != 0. It uses
// ldmatrix fragments from padded shared memory and plain 16-byte loads;
// two passes as above; pass 2 in slabs of 8 output columns, the mma width
// (the head's Dv = 3 padded to it inside the kernel). No main path has Dv
// > 8 there: such V recomputes S once a slab. The C entry chooses the
// instance by shape, never on a failure (`attention_bf16_instance` names
// it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "attention_sm90.cuh"

// ---- the mma.sync instance: the SVD head, D > 256 and Dv % 8 != 0 ----------

namespace mma_sync {

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

constexpr int kSlabV = 8;            // output columns a pass 2 (the mma width)
constexpr int kLdV = kSlabV + 8;

// Q tile, K tile, V tile; rows padded by 8 elements (16 bytes) so that the
// eight rows an ldmatrix reads fall in different banks.
__host__ __device__ constexpr int smem_bytes(int d) { return 2 * (kRowsQ + kTileK) * (d + 8) + 2 * kTileK * kLdV; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__global__ void __launch_bounds__(kThreads, 2) attention_bf16_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = args.d, ld = d + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRowsQ * ld;
  bf16* vs = ks + kTileK * ld;
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

  // pass 2, per slab of 8 output columns: p = expf(s - m), l = sum(p),
  // O += bf16(P) @ V
  const size_t out0 = (size_t)bh * args.n * args.dv;
  for (int v0 = 0; v0 < args.dv; v0 += kSlabV) {
    float l[2] = {0.f, 0.f};
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < args.m; kt += kTileK) {
      __syncthreads();
      load_tile(ks, kg, kt, kTileK, args.m, d);
      if (args.dv % 8 == 0) {
        load_tile(vs, vg, kt, kTileK, args.m, args.dv, v0, kSlabV);
      } else {
        for (int i = threadIdx.x; i < kTileK * kSlabV; i += kThreads) {
          const int key = i / kSlabV, col = i - key * kSlabV;
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
      // addresses key row 16 kk + l % 16.
      const bf16* pv = vs + (lane & 15) * kLdV;
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t b[2];
        ldmatrix_x2_trans(b, pv + 16 * kk * kLdV);
        mma_bf16(o, a, b[0], b[1]);
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
      for (int e = 0; e < 2; ++e) {
        const int c = v0 + 2 * t + e;
        if (c >= args.dv) continue;
        const float val = o[2 * half + e] / l[half];
        const size_t at = out0 + (size_t)row * args.dv + c;
        if (args.out_f32)
          static_cast<float*>(args.out)[at] = val;
        else
          static_cast<bf16*>(args.out)[at] = __float2bfloat16_rn(val);
      }
    }
  }
}

int launch(const Args& args, int bh, cudaStream_t stream) {
  const int bytes = smem_bytes(args.d);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((args.n + kRowsQ - 1) / kRowsQ, bh);
  attention_bf16_kernel<<<grid, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace mma_sync

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTileK = 128;  // keys a tile of the wgmma instance
constexpr int kMaxDSm90 = 256;

struct Sm90Args {
  void* out;  // float* if out_f32, else bf16*
  int out_f32, n, m, d, dv;
  float scale;
  sm90::Layout lay;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Issues the warpgroup's 64 x kTileK scores S = Q K^T, unscaled: `boxes`
// 64-wide column boxes of Q (this warpgroup's 64 rows) and of the K tile,
// four k-steps of 16 each. The caller commits the wgmma group and waits
// for it.
__device__ __forceinline__ void issue_scores(float (&s)[kTileK / 2], const uint8_t* sq, const uint8_t* sk,
                                             int boxes) {
  sm90::fence_operands(s);
  sm90::wgmma_fence();
  for (int b = 0; b < boxes; ++b) {
    const uint64_t da = sm90::desc_sw128(sq + b * sm90::kRowsQ * sm90::kRowBytes, 16);
    const uint64_t db = sm90::desc_sw128(sk + b * kTileK * sm90::kRowBytes, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::mma_bf16_ss(s, da + 2 * kk, db + 2 * kk, b > 0 || kk > 0);
  }
}

// The running max of rows g and g + 8 over a tile's raw scores. Only the
// last tile is MASKED: there `left` is how many of its columns from this
// thread's first (2 tq) on lie before M.
template <bool MASKED>
__device__ __forceinline__ void tile_max(float (&mx)[2], const float (&s)[kTileK / 2], int left) {
#pragma unroll
  for (int i = 0; i < kTileK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], !MASKED || 8 * (i >> 2) + (i & 1) < left ? s[i] : -INFINITY);
}

// p = expf(s * scale - m) in place and l += p. Branch-free: in the MASKED
// last tile a column past M gets the argument -inf, and expf gives exactly
// 0 (a branch around each expf would serialize them).
template <bool MASKED>
__device__ __forceinline__ void tile_exp(float (&s)[kTileK / 2], float (&l)[2], const float (&m)[2], float scale,
                                         int left) {
#pragma unroll
  for (int i = 0; i < kTileK / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float x = __fsub_rn(__fmul_rn(s[i], scale), m[h]);
    s[i] = expf(!MASKED || 8 * (i >> 2) + (i & 1) < left ? x : -INFINITY);
    l[h] += s[i];
  }
}

// bf16(P) as wgmma A fragments: k-step kk takes accumulator columns 16 kk
// .. 16 kk + 15, which for 16-bit types is the A-fragment layout.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kTileK / 16][4], const float (&p)[kTileK / 2]) {
#pragma unroll
  for (int i = 0; i < kTileK / 2; i += 2) pa[i >> 3][(i >> 1) & 3] = pack_bf16(p[i], p[i + 1]);
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const Sm90Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const sm90::Layout& lay = a.lay;
  const sm90::Bars bars(smem, lay);
  const int bh = blockIdx.y, q0 = blockIdx.x * sm90::kRowsQ;
  const int boxes = (a.d + 63) / 64;
  const int ntiles = (a.m + kTileK - 1) / kTileK;
  if (threadIdx.x == 0) bars.init(lay);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer
    sm90::setmaxnreg_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      const sm90::Loads ld{&map_q, &map_k, &map_v, boxes, 64, kTileK, ntiles,
                           (a.dv + sm90::kSlab - 1) / sm90::kSlab, 2, 0};
      sm90::produce(ld, lay, smem, bars, q0, bh);
    }
  } else {  // the consumers: rows q0 + 64 wg + [0, 64)
    sm90::setmaxnreg_inc<sm90::kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const uint8_t* sq = smem + wg * 64 * sm90::kRowBytes;
    sm90::Ring kr(lay.nk), vr(lay.nv);
    const sm90::PingPong turns(wg);
    float s[kTileK / 2];
    // waits for the next K tile and issues its scores into s
    auto issue = [&]() {
      sm90::bar_wait(bars.k_full + kr.stage, kr.phase);
      issue_scores(s, sq, smem + lay.k_off(kr.stage), boxes);
    };
    // after the wait: frees that K tile
    auto retire = [&]() {
      sm90::fence_operands(s);
      sm90::release(bars.k_empty + kr.stage, lane);
      kr.next();
    };
    const int left0 = a.m - 2 * tq;  // tile t: left0 - t kTileK
    sm90::bar_wait(bars.q_full, 0);
    turns.open();

    // pass 1: the exact row max of the raw scores (rows g and g + 8 of the
    // warp's 16), scaled once
    float mx[2] = {-INFINITY, -INFINITY};
    for (int t = 0; t < ntiles; ++t) {
      turns.turn();
      issue();
      sm90::wgmma_commit();
      turns.pass();
      sm90::wgmma_wait<0>();
      retire();
      if ((t + 1) * kTileK <= a.m)
        tile_max<false>(mx, s, 0);
      else
        tile_max<true>(mx, s, left0 - t * kTileK);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = __fmul_rn(mx[h], a.scale);
    }

    // pass 2, per slab of 128 output columns: p = expf(s - m), l = sum(p),
    // O += bf16(P) V. One wgmma group a tile, tile t's P V and tile t + 1's
    // scores, whose exponentials follow while the other warpgroup's group
    // runs.
    const size_t out0 = (size_t)bh * a.n * a.dv;
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    for (int v0 = 0; v0 < a.dv; v0 += sm90::kSlab) {
      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float l[2] = {0.f, 0.f};
      uint32_t pa[kTileK / 16][4];
      turns.turn();
      issue();
      sm90::wgmma_commit();
      turns.pass();
      sm90::wgmma_wait<0>();
      retire();
      const float scale = a.scale;
      if (kTileK <= a.m)
        tile_exp<false>(s, l, mx, scale, 0);
      else
        tile_exp<true>(s, l, mx, scale, left0);
      pack_p(pa, s);
      for (int t = 0; t < ntiles; ++t) {
        const bool more = t + 1 < ntiles;
        turns.turn();
        sm90::bar_wait(bars.v_full + vr.stage, vr.phase);
        sm90::fence_operands(o);
        sm90::wgmma_fence();
        const uint64_t desc_v = sm90::desc_sw128(smem + lay.v_off(vr.stage), kTileK * sm90::kRowBytes);
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk) sm90::mma_bf16_rs_n128_mn(o, pa[kk], desc_v + 128 * kk, 1);
        if (more) issue();
        sm90::wgmma_commit();
        turns.pass();
        sm90::wgmma_wait<0>();
        sm90::fence_operands(o);
        sm90::release(bars.v_empty + vr.stage, lane);
        vr.next();
        if (more) {
          retire();
          if ((t + 2) * kTileK <= a.m)
            tile_exp<false>(s, l, mx, scale, 0);
          else
            tile_exp<true>(s, l, mx, scale, left0 - (t + 1) * kTileK);
          pack_p(pa, s);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= a.n) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = v0 + 8 * j + 2 * tq;
          if (c >= a.dv) continue;
          const float x0 = __fdiv_rn(o[4 * j + 2 * h], l[h]), x1 = __fdiv_rn(o[4 * j + 2 * h + 1], l[h]);
          const size_t at = out0 + (size_t)row * a.dv + c;
          if (a.out_f32)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) = make_float2(x0, x1);
          else
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + at) = pack_bf16(x0, x1);
        }
      }
    }
    turns.close();
  }
}

bool use_sm90(int d, int dv) { return d <= kMaxDSm90 && dv % 8 == 0; }

sm90::Layout sm90_layout(int d) {
  const int boxes = (d + 63) / 64;
  sm90::Layout lay{boxes * sm90::kRowsQ * sm90::kRowBytes, boxes * kTileK * sm90::kRowBytes,
                   2 * kTileK * sm90::kRowBytes, 0, 0};
  sm90::choose_stages(&lay);
  return lay;
}

int launch_sm90(const void* q, const void* k, const void* v, void* out, int out_f32, int bh, int n, int m, int d,
                int dv, float scale, cudaStream_t stream) {
  const sm90::Layout lay = sm90_layout(d);
  CUtensorMap mq, mk, mv;
  int err = sm90::make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, d, n, bh, 64, sm90::kRowsQ);
  if (err == 0) err = sm90::make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, d, m, bh, 64, kTileK);
  if (err == 0) err = sm90::make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, dv, m, bh, 64, kTileK);
  if (err != 0) return err;
  const int bytes = lay.total();
  cudaError_t e = cudaFuncSetAttribute(attention_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const Sm90Args args{out, out_f32, n, m, d, dv, scale, lay};
  dim3 grid((n + sm90::kRowsQ - 1) / sm90::kRowsQ, bh);
  attention_sm90_kernel<<<grid, sm90::kThreads, bytes, stream>>>(mq, mk, mv, args);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors, 16-byte aligned: q (BH, N, D), k (BH, M, D), v (BH, M, Dv) bf16,
// out (BH, N, Dv) f32 if out_f32 is nonzero, else bf16.
// Needs D % 16 == 0, D <= 512 and 1 <= Dv <= 512. `scale` is 1/sqrt(D) as a
// float. Returns the CUDA error code of the launch (0 on success).
extern "C" int attention_bf16(const void* q, const void* k, const void* v, void* out, int out_f32,
                              int bh, int n, int m, int d, int dv, float scale, void* stream) {
  if (bh <= 0 || n <= 0 || m <= 0 || d <= 0 || d % 16 != 0 || d > mma_sync::kMaxD || dv <= 0 ||
      dv > mma_sync::kMaxDv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_sm90(d, dv)) return launch_sm90(q, k, v, out, out_f32, bh, n, m, d, dv, scale, s);
  const mma_sync::Args args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), out, out_f32, n, m, d, dv, scale};
  return mma_sync::launch(args, bh, s);
}

// The instance attention_bf16 runs for (D, Dv), and its tiles and stages.
extern "C" const char* attention_bf16_instance(int d, int dv) {
  static thread_local char name[96];
  if (use_sm90(d, dv)) {
    const sm90::Layout lay = sm90_layout(d);
    snprintf(name, sizeof name, "wgmma+TMA, %d-key tiles, %d K + %d V stages", kTileK, lay.nk, lay.nv);
  } else {
    snprintf(name, sizeof name, "mma.sync, 8-column slabs");
  }
  return name;
}
