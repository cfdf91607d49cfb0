// Fused int8 softmax attention for Hopper (sm_90a), K10: the int8 pointer's
// softmax((q s_q)(k s_k)^T / sqrt(D)) (v s_v). q, k (BH, N|M, D) int8 in,
// (BH, N, D) bf16 out. V comes in the form its P V product reads: with
// INT8_PV, V^T as int8 (BH, D, Mp) with the keys permuted in each 32-key
// chunk and zero-padded to Mp (a multiple of 32); in the hybrid mode, V as
// bf16 (BH, M, D). The wrapper (kernels/attention.py) makes either in one
// copy.
//
// Replaces the TPU kernel learning3d_tpu/kernels/attention.py::
// attention_int8 (body `_attn_kernel_int8`). Same math as the port's plain
// version `attention_int8_reference`: S = float(int32(q k^T)) * sscale
// (sscale = s_q s_k / sqrt(D) as a float), the exact row max m,
// p = expf(s - m) in f32 (the row max of p is exactly 1), l = sum(p) in f32
// from the unrounded p; with INT8_PV, P = round(127 p) (round half to even)
// and O = float(int32(P V)) * oscale / l with oscale = s_v / 127; otherwise
// ("hybrid") P = bf16(p), O = (P @ bf16(V) in f32) * oscale / l with
// oscale = s_v (int8 values are exact in bf16). P is rounded against the
// exact row max, unnormalized, as the TPU kernel rounds it. Scale,
// subtraction and the epilogue are written with __fmul_rn/__fsub_rn/
// __fdiv_rn so that nvcc does not contract them.
//
// Bound. The pointer's call (B=32, H=4, N=M=1024, D=128) is two products,
// 4 * 128 * 1024 * 1024 * 128 = 68.7 G operations: with INT8_PV all int8,
// 35 us at the dense int8 peak (1,979 TOP/s); hybrid, Q K^T at the int8
// rate and P V at the bf16 rate (989 TFLOP/s), 52 us. Its bytes (4 x 4.2 MB
// in, 8.4 MB out) take 5 us at 3.35 TB/s. The 134 M exponentials take ~32
// us of SFU time and the scale, subtraction, round(127 p) and conversions
// ~25 us of the CUDA cores: as much as the products, so the kernel comes
// near its bound only where they overlap the wgmma of the other warpgroup.
//
// Why two passes, and the 3-product floor. P is rounded against the EXACT
// row max (as the TPU kernel rounds it), so pass 1 computes S = Q K^T once
// to take the max and pass 2 computes it again to form P: three products,
// 52 us (INT8_PV) and 69 us (hybrid) at the pointer's shape. Pass 1's max
// is an integer max of the int32 accumulators, converted and scaled once:
// the conversion is exact (|S| < 2^24) and rounding x * sscale is monotone
// for sscale >= 0, so it is the max of the scaled scores bit for bit.
//
// Design (csrc/attention_sm90.cuh; K6's, csrc/attention.cu, with int8
// operands):
// * Grid (ceil(N / 128), BH), 384 threads: two consumer warpgroups of 64
//   query rows and a producer warpgroup whose one thread issues every TMA
//   load through mbarrier rings of 128-key tiles (3 K and 2 V stages at D
//   <= 256; fewer at D = 512, where the Q tile and K stages are 64 KB).
//   setmaxnreg gives the producer 40 registers and the consumers 232.
// * S = Q K^T by wgmma m64n128k32 s8.s8 -> s32, Q and K K-major as stored
//   (int8 wgmma has no transpose).
// * INT8_PV: P from registers in the int8 A-fragment layout, O += P V by
//   wgmma m64n128k32 with V^T the K-major B operand. The accumulators hand
//   a thread keys 2t, 2t+1, 8+2t, 9+2t of each 16 while an A fragment
//   takes 4 consecutive k, so V^T is stored with the keys of each 16 in
//   that order (logical 4t + i = key 2t + i, i < 2; 8 + 2t + i - 2, i >= 2):
//   a TMA tile of V^T arrives in the order P is handed over in, and the
//   kernel stages nothing by hand. The sum over keys is exact in int32, so
//   the order changes nothing. round(127 p) is one FP32 add of 1.5 * 2^23
//   (exact, ties to even) instead of an F2I conversion.
// * Hybrid: bf16 P from registers (the accumulator layout is the bf16 A
//   layout), O += P V by wgmma m64n128k16 with V the MN-major B operand.
//   V is widened to bf16 once before the kernel (8.4 MB at the pointer's
//   shape) rather than by each block in shared memory through the CUDA
//   cores, which are the busy units here.
// * V's form for either mode is made before the kernel by values_t_kernel
//   or values_bf16_kernel below (C entry attention_int8_values): a
//   coalesced pass through shared memory, where torch's strided copies took
//   0.114 ms (the transpose) and 0.049 ms (the widening) at the pointer's
//   shape on the H100, half of the attention kernel's own time.
// * What bounds it: the softmax on the CUDA cores (the accurate expf, 8
//   dependent instructions an element, beside the conversion, scale and
//   subtraction), as in K6. The exponentials are branch-free (a column past
//   M gets the argument -inf), p overwrites the score registers in place,
//   only the last tile is masked, and the two consumer warpgroups take
//   turns at issuing their products (named barriers), so that one's
//   exponentials overlap the other's wgmma.
// * D > 128 runs pass 2 once per 128-column slab (S recomputed per slab).
// * Ragged N and M: the 3-D tensor maps give zeros past N and M of one head
//   (never the next head's rows); key columns past M are INT_MIN in pass 1
//   and p = 0 in pass 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTileK = 128;  // keys a tile: 128 int8 keys are one swizzle row of V^T
constexpr int kMaxD = 512;

struct Args {
  bf16* out;
  int n, m, d;
  float sscale, oscale;
  sm90::Layout lay;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// Issues the warpgroup's 64 x 128 int32 scores S = Q K^T: `boxes` 128-wide
// column boxes of Q (this warpgroup's 64 rows) and of the K tile, four
// k-steps of 32 each. The caller commits the wgmma group and waits for it.
__device__ __forceinline__ void issue_scores(int (&s)[64], const uint8_t* sq, const uint8_t* sk, int boxes) {
  sm90::fence_operands(s);
  sm90::wgmma_fence();
  for (int b = 0; b < boxes; ++b) {
    const uint64_t da = sm90::desc_sw128(sq + b * sm90::kRowsQ * sm90::kRowBytes, 16);
    const uint64_t db = sm90::desc_sw128(sk + b * kTileK * sm90::kRowBytes, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::mma_s8_ss_n128(s, da + 2 * kk, db + 2 * kk, b > 0 || kk > 0);
  }
}

// The running integer max of rows g and g + 8 over a tile's scores. Only
// the last tile is MASKED: there `left` is how many of its columns from
// this thread's first (2 tq) on lie before M.
template <bool MASKED>
__device__ __forceinline__ void tile_max(int (&mx)[2], const int (&s)[64], int left) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = max(mx[(i >> 1) & 1], !MASKED || 8 * (i >> 2) + (i & 1) < left ? s[i] : INT_MIN);
}

// p = expf(float(s) * sscale - m), in place (s then holds p's bits), and
// l += p. Branch-free: in the MASKED last tile a column past M gets the
// argument -inf, and expf gives exactly 0 (a branch around each expf would
// serialize them).
template <bool MASKED>
__device__ __forceinline__ void tile_exp(int (&s)[64], float (&l)[2], const float (&m)[2], float sscale,
                                         int left) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    const float x = __fsub_rn(__fmul_rn(__int2float_rn(s[i]), sscale), m[h]);
    const float p = expf(!MASKED || 8 * (i >> 2) + (i & 1) < left ? x : -INFINITY);
    l[h] += p;
    s[i] = __float_as_int(p);
  }
}

// P (the bits of p, from tile_exp) as wgmma A fragments. int8: round(127
// p) to nearest even on the FP32 pipe (127 p is in [0, 127]; adding 1.5 *
// 2^23 rounds it to an integer that the low byte of the sum's bits then
// holds, where the F2I unit does 16 a clock an SM), four keys a register in
// the fragment's k order: of the 32-key chunk c, accumulators 16c + {0, 1,
// 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15} (see key_order in
// kernels/attention.py). bf16: k-step kk takes accumulators 8 kk .. 8 kk +
// 7, the A-fragment layout.
template <bool INT8_PV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const int (&p)[64]) {
  if constexpr (INT8_PV) {
    uint32_t q[64];
#pragma unroll
    for (int i = 0; i < 64; ++i)
      q[i] = __float_as_uint(__fadd_rn(__fmul_rn(__int_as_float(p[i]), 127.f), 12582912.f));
    auto four = [&](int i0, int i1, int i2, int i3) {
      return __byte_perm(__byte_perm(q[i0], q[i1], 0x0040), __byte_perm(q[i2], q[i3], 0x0040), 0x5410);
    };
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 16 * c;
      pa[c][0] = four(b, b + 1, b + 4, b + 5);
      pa[c][1] = four(b + 2, b + 3, b + 6, b + 7);
      pa[c][2] = four(b + 8, b + 9, b + 12, b + 13);
      pa[c][3] = four(b + 10, b + 11, b + 14, b + 15);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(__int_as_float(p[i]), __int_as_float(p[i + 1]));
  }
}

template <bool INT8_PV>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    attention_int8_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const sm90::Layout& lay = a.lay;
  const sm90::Bars bars(smem, lay);
  const int bh = blockIdx.y, q0 = blockIdx.x * sm90::kRowsQ;
  const int boxes = a.d / 128;
  const int ntiles = (a.m + kTileK - 1) / kTileK;
  if (threadIdx.x == 0) bars.init(lay);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer
    sm90::setmaxnreg_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      const sm90::Loads ld{&map_q, &map_k, &map_v, boxes, 128, kTileK, ntiles, a.d / sm90::kSlab,
                           INT8_PV ? 1 : 2, INT8_PV ? 1 : 0};
      sm90::produce(ld, lay, smem, bars, q0, bh);
    }
  } else {  // the consumers: rows q0 + 64 wg + [0, 64)
    sm90::setmaxnreg_inc<sm90::kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const uint8_t* sq = smem + wg * 64 * sm90::kRowBytes;
    sm90::Ring kr(lay.nk), vr(lay.nv);
    const sm90::PingPong turns(wg);
    int s[64];
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

    // pass 1: the exact row max, an integer max of the accumulators (rows g
    // and g + 8 of the warp's 16), converted and scaled once
    int imx[2] = {INT_MIN, INT_MIN};
    for (int t = 0; t < ntiles; ++t) {
      turns.turn();
      issue();
      sm90::wgmma_commit();
      turns.pass();
      sm90::wgmma_wait<0>();
      retire();
      if ((t + 1) * kTileK <= a.m)
        tile_max<false>(imx, s, 0);
      else
        tile_max<true>(imx, s, left0 - t * kTileK);
    }
    float mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 1));
      imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 2));
      mx[h] = __fmul_rn(__int2float_rn(imx[h]), a.sscale);
    }

    // pass 2, per 128-column slab: p = expf(s - m), l = sum(p), O += P V.
    // One wgmma group a tile, tile t's P V and tile t + 1's scores, whose
    // exponentials follow while the other warpgroup's group runs.
    bf16* out = a.out + (size_t)bh * a.n * a.d;
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    for (int v0 = 0; v0 < a.d; v0 += sm90::kSlab) {
      int oi[64];
      float of[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        oi[i] = 0;
        of[i] = 0.f;
      }
      float l[2] = {0.f, 0.f};
      uint32_t pa[8][4];
      turns.turn();
      issue();
      sm90::wgmma_commit();
      turns.pass();
      sm90::wgmma_wait<0>();
      retire();
      const float sscale = a.sscale;
      if (kTileK <= a.m)
        tile_exp<false>(s, l, mx, sscale, 0);
      else
        tile_exp<true>(s, l, mx, sscale, left0);
      pack_p<INT8_PV>(pa, s);
      for (int t = 0; t < ntiles; ++t) {
        const bool more = t + 1 < ntiles;
        turns.turn();
        sm90::bar_wait(bars.v_full + vr.stage, vr.phase);
        const uint8_t* sv = smem + lay.v_off(vr.stage);
        if constexpr (INT8_PV) {
          sm90::fence_operands(oi);
          sm90::wgmma_fence();
          const uint64_t desc_v = sm90::desc_sw128(sv, 16);  // V^T: K-major, 128 rows of 128 keys
#pragma unroll
          for (int c = 0; c < 4; ++c) sm90::mma_s8_rs_n128(oi, pa[c], desc_v + 2 * c, 1);
        } else {
          sm90::fence_operands(of);
          sm90::wgmma_fence();
          const uint64_t desc_v = sm90::desc_sw128(sv, kTileK * sm90::kRowBytes);  // V: MN-major
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) sm90::mma_bf16_rs_n128_mn(of, pa[kk], desc_v + 128 * kk, 1);
        }
        if (more) issue();
        sm90::wgmma_commit();
        turns.pass();
        sm90::wgmma_wait<0>();
        if constexpr (INT8_PV)
          sm90::fence_operands(oi);
        else
          sm90::fence_operands(of);
        sm90::release(bars.v_empty + vr.stage, lane);
        vr.next();
        if (more) {
          retire();
          if ((t + 2) * kTileK <= a.m)
            tile_exp<false>(s, l, mx, sscale, 0);
          else
            tile_exp<true>(s, l, mx, sscale, left0 - (t + 1) * kTileK);
          pack_p<INT8_PV>(pa, s);
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
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float acc = INT8_PV ? __int2float_rn(oi[i]) : of[i];
            x[e] = __fdiv_rn(__fmul_rn(acc, a.oscale), l[h]);
          }
          *reinterpret_cast<uint32_t*>(out + (size_t)row * a.d + v0 + 8 * j + 2 * tq) = pack_bf16(x[0], x[1]);
        }
      }
    }
    turns.close();
  }
}

// V as K10's P V reads it, made before the kernel in one pass over V.
// INT8_PV: V^T (BH, D, Mp), its keys in key_order (position 16h + 4t + i
// of a 16-key group holds key 16h + 2t + i for i < 2, 16h + 8 + 2t + i - 2
// for i >= 2) and zero past M: a 64-key x 64-column tile a block, read and
// written 16 bytes a thread through shared memory.
__global__ void __launch_bounds__(256) values_t_kernel(const int8_t* v, int8_t* vt, int m, int mp, int d) {
  __shared__ int8_t tile[64][64 + 16];
  const int k0 = blockIdx.x * 64, c0 = blockIdx.y * 64, bh = blockIdx.z;
  {
    const int key = threadIdx.x >> 2, part = threadIdx.x & 3;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + key < m) w = *reinterpret_cast<const uint4*>(v + ((size_t)bh * m + k0 + key) * d + c0 + 16 * part);
    *reinterpret_cast<uint4*>(&tile[key][16 * part]) = w;
  }
  __syncthreads();
  const int col = threadIdx.x >> 2, part = threadIdx.x & 3;  // positions 16 part .. 16 part + 15
  if (k0 + 16 * part >= mp) return;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = 4 * j + b, t = r >> 2, i = r & 3;  // position 16 part + r
      const int key = 16 * part + (i < 2 ? 2 * t + i : 6 + 2 * t + i);
      word |= static_cast<uint32_t>(static_cast<uint8_t>(tile[key][col])) << (8 * b);
    }
    w[j] = word;
  }
  int8_t* dst = vt + ((size_t)bh * d + c0 + col) * mp + k0 + 16 * part;
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Hybrid: V widened to bf16 (int8 values are exact), 16 values a thread.
__global__ void __launch_bounds__(256) values_bf16_kernel(const int8_t* v, bf16* out, size_t n16) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n16; i += (size_t)gridDim.x * blockDim.x) {
    const uint4 w = reinterpret_cast<const uint4*>(v)[i];
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t* b = reinterpret_cast<const int8_t*>(&words[e]);
      h[2 * e] = pack_bf16(static_cast<float>(b[0]), static_cast<float>(b[1]));
      h[2 * e + 1] = pack_bf16(static_cast<float>(b[2]), static_cast<float>(b[3]));
    }
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * i;
    o[0] = make_uint4(h[0], h[1], h[2], h[3]);
    o[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

sm90::Layout layout(int d, bool int8_pv) {
  const int boxes = d / 128;
  sm90::Layout lay{boxes * sm90::kRowsQ * sm90::kRowBytes, boxes * kTileK * sm90::kRowBytes,
                   (int8_pv ? 1 : 2) * kTileK * sm90::kRowBytes, 0, 0};
  sm90::choose_stages(&lay);
  return lay;
}

template <bool INT8_PV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int n, int m, int mp, int d, float sscale,
           float oscale, cudaStream_t stream) {
  const sm90::Layout lay = layout(d, INT8_PV);
  CUtensorMap mq, mk, mv;
  int err = sm90::make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, d, n, bh, 128, sm90::kRowsQ);
  if (err == 0) err = sm90::make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, d, m, bh, 128, kTileK);
  if (err == 0) {
    if (INT8_PV)  // V^T (BH, D, Mp): boxes of 128 keys x 128 columns
      err = sm90::make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v, mp, d, bh, kTileK, sm90::kSlab);
    else  // V (BH, M, D) bf16: boxes of 64 columns x 128 keys
      err = sm90::make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, d, m, bh, 64, kTileK);
  }
  if (err != 0) return err;
  const int bytes = lay.total();
  cudaError_t e =
      cudaFuncSetAttribute(attention_int8_kernel<INT8_PV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const Args args{static_cast<bf16*>(out), n, m, d, sscale, oscale, lay};
  dim3 grid((n + sm90::kRowsQ - 1) / sm90::kRowsQ, bh);
  attention_int8_kernel<INT8_PV><<<grid, sm90::kThreads, bytes, stream>>>(mq, mk, mv, args);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. All pointers are device pointers to contiguous
// tensors, 16-byte aligned: q (BH, N, D) int8, k (BH, M, D) int8, out (BH,
// N, D) bf16; v with int8_pv V^T (BH, D, Mp) int8, its keys permuted in
// each 32-key chunk (see the notes above) and zero-padded to Mp, a multiple
// of 32 >= M; without, V (BH, M, D) bf16 (mp unused). Needs D % 128 == 0,
// D <= 512 and sscale >= 0. sscale = s_q s_k / sqrt(D); oscale = s_v / 127
// with int8_pv, s_v without. Returns the CUDA error code of the launch (0
// on success).
extern "C" int attention_int8(const void* q, const void* k, const void* v, void* out, int bh, int n, int m, int mp,
                              int d, float sscale, float oscale, int int8_pv, void* stream) {
  if (bh <= 0 || n <= 0 || m <= 0 || d <= 0 || d % 128 != 0 || d > kMaxD || !(sscale >= 0.f) ||
      (int8_pv && (mp < m || mp % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8_pv ? launch<true>(q, k, v, out, bh, n, m, mp, d, sscale, oscale, s)
                 : launch<false>(q, k, v, out, bh, n, m, mp, d, sscale, oscale, s);
}

// K10's V as its P V reads it (see values_t_kernel), from v (BH, M, D) int8
// into out: with int8_pv V^T (BH, D, Mp) int8, Mp a multiple of 32 >= M;
// without, V (BH, M, D) bf16 (mp unused). Needs D % 128 == 0; pointers
// 16-byte aligned. Returns the CUDA error code of the launch.
extern "C" int attention_int8_values(const void* v, void* out, int bh, int m, int mp, int d, int int8_pv,
                                     void* stream) {
  if (bh <= 0 || m <= 0 || d <= 0 || d % 128 != 0 || (int8_pv && (mp < m || mp % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_pv) {
    dim3 grid((mp + 63) / 64, d / 64, bh);
    values_t_kernel<<<grid, 256, 0, s>>>(static_cast<const int8_t*>(v), static_cast<int8_t*>(out), m, mp, d);
  } else {
    const size_t n16 = (size_t)bh * m * d / 16;
    const int blocks = (int)((n16 + 255) / 256 < 4096 ? (n16 + 255) / 256 : 4096);
    values_bf16_kernel<<<blocks, 256, 0, s>>>(static_cast<const int8_t*>(v), static_cast<bf16*>(out), n16);
  }
  return (int)cudaGetLastError();
}
