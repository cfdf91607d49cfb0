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
// Design (csrc/attention_sm90.cuh, where the consumers live, shared with
// K11's int8 P.V instance; K6's design, csrc/attention.cu, with int8
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
//   (sm90::values_t_block) or values_bf16_kernel below (C entry
//   attention_int8_values): a
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

constexpr int kTileK = sm90::kS8TileK;
constexpr int kMaxD = 512;

struct Args {
  bf16* out;
  int n, m, d;
  float sscale, oscale;
  sm90::Layout lay;
};

using sm90::pack_bf16;

template <bool INT8_PV>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    attention_int8_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const sm90::Layout& lay = a.lay;
  const sm90::Bars bars(smem, lay);
  const int bh = blockIdx.y, q0 = blockIdx.x * sm90::kRowsQ;
  if (threadIdx.x == 0) bars.init(lay);
  __syncthreads();

  if (threadIdx.x / 128 == 2) {  // the producer
    sm90::setmaxnreg_dec<sm90::kProducerRegs>();
    if (threadIdx.x == 256) {
      const sm90::Loads ld{&map_q, &map_k, &map_v, a.d / 128, 128, kTileK, (a.m + kTileK - 1) / kTileK,
                           a.d / sm90::kSlab, INT8_PV ? 1 : 2, INT8_PV ? 1 : 0};
      sm90::produce(ld, lay, smem, bars, q0, bh);
    }
  } else {  // the consumers (csrc/attention_sm90.cuh), O / l out as bf16
    sm90::setmaxnreg_inc<sm90::kConsumerRegs>();
    bf16* out = a.out + (size_t)bh * a.n * a.d;
    sm90::s8_two_pass_consumers<INT8_PV, float>(
        lay, smem, bars, q0, a.n, a.m, a.d, a.sscale, a.oscale, [&](int row, int col, float x0, float x1) {
          *reinterpret_cast<uint32_t*>(out + (size_t)row * a.d + col) = pack_bf16(x0, x1);
        });
  }
}

// V^T in key_order for the int8 P V (sm90::values_t_block), V contiguous.
__global__ void __launch_bounds__(256) values_t_kernel(const int8_t* v, int8_t* vt, int m, int mp, int d) {
  sm90::values_t_block(v, vt, m, mp, d, d, 1);
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

template <bool INT8_PV>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int n, int m, int mp, int d, float sscale,
           float oscale, cudaStream_t stream) {
  const sm90::Layout lay = sm90::s8_layout(d, INT8_PV);
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
