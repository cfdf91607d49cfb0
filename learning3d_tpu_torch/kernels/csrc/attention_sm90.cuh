// Hopper (sm_90a) pieces of the two-pass attention kernels, K6
// (attention.cu) and K10 (attention_int8.cu): mbarriers and a ring of them,
// 3-D TMA tile loads and the producer that issues them, wgmma shared-memory
// descriptors and the m64n{64,128} products with their fence, commit and
// wait, register rebalancing, and the host's tensor-map encoding.
//
// Shared-memory tiles. Every operand tile is made of TMA boxes of 128-byte
// rows (64 bf16 or 128 int8 values) stored with the 128-byte swizzle, 1024
// bytes to each 8-row atom, which is the layout wgmma reads through a
// descriptor of layout type 1 (128B swizzle):
// * K-major operands (Q and K for Q K^T; V^T for the int8 P V): rows are
//   the M or N index, 128 bytes of the contracted index each; a wider
//   contracted index is several boxes, one after the other. SBO = 1024 (8
//   rows), LBO unused; a k-step of 32 bytes adds 2 to the descriptor.
// * MN-major operands (V for the bf16 P V, with the transpose bit): rows
//   are keys (the contracted index), 128 bytes of output columns each; the
//   second 64 columns are the next box, LBO bytes on. SBO = 1024 (8 keys);
//   a k-step of 16 keys adds 16 * 128 bytes.
// Boxes start on 1024-byte boundaries, so the hardware's swizzle (address
// bits 4-6 XOR bits 7-9) is the same for TMA's writes and wgmma's reads.
//
// The tensor maps are 3-D, (columns, rows, batch-head): TMA fills a box's
// rows past the end of one head with zeros instead of reading the next
// head's rows, and columns past the width with zeros.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRowBytes = 128;       // a box row, a swizzle row
constexpr int kRowsQ = 128;          // query rows a block: two consumer warpgroups of 64
constexpr int kThreads = 384;        // two consumer warpgroups, one producer warpgroup
constexpr int kConsumerWarps = 8;
constexpr int kSlab = 128;           // output columns a pass-2 slab
constexpr int kMaxSmem = 232448;     // what a block may use on the H100
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 * 40 + 256 * 232 <= 65,536
constexpr int kConsumerRegs = 232;

// ---- shared memory -------------------------------------------------------

// Offsets of the Q tile, the K ring and the V ring in the (1024-aligned)
// dynamic shared memory, then the barriers: q_full, k_full[nk],
// k_empty[nk], v_full[nv], v_empty[nv].
struct Layout {
  int q_bytes, k_bytes, v_bytes;  // the Q tile, a K stage, a V stage
  int nk, nv;                     // stages of each ring
  __host__ __device__ int k_off(int s) const { return q_bytes + s * k_bytes; }
  __host__ __device__ int v_off(int s) const { return q_bytes + nk * k_bytes + s * v_bytes; }
  __host__ __device__ int bar_off() const { return q_bytes + nk * k_bytes + nv * v_bytes; }
  __host__ __device__ int total() const { return bar_off() + 8 * (1 + 2 * nk + 2 * nv) + 1024; }
};

// The deepest rings that fit: 3 K stages and 2 V stages where there is
// room (loads run up to two tiles ahead), fewer for wide D. The consumers
// hold two K tiles at once (one product in flight while the other is
// read), so the K ring has at least 2 stages; false if that does not fit.
inline bool choose_stages(Layout* l) {
  static const int kDepths[3][2] = {{3, 2}, {2, 2}, {2, 1}};
  for (const auto& d : kDepths) {
    l->nk = d[0];
    l->nv = d[1];
    if (l->total() <= kMaxSmem) return true;
  }
  return false;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A position in a ring of `n` stages: the stage and the parity of its
// current round. Consumers wait on full[stage] with `phase`; the producer
// waits on empty[stage] with `phase ^ 1`, which passes in the first round.
struct Ring {
  int n, stage;
  uint32_t phase;
  __device__ explicit Ring(int stages) : n(stages), stage(0), phase(0) {}
  __device__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The barriers after the rings: q_full, k_full[nk], k_empty[nk],
// v_full[nv], v_empty[nv]. A full barrier takes the producer's one arrival
// and the TMA bytes; an empty barrier one arrival from each consumer warp.
struct Bars {
  uint64_t *q_full, *k_full, *k_empty, *v_full, *v_empty;
  __device__ Bars(uint8_t* smem, const Layout& l)
      : q_full(reinterpret_cast<uint64_t*>(smem + l.bar_off())),
        k_full(q_full + 1),
        k_empty(k_full + l.nk),
        v_full(k_empty + l.nk),
        v_empty(v_full + l.nv) {}
  // by one thread, before the block's __syncthreads()
  __device__ void init(const Layout& l) const {
    bar_init(q_full, 1);
    for (int s = 0; s < l.nk; ++s) {
      bar_init(k_full + s, 1);
      bar_init(k_empty + s, kConsumerWarps);
    }
    for (int s = 0; s < l.nv; ++s) {
      bar_init(v_full + s, 1);
      bar_init(v_empty + s, kConsumerWarps);
    }
    bar_fence_init();
  }
};

// A consumer warp's release of a stage it has finished reading: one
// arrival a warp (the empty barriers count kConsumerWarps).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// The two consumer warpgroups take turns at issuing their products (FA3's
// ping-pong): warpgroup w waits on named barrier 1 + w before it issues and
// arrives on the other's barrier after, so that one warpgroup's
// exponentials run while the other's products are on the tensor cores
// instead of both doing the same thing at the same time. Warpgroup 1 opens
// with an arrival on barrier 1 and warpgroup 0 closes with a wait on it, so
// every arrival is matched.
struct PingPong {
  int mine, other;
  __device__ explicit PingPong(int wg) : mine(1 + wg), other(2 - wg) {}
  __device__ void turn() const { asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory"); }
  __device__ void pass() const { asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory"); }
  __device__ void open() const {
    if (mine == 2) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  }
  __device__ void close() const {
    if (mine == 1) turn();
  }
};

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// What the producer loads, in the order the consumers use it: the block's
// Q tile; pass 1's K tiles; then for every slab of output columns, each K
// tile and its V tile.
struct Loads {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  int qk_boxes;   // boxes across D for a Q or K tile
  int qk_width;   // elements a box row
  int tile_k, ntiles, nslabs;
  int v_boxes;    // boxes a V tile (1 for V^T: a box is 128 keys x the slab's 128 columns)
  int v_keys_inner;  // V tile coordinates (key, column): V^T; else (column, key): V
};

__device__ __forceinline__ void produce(const Loads& ld, const Layout& lay, uint8_t* smem, const Bars& bars, int q0,
                                        int bh) {
  uint64_t *q_full = bars.q_full, *k_full = bars.k_full, *k_empty = bars.k_empty;
  uint64_t *v_full = bars.v_full, *v_empty = bars.v_empty;
  bar_expect_tx(q_full, lay.q_bytes);
  for (int b = 0; b < ld.qk_boxes; ++b)
    tma_load_3d(smem + b * kRowsQ * kRowBytes, ld.q, q_full, b * ld.qk_width, q0, bh);
  Ring kr(lay.nk), vr(lay.nv);
  const int k_box = lay.k_bytes / ld.qk_boxes, v_box = lay.v_bytes / ld.v_boxes;
  auto load_k = [&](int t) {
    bar_wait(k_empty + kr.stage, kr.phase ^ 1u);
    bar_expect_tx(k_full + kr.stage, lay.k_bytes);
    uint8_t* dst = smem + lay.k_off(kr.stage);
    for (int b = 0; b < ld.qk_boxes; ++b)
      tma_load_3d(dst + b * k_box, ld.k, k_full + kr.stage, b * ld.qk_width, t * ld.tile_k, bh);
    kr.next();
  };
  for (int t = 0; t < ld.ntiles; ++t) load_k(t);
  for (int s = 0; s < ld.nslabs; ++s) {
    for (int t = 0; t < ld.ntiles; ++t) {
      load_k(t);
      bar_wait(v_empty + vr.stage, vr.phase ^ 1u);
      bar_expect_tx(v_full + vr.stage, lay.v_bytes);
      uint8_t* dst = smem + lay.v_off(vr.stage);
      const int col0 = s * kSlab;
      for (int b = 0; b < ld.v_boxes; ++b) {
        if (ld.v_keys_inner)
          tma_load_3d(dst + b * v_box, ld.v, v_full + vr.stage, t * ld.tile_k, col0 + b * kSlab, bh);
        else
          tma_load_3d(dst + b * v_box, ld.v, v_full + vr.stage, col0 + b * 64, t * ld.tile_k, bh);
      }
      vr.next();
    }
  }
}

// ---- wgmma ---------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading byte offset (MN-major: between 64-column boxes; K-major: unused,
// 16) and stride byte offset (1024: between 8-row atoms), all >> 4.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The accumulator operand lists: d[0..n) as "+f" or "+r".
#define L3D_ACC4(C, i) C(d[i]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3])
#define L3D_ACC16(C, i) L3D_ACC4(C, i), L3D_ACC4(C, (i) + 4), L3D_ACC4(C, (i) + 8), L3D_ACC4(C, (i) + 12)
#define L3D_ACC64(C) L3D_ACC16(C, 0), L3D_ACC16(C, 16), L3D_ACC16(C, 32), L3D_ACC16(C, 48)
#define L3D_D64                                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 128,
// K-major), bf16. `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_bf16_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " L3D_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : L3D_ACC64("+f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16 bf16 from registers, the mma A-fragment
// layout) B (16 x 128 bf16, MN-major: the transpose bit).
__device__ __forceinline__ void mma_bf16_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " L3D_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : L3D_ACC64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, s32) (+)= A (64 x 32 int8, K-major in shared memory) B (32 x
// 128 int8, K-major).
__device__ __forceinline__ void mma_s8_ss_n128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " L3D_D64 ", %64, %65, p;\n}\n"
      : L3D_ACC64("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, s32) += A (64 x 32 int8 from registers) B (32 x 128 int8,
// K-major).
__device__ __forceinline__ void mma_s8_rs_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " L3D_D64 ", {%64, %65, %66, %67}, %68, p;\n}\n"
      : L3D_ACC64("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ---- host ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links without -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 3-D map of a row-major (d2, d1, d0) tensor of `elem`-byte values, read
// in boxes of box1 rows x box0 values (box0 * elem == 128), 128-byte
// swizzle, zeros past every edge. Returns a CUDA error code (0 on success).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int d0, int d1, int d2,
                    int box0, int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (static_cast<int64_t>(d0) * elem) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1), static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * elem, static_cast<cuuint64_t>(d0) * d1 * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1u};
  const cuuint32_t step[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
