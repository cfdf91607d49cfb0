// Hopper (sm_90a) pieces of the two-pass attention kernels, K6
// (attention.cu), K10 (attention_int8.cu) and K11's attention
// (transformer_int8.cu), of K11's int8 GEMM, of K1's and K2's fused
// PointNet chains (pointnet_fused.cu, pointnet_int8.cu), of the DGCNN chains, K5's bf16
// (dgcnn_fused.cu) and K9's int8 (dgcnn_int8.cu), and of K3's pooled
// statistics (poolgrad.cu):
// mbarriers and a ring of them, 3-D and 4-D TMA
// tile loads and the producer that issues them, bulk copies, wgmma
// shared-memory descriptors and the m64n{64,128,256} products with their fence,
// commit and wait, register rebalancing, K10's int8 two-pass consumers
// (shared with K11's int8 P.V instance) and V^T in key_order, and the
// host's tensor-map encoding.
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
// head's rows, and columns past the width with zeros. K11 reads its heads
// in place from a projection buffer (rows of stride ld, head h at columns h
// d_k) through 4-D head maps (columns, head, rows, batch; HeadMap), which
// give zeros past one item's rows in the same way.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A plain (non-tensor) bulk copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global to shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads), before a barrier that the readers pass.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a Q or K tile: columns `col` on, rows `row` on, of batch-head
// `bh`. With heads == 0 the map is 3-D (columns, rows, batch-head); with
// heads > 0 it is a head map (make_head_map: columns, head, rows, batch),
// which reads head bh % heads of item bh / heads in place.
__device__ __forceinline__ void tma_load_head(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row,
                                              int bh, int heads) {
  if (heads > 0)
    tma_load_4d(dst, map, bar, col, bh % heads, row, bh / heads);
  else
    tma_load_3d(dst, map, bar, col, row, bh);
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
  int heads = 0;     // > 0: Q and K are head maps (tma_load_head); V is 3-D either way
};

__device__ __forceinline__ void produce(const Loads& ld, const Layout& lay, uint8_t* smem, const Bars& bars, int q0,
                                        int bh) {
  uint64_t *q_full = bars.q_full, *k_full = bars.k_full, *k_empty = bars.k_empty;
  uint64_t *v_full = bars.v_full, *v_empty = bars.v_empty;
  bar_expect_tx(q_full, lay.q_bytes);
  for (int b = 0; b < ld.qk_boxes; ++b)
    tma_load_head(smem + b * kRowsQ * kRowBytes, ld.q, q_full, b * ld.qk_width, q0, bh, ld.heads);
  Ring kr(lay.nk), vr(lay.nv);
  const int k_box = lay.k_bytes / ld.qk_boxes, v_box = lay.v_bytes / ld.v_boxes;
  auto load_k = [&](int t) {
    bar_wait(k_empty + kr.stage, kr.phase ^ 1u);
    bar_expect_tx(k_full + kr.stage, lay.k_bytes);
    uint8_t* dst = smem + lay.k_off(kr.stage);
    for (int b = 0; b < ld.qk_boxes; ++b)
      tma_load_head(dst + b * k_box, ld.k, k_full + kr.stage, b * ld.qk_width, t * ld.tile_k, bh, ld.heads);
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

#define L3D_D32                                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major), bf16.
__device__ __forceinline__ void mma_bf16_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " L3D_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : L3D_ACC16("+f", 0), L3D_ACC16("+f", 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, M-major in shared memory: the transpose
// bit) B (16 x 64, N-major: the transpose bit), bf16: both operands stored
// with the contracted index along rows of 128 bytes (K3's Gram matrix of an
// x tile, x^T x).
__device__ __forceinline__ void mma_bf16_ss_n64_tt(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " L3D_D32 ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : L3D_ACC16("+f", 0), L3D_ACC16("+f", 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16 bf16 from registers, the mma A-fragment
// layout) B (16 x 64 bf16, K-major).
__device__ __forceinline__ void mma_bf16_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " L3D_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : L3D_ACC16("+f", 0), L3D_ACC16("+f", 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16 bf16 from registers) B (16 x 128 bf16,
// K-major).
__device__ __forceinline__ void mma_bf16_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " L3D_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : L3D_ACC64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
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

#define L3D_ACC128(C) L3D_ACC64(C), L3D_ACC16(C, 64), L3D_ACC16(C, 80), L3D_ACC16(C, 96), L3D_ACC16(C, 112)
#define L3D_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x 256, s32) (+)= A (64 x 32 int8, K-major in shared memory) B (32 x
// 256 int8, K-major): K2's stage 5, 256 points a product.
__device__ __forceinline__ void mma_s8_ss_n256(int (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " L3D_D128 ", %128, %129, p;\n}\n"
      : L3D_ACC128("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, s32) (+)= A (64 x 32 int8, K-major in shared memory) B (32 x 64
// int8, K-major).
__device__ __forceinline__ void mma_s8_ss_n64(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : L3D_ACC16("+r", 0), L3D_ACC16("+r", 16)
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

// d (64 x 64, s32) (+)= A (64 x 32 int8 from registers) B (32 x 64 int8,
// K-major).
__device__ __forceinline__ void mma_s8_rs_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " L3D_D32 ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : L3D_ACC16("+r", 0), L3D_ACC16("+r", 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 32, s32) (+)= A (64 x 32 int8 from registers) B (32 x 32 int8,
// K-major).
__device__ __forceinline__ void mma_s8_rs_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : L3D_ACC16("+r", 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// ---- the int8 two-pass attention's consumers (K10; K11 with int8 P.V) ----

constexpr int kS8TileK = 128;  // keys a tile: 128 int8 keys are one swizzle row of V^T

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Issues the warpgroup's 64 x 128 int32 scores S = Q K^T: `boxes`
// 128-wide column boxes of Q (this warpgroup's 64 rows) and of the K tile,
// four k-steps of 32 each. The caller commits the wgmma group and waits for it.
__device__ __forceinline__ void s8_issue_scores(int (&s)[64], const uint8_t* sq, const uint8_t* sk, int boxes) {
  fence_operands(s);
  wgmma_fence();
  for (int b = 0; b < boxes; ++b) {
    const uint64_t da = desc_sw128(sq + b * kRowsQ * kRowBytes, 16);
    const uint64_t db = desc_sw128(sk + b * kS8TileK * kRowBytes, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_s8_ss_n128(s, da + 2 * kk, db + 2 * kk, b > 0 || kk > 0);
  }
}

// The running integer max of rows g and g + 8 over a tile's scores. Only
// the last tile is MASKED: there `left` is how many of its columns from
// this thread's first (2 tq) on lie before M.
template <bool MASKED>
__device__ __forceinline__ void s8_tile_max(int (&mx)[2], const int (&s)[64], int left) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = max(mx[(i >> 1) & 1], !MASKED || 8 * (i >> 2) + (i & 1) < left ? s[i] : INT_MIN);
}

// p = expf(float(s) * sscale - m), in place (s then holds p's bits), and
// l += p, in LSum (float, or double: exact for every p). Branch-free: in the
// MASKED last tile a column past M gets the argument -inf, and expf gives
// exactly 0 (a branch around each expf would serialize them).
template <bool MASKED, typename LSum>
__device__ __forceinline__ void s8_tile_exp(int (&s)[64], LSum (&l)[2], const float (&m)[2], float sscale,
                                            int left) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    const float x = __fsub_rn(__fmul_rn(__int2float_rn(s[i]), sscale), m[h]);
    const float p = expf(!MASKED || 8 * (i >> 2) + (i & 1) < left ? x : -INFINITY);
    l[h] += static_cast<LSum>(p);
    s[i] = __float_as_int(p);
  }
}

// P (the bits of p, from s8_tile_exp) as wgmma A fragments. int8: round(127
// p) to nearest even on the FP32 pipe (127 p is in [0, 127]; adding 1.5 *
// 2^23 rounds it to an integer that the low byte of the sum's bits then
// holds, where the F2I unit does 16 a clock an SM), four keys a register in
// the fragment's k order: of the 32-key chunk c, accumulators 16c + {0, 1,
// 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15} (see key_order in
// kernels/attention.py). bf16: k-step kk takes accumulators 8 kk .. 8 kk +
// 7, the A-fragment layout.
template <bool INT8_PV>
__device__ __forceinline__ void s8_pack_p(uint32_t (&pa)[8][4], const int (&p)[64]) {
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

// The two consumer warpgroups of the int8 two-pass attention (K10's design,
// csrc/attention_int8.cu), rows q0 + 64 wg + [0, 64) of a block of n query
// rows against m keys of width d: pass 1 the exact row max, an integer max
// of the accumulators, converted and scaled once; pass 2, per 128-column
// slab, p = expf(s - m), l = sum(p) in LSum, O += P V (INT8_PV: int8 wgmma
// on V^T in key_order; else bf16 wgmma on bf16 V), one wgmma group a tile,
// tile t's P V and tile t + 1's scores, whose exponentials follow while the
// other warpgroup's group runs. Then store(row, col, x0, x1) takes O / l,
// x = (acc * oscale) / l, for columns col and col + 1 of each row below n.
template <bool INT8_PV, typename LSum, typename Store>
__device__ __forceinline__ void s8_two_pass_consumers(const Layout& lay, uint8_t* smem, const Bars& bars, int q0,
                                                      int n, int m, int d, float sscale, float oscale,
                                                      const Store& store) {
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int boxes = d / 128, ntiles = (m + kS8TileK - 1) / kS8TileK;
  const uint8_t* sq = smem + wg * 64 * kRowBytes;
  Ring kr(lay.nk), vr(lay.nv);
  const PingPong turns(wg);
  int s[64];
  // waits for the next K tile and issues its scores into s
  auto issue = [&]() {
    bar_wait(bars.k_full + kr.stage, kr.phase);
    s8_issue_scores(s, sq, smem + lay.k_off(kr.stage), boxes);
  };
  // after the wait: frees that K tile
  auto retire = [&]() {
    fence_operands(s);
    release(bars.k_empty + kr.stage, lane);
    kr.next();
  };
  const int left0 = m - 2 * tq;  // tile t: left0 - t kS8TileK
  bar_wait(bars.q_full, 0);
  turns.open();

  // pass 1: the exact row max (rows g and g + 8 of the warp's 16)
  int imx[2] = {INT_MIN, INT_MIN};
  for (int t = 0; t < ntiles; ++t) {
    turns.turn();
    issue();
    wgmma_commit();
    turns.pass();
    wgmma_wait<0>();
    retire();
    if ((t + 1) * kS8TileK <= m)
      s8_tile_max<false>(imx, s, 0);
    else
      s8_tile_max<true>(imx, s, left0 - t * kS8TileK);
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 1));
    imx[h] = max(imx[h], __shfl_xor_sync(0xffffffffu, imx[h], 2));
    mx[h] = __fmul_rn(__int2float_rn(imx[h]), sscale);
  }

  // pass 2, per 128-column slab
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  for (int v0 = 0; v0 < d; v0 += kSlab) {
    int oi[64];
    float of[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      oi[i] = 0;
      of[i] = 0.f;
    }
    LSum l[2] = {0, 0};
    uint32_t pa[8][4];
    turns.turn();
    issue();
    wgmma_commit();
    turns.pass();
    wgmma_wait<0>();
    retire();
    if (kS8TileK <= m)
      s8_tile_exp<false>(s, l, mx, sscale, 0);
    else
      s8_tile_exp<true>(s, l, mx, sscale, left0);
    s8_pack_p<INT8_PV>(pa, s);
    for (int t = 0; t < ntiles; ++t) {
      const bool more = t + 1 < ntiles;
      turns.turn();
      bar_wait(bars.v_full + vr.stage, vr.phase);
      const uint8_t* sv = smem + lay.v_off(vr.stage);
      if constexpr (INT8_PV) {
        fence_operands(oi);
        wgmma_fence();
        const uint64_t desc_v = desc_sw128(sv, 16);  // V^T: K-major, 128 rows of 128 keys
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_s8_rs_n128(oi, pa[c], desc_v + 2 * c, 1);
      } else {
        fence_operands(of);
        wgmma_fence();
        const uint64_t desc_v = desc_sw128(sv, kS8TileK * kRowBytes);  // V: MN-major
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) mma_bf16_rs_n128_mn(of, pa[kk], desc_v + 128 * kk, 1);
      }
      if (more) issue();
      wgmma_commit();
      turns.pass();
      wgmma_wait<0>();
      if constexpr (INT8_PV)
        fence_operands(oi);
      else
        fence_operands(of);
      release(bars.v_empty + vr.stage, lane);
      vr.next();
      if (more) {
        retire();
        if ((t + 2) * kS8TileK <= m)
          s8_tile_exp<false>(s, l, mx, sscale, 0);
        else
          s8_tile_exp<true>(s, l, mx, sscale, left0 - (t + 1) * kS8TileK);
        s8_pack_p<INT8_PV>(pa, s);
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
      if (row >= n) continue;
      const float lf = static_cast<float>(l[h]);  // rounded once (a no-op for float)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float acc = INT8_PV ? __int2float_rn(oi[i]) : of[i];
          x[e] = __fdiv_rn(__fmul_rn(acc, oscale), lf);
        }
        store(row, v0 + 8 * j + 2 * tq, x[0], x[1]);
      }
    }
  }
  turns.close();
}

// The int8 two-pass attention's shared memory at head width d: the Q tile,
// K tiles, and V tiles of V^T (int8 P V) or of bf16 V (hybrid).
inline Layout s8_layout(int d, bool int8_pv) {
  const int boxes = d / 128;
  Layout lay{boxes * kRowsQ * kRowBytes, boxes * kS8TileK * kRowBytes, (int8_pv ? 1 : 2) * kS8TileK * kRowBytes, 0,
             0};
  choose_stages(&lay);
  return lay;
}

// V as the int8 P V reads it, made before the attention kernel in one pass
// over V: V^T (batch * heads, d, Mp), its keys in key_order (position 16h +
// 4t + i of a 16-key group holds key 16h + 2t + i for i < 2, 16h + 8 + 2t +
// i - 2 for i >= 2) and zero past M. V is read in place: head h of item b
// is columns h d .. of rows b m .. of stride ldv (K10: ldv = d, heads = 1).
// A 64-key x 64-column tile a block of 256 threads, grid (Mp / 64, d / 64,
// batch * heads), read and written 16 bytes a thread through shared memory.
__device__ __forceinline__ void values_t_block(const int8_t* v, int8_t* vt, int m, int mp, int d, int ldv,
                                               int heads) {
  __shared__ int8_t tile[64][64 + 16];
  const int k0 = blockIdx.x * 64, c0 = blockIdx.y * 64, bh = blockIdx.z;
  const int item = bh / heads, head = bh - item * heads;
  const int8_t* src = v + (size_t)item * m * ldv + (size_t)head * d;
  {
    const int key = threadIdx.x >> 2, part = threadIdx.x & 3;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + key < m) w = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + key) * ldv + c0 + 16 * part);
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

// A tiled map of `rank` dimensions: `dims` innermost first, `strides` the
// byte strides of dimensions 1 .. rank - 1 (multiples of 16), `box` in
// elements; zeros past every edge. Returns a CUDA error code (0 on success).
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t step[5] = {1u, 1u, 1u, 1u, 1u};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 3-D map of a row-major (d2, d1, d0) tensor of `elem`-byte values, read
// in boxes of box1 rows x box0 values (box0 * elem == 128), 128-byte
// swizzle, zeros past every edge. Returns a CUDA error code (0 on success).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int d0, int d1, int d2,
                    int box0, int box1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1), static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * elem, static_cast<cuuint64_t>(d0) * d1 * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1u};
  return encode_map(map, type, 3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The geometry of a head map: an int8 projection buffer (batch, rows, ld)
// whose head h of width dk lies at columns h dk on from `base`, read as a
// 4-D tensor (columns dk, head, rows, batch) with byte strides (dk, ld, rows
// ld), in boxes of 128 columns x box_rows rows of one head and item: TMA
// gives zeros past `rows` of one item (never the next item's rows) and never
// reads another head's columns. kernels/transformer_int8.py::head_map
// states the same geometry for the CPU tests.
struct HeadMap {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  HeadMap(int dk, int heads, int rows, int batch, int ld, int box_rows)
      : dims{static_cast<cuuint64_t>(dk), static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
             static_cast<cuuint64_t>(batch)},
        strides{static_cast<cuuint64_t>(dk), static_cast<cuuint64_t>(ld),
                static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(ld)},
        box{128u, 1u, static_cast<cuuint32_t>(box_rows), 1u} {}
};

inline int make_head_map(CUtensorMap* map, const void* base, const HeadMap& h, CUtensorMapSwizzle swizzle) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, h.dims, h.strides, h.box, swizzle);
}

}  // namespace sm90
