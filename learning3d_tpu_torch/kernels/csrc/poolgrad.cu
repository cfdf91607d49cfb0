// The train-mode fused PointNet tail for Hopper (sm_90a): K3, the forward
// statistics of conv5 + BatchNorm + ReLU + max-pool, and K4, its sparse
// max-pool backward.
//
// K3 replaces learning3d_tpu/kernels/poolgrad.py::pool_stats_pallas (body
// `_stats_kernel`). x (B, N, 128) and W (128, E), both bf16 or both f32, and
// c (E) f32 in; z = x W + c is never written. Out: per (cloud, channel) the
// max, min, argmax and argmin of z over the points (f32, f32, int32, int32;
// ties go to the smaller point index), the 128 x 128 Gram matrix
// G = sum over all B*N rows of x x^T and the column sum of x, both f32.
// Same math as the port's plain version `pool_stats_reference`: bf16
// operands multiply exactly into f32 sums; the bias is added before the
// comparisons, as the TPU kernel adds it.
//
// K4 replaces poolgrad.py::pool_bwd_pallas (body `_scatter_kernel`). idx
// (B, E) int32, dsel (B, E) f32, W (as W^T, (E, 128)) and x (B, N, 128) in;
// dx_sp (B, N, 128) f32 with dx_sp[b, idx[b,e], :] += r(dsel[b,e]) W[:, e],
// every untouched row 0, and dW_sel (as its transpose (E, 128)) f32 with
// dW_sel[:, e] = sum_b x[b, idx[b,e], :] dsel[b,e]. r rounds to bf16 when W
// is bf16 (the TPU kernel casts its one-hot tile to bf16 for that product)
// and is the identity for f32; the dW products take dsel in f32.
// `pool_bwd_reference` is the plain version.
//
// Bound (bench.py's training step: B=256, N=1024, K=128, E=1024, bf16).
// K3: z is 2 * 262,144 * 128 * 1024 = 68.7 GFLOP and G 8.6 GFLOP, 78 us at
// the dense bf16 tensor-core peak (989 TFLOP/s); x is 64 MiB, 20 us at
// 3.35 TB/s. Bound by operations. K4: dx_sp is 128 MiB written and at most
// 64 MiB of x is read, 60 us; its operations are 2 * B * E * 128 * 2 =
// 0.13 GFLOP. Bound by bytes.
//
// K3 design (simple: mma.sync from shared memory; wgmma and TMA later).
// * The TPU walks a cloud's point tiles in order and carries the running
//   max and the Gram sum across grid steps. Here each block walks its
//   cloud's points itself, in tiles of 64 rows, and keeps the running
//   max/min/argmax/argmin in registers. Grid (E / 128 + 1, B): blocks
//   0..E/128-1 of a cloud each own 128 output channels (their W slice
//   stays in shared memory as W^T); the last block of a cloud computes the
//   cloud's Gram matrix and column sum. The Gram block does 128 x 128 x N
//   multiply-adds, as many as a channel block, so the blocks are even. The
//   channel index varies fastest, so the nine blocks of a cloud run
//   together and read x once from device memory, eight more times from L2.
// * z: warp w takes rows 32 (w / 4) .. +31 of the tile and channels
//   32 (w % 4) .. +31: mma.sync.m16n8k16 bf16 -> f32, A fragments read
//   once per tile, each B fragment feeding two m-tiles. The epilogue adds
//   c and folds each value into the running max/min with its point index;
//   a thread sees its points in increasing order, so a strict > keeps the
//   first index. At the end the lanes and the two row halves are combined
//   with (value, index) order: the larger value, on a tie the smaller
//   index.
// * Gram: warp w owns rows 16w..16w+15 of G, all 128 columns (16 mma
//   tiles, 64 f32 accumulators). A = x^T and B = x both come from the
//   row-major x tile through ldmatrix.trans.
// * G and the column sum are sums over every cloud. Each Gram block writes
//   its cloud's partial (B x 64 KiB of scratch), and a second kernel sums
//   the partials over b in index order: deterministic, no float atomics.
// * f32 x and W: both are split into bf16 hi + lo in shared memory and
//   every product is hi*hi + hi*lo + lo*hi (the TPU kernel's `_dot3`
//   split), about 2^-16 of the exact product: one m-tile at a time to keep
//   the registers in bounds. The column sum reads the f32 values, exact.
// * The next tile is loaded into registers while the tensor cores work on
//   this one. Rows past N are loaded as 0 and left out of the max/min.
//
// K4 design. The TPU builds (idx == row) one-hot tiles and multiplies them
// on the MXU; here the scatter is a sort.
// * dx (grid B, 8 warps): the block sorts its cloud's (idx << 12 | e) keys
//   with a bitonic sort in shared memory, so each point's channels form one
//   run in ascending e. Warp w writes rows w, w + 8, ...: a binary search
//   finds the row's run, lane l sums columns 4l..4l+3 over the run in
//   ascending e (f32 fma), and the 512-byte row is written whole, zeros
//   where the run is empty. Duplicates (many channels picking one critical
//   point, the normal case) are summed in a fixed order, no atomics.
// * dW (grid E / 8, a warp per channel e): lane l sums columns 4l..4l+3 of
//   x[b, idx[b,e], :] dsel[b,e] over b = 0..B-1 in order, eight rows in
//   flight at a time. It writes dW_sel^T (E, 128); the wrapper hands back
//   its transpose.
// * Indices outside [0, N) contribute nothing and write nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kK = 128;         // input channels: the PointNet tail's conv5 width
constexpr int kTile = 64;       // points per tile
constexpr int kEG = 128;        // output channels per K3 channel block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kK + 8;     // padded shared-memory row (bf16), free of bank conflicts
constexpr int kMaxE = 4096;     // K4: e fits the low 12 bits of a sort key
constexpr int kReduceUnroll = 16;

__host__ __device__ constexpr int stats_smem_bytes(bool f32) {
  return (f32 ? 2 : 1) * 2 * (kEG + kTile) * kLd;  // W^T slice and x tile, hi (and lo)
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (value, index) order of the max: the larger value, on a tie the smaller index.
__device__ __forceinline__ bool beats_max(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ bool beats_min(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// A fragments (16 rows from m0, all 128 k) of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[kK / 16][4], const bf16* h, int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = h + (m0 + g) * kLd + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    a[kk][0] = ld32(p + kk * 16);
    a[kk][1] = ld32(p + 8 * kLd + kk * 16);
    a[kk][2] = ld32(p + kk * 16 + 8);
    a[kk][3] = ld32(p + 8 * kLd + kk * 16 + 8);
  }
}

// One tile of x, as this thread loads it: 16-byte chunks, kChunk elements
// each, neighbouring threads on neighbouring chunks of a row.
template <bool kF32>
struct TileLoad {
  static constexpr int kChunk = kF32 ? 4 : 8;
  static constexpr int kPerRow = kK / kChunk;
  static constexpr int kRowStep = kThreads / kPerRow;
  static constexpr int kPasses = kTile / kRowStep;
  uint4 v[kPasses];

  __device__ __forceinline__ void load(const void* x, size_t row0, int valid, int tid) {
    const int c = tid % kPerRow, r0 = tid / kPerRow;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = r0 + j * kRowStep;
      v[j] = r < valid ? reinterpret_cast<const uint4*>(x)[(row0 + r) * kPerRow + c]
                       : make_uint4(0, 0, 0, 0);
    }
  }

  // Into the bf16 tile (hi and, for f32, lo); with kSum, add each chunk's
  // values to this thread's column sums.
  template <bool kSum>
  __device__ __forceinline__ void store(bf16* hi, bf16* lo, float (&cs)[kChunk], int tid) const {
    const int c = tid % kPerRow, r0 = tid / kPerRow;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = r0 + j * kRowStep;
      if constexpr (kF32) {
        float f[4];
        memcpy(f, &v[j], 16);
        bf16 h[4], l[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[q] = __float2bfloat16_rn(f[q]);
          l[q] = __float2bfloat16_rn(f[q] - __bfloat162float(h[q]));
          if (kSum) cs[q] += f[q];
        }
        memcpy(hi + r * kLd + c * 4, h, 8);
        memcpy(lo + r * kLd + c * 4, l, 8);
      } else {
        *reinterpret_cast<uint4*>(hi + r * kLd + c * 8) = v[j];
        if (kSum) {
          bf16 h[8];
          memcpy(h, &v[j], 16);
#pragma unroll
          for (int q = 0; q < 8; ++q) cs[q] += __bfloat162float(h[q]);
        }
      }
    }
  }
};

struct StatsArgs {
  const void* x;    // (B, N, 128)
  const void* wt;   // W^T (E, 128)
  const float* c;   // (E,)
  float *mx, *mn;   // (B, E)
  int *amax, *amin; // (B, E)
  float* gpart;     // (B, 128, 128) per-cloud Gram partials
  float* cspart;    // (B, 128) per-cloud column sums
  int n, e;
};

// Running max/min/argmax/argmin of this thread's 8 channels.
struct Running {
  float mx[4][2], mn[4][2];
  int amax[4][2], amin[4][2];
};

// Fold the accumulators of one m-tile (rows p0 + m0 ..) into `run`.
__device__ __forceinline__ void fold(Running& run, const float (&acc)[4][4], const float (&cb)[4][2],
                                     int prow, int n_pts) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = prow + 8 * half;
    if (p >= n_pts) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[j][2 * half + e] + cb[j][e];
        if (v > run.mx[j][e]) { run.mx[j][e] = v; run.amax[j][e] = p; }
        if (v < run.mn[j][e]) { run.mn[j][e] = v; run.amin[j][e] = p; }
      }
  }
}

// The Gram block of a cloud: G partial and column sum over its points.
template <bool kF32>
__device__ __forceinline__ void gram_block(const StatsArgs& args, bf16* x_hi, bf16* x_lo, float* red) {
  constexpr int kChunk = TileLoad<kF32>::kChunk, kPerRow = TileLoad<kF32>::kPerRow;
  const int n_pts = args.n, cloud = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, ri = lane & 7;  // this lane's ldmatrix matrix and row
  float gacc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  float cs[kChunk];
#pragma unroll
  for (int q = 0; q < kChunk; ++q) cs[q] = 0.f;

  const size_t cloud_row = (size_t)cloud * n_pts;
  TileLoad<kF32> next;
  next.load(args.x, cloud_row, min(kTile, n_pts), tid);
  for (int p0 = 0; p0 < n_pts; p0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    next.template store<true>(x_hi, x_lo, cs, tid);
    __syncthreads();
    if (p0 + kTile < n_pts) next.load(args.x, cloud_row + p0 + kTile, min(kTile, n_pts - p0 - kTile), tid);
    // G[16w.., :] += x^T x over the tile's 64 rows: 4 k-steps of 16 points.
    // A = x^T: matrices (points 0-7, rows 0-7), (0-7, 8-15), (8-15, 0-7),
    // (8-15, 8-15); B = x: (0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
#pragma unroll 1
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const int pa = ks * 16 + ri + 8 * (mi >> 1), ca = warp * 16 + 8 * (mi & 1);
      const int pb = ks * 16 + ri + 8 * (mi & 1), cb = 8 * (mi >> 1);
      uint32_t a[4], al[4];
      ldmatrix_x4_trans(a, x_hi + pa * kLd + ca);
      if constexpr (kF32) ldmatrix_x4_trans(al, x_lo + pa * kLd + ca);
#pragma unroll
      for (int nt = 0; nt < 16; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x_hi + pb * kLd + nt * 8 + cb);
        mma_bf16(gacc[nt], a, b[0], b[1]);
        mma_bf16(gacc[nt + 1], a, b[2], b[3]);
        if constexpr (kF32) {
          uint32_t bl[4];
          ldmatrix_x4_trans(bl, x_lo + pb * kLd + nt * 8 + cb);
          mma_bf16(gacc[nt], a, bl[0], bl[1]);
          mma_bf16(gacc[nt + 1], a, bl[2], bl[3]);
          mma_bf16(gacc[nt], al, b[0], b[1]);
          mma_bf16(gacc[nt + 1], al, b[2], b[3]);
        }
      }
    }
  }

  float* gp = args.gpart + (size_t)cloud * kK * kK;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int r = warp * 16 + g, c = nt * 8 + 2 * t;
    gp[r * kK + c] = gacc[nt][0];
    gp[r * kK + c + 1] = gacc[nt][1];
    gp[(r + 8) * kK + c] = gacc[nt][2];
    gp[(r + 8) * kK + c + 1] = gacc[nt][3];
  }
  // Column sums: thread tid holds columns (tid % kPerRow) * kChunk ..; the
  // threads of one column are summed in the order of tid.
  __syncthreads();  // every warp is done with the last tile
#pragma unroll
  for (int q = 0; q < kChunk; ++q) red[tid * kChunk + q] = cs[q];
  __syncthreads();
  if (tid < kK) {
    const int c = tid / kChunk, q = tid % kChunk;
    float s = 0.f;
    for (int i = c; i < kThreads; i += kPerRow) s += red[i * kChunk + q];
    args.cspart[(size_t)cloud * kK + tid] = s;
  }
}

// A channel block: running max/min/argmax/argmin of z over the cloud's
// points for channels e0 .. e0 + 127.
template <bool kF32>
__device__ __forceinline__ void channel_block(const StatsArgs& args, bf16* wt_hi, bf16* x_hi, bf16* x_lo,
                                              unsigned char* red) {
  const int n_pts = args.n, e_total = args.e, cloud = blockIdx.y;
  const int e0 = blockIdx.x * kEG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* wt_lo = wt_hi + kEG * kLd;  // f32 only: the lo slice right after the hi slice
  {
    TileLoad<kF32> w;
    float unused[TileLoad<kF32>::kChunk];
    for (int r0 = 0; r0 < kEG; r0 += kTile) {
      w.load(args.wt, (size_t)e0 + r0, kTile, tid);
      w.template store<false>(wt_hi + r0 * kLd, wt_lo + r0 * kLd, unused, tid);
    }
  }

  const int rh = warp >> 2, cq = warp & 3;  // row half, channel quarter
  float cb[4][2];
  Running run;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cb[j][e] = args.c[e0 + cq * 32 + 8 * j + 2 * t + e];
      run.mx[j][e] = -INFINITY;
      run.mn[j][e] = INFINITY;
      run.amax[j][e] = run.amin[j][e] = 0;
    }

  const size_t cloud_row = (size_t)cloud * n_pts;
  const bf16* wq = wt_hi + (cq * 32 + g) * kLd + 2 * t;
  const int m0 = rh * 32;
  TileLoad<kF32> next;
  float unused[TileLoad<kF32>::kChunk];
  next.load(args.x, cloud_row, min(kTile, n_pts), tid);
  for (int p0 = 0; p0 < n_pts; p0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and W^T is in place)
    next.template store<false>(x_hi, x_lo, unused, tid);
    __syncthreads();
    if (p0 + kTile < n_pts) next.load(args.x, cloud_row + p0 + kTile, min(kTile, n_pts - p0 - kTile), tid);
    if constexpr (!kF32) {
      uint32_t a[2][kK / 16][4];
      load_a(a[0], x_hi, m0, lane);
      load_a(a[1], x_hi, m0 + 16, lane);
      float acc[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = ld32(wq + j * 8 * kLd + kk * 16);
          const uint32_t b1 = ld32(wq + j * 8 * kLd + kk * 16 + 8);
          mma_bf16(acc[0][j], a[0][kk], b0, b1);
          mma_bf16(acc[1][j], a[1][kk], b0, b1);
        }
      fold(run, acc[0], cb, p0 + m0 + g, n_pts);
      fold(run, acc[1], cb, p0 + m0 + 16 + g, n_pts);
    } else {
      const bf16* wql = wq + kEG * kLd;
#pragma unroll 1
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t ah[kK / 16][4], al[kK / 16][4];
        load_a(ah, x_hi, m0 + 16 * mi, lane);
        load_a(al, x_lo, m0 + 16 * mi, lane);
        float acc[4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = j * 8 * kLd + kk * 16;
            const uint32_t bh0 = ld32(wq + o), bh1 = ld32(wq + o + 8);
            const uint32_t bl0 = ld32(wql + o), bl1 = ld32(wql + o + 8);
            mma_bf16(acc[j], ah[kk], bh0, bh1);
            mma_bf16(acc[j], ah[kk], bl0, bl1);
            mma_bf16(acc[j], al[kk], bh0, bh1);
          }
        fold(run, acc, cb, p0 + m0 + 16 * mi + g, n_pts);
      }
    }
  }

  // Combine the 8 lanes of each channel pair, then the two row halves.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        const float omx = __shfl_xor_sync(0xffffffffu, run.mx[j][e], s);
        const int oax = __shfl_xor_sync(0xffffffffu, run.amax[j][e], s);
        const float omn = __shfl_xor_sync(0xffffffffu, run.mn[j][e], s);
        const int oan = __shfl_xor_sync(0xffffffffu, run.amin[j][e], s);
        if (beats_max(omx, oax, run.mx[j][e], run.amax[j][e])) { run.mx[j][e] = omx; run.amax[j][e] = oax; }
        if (beats_min(omn, oan, run.mn[j][e], run.amin[j][e])) { run.mn[j][e] = omn; run.amin[j][e] = oan; }
      }
  float* rmx = reinterpret_cast<float*>(red);  // [2][kEG] each
  float* rmn = rmx + 2 * kEG;
  int* rax = reinterpret_cast<int*>(rmn + 2 * kEG);
  int* ran = rax + 2 * kEG;
  __syncthreads();  // every warp is done reading W^T, whose memory `red` reuses
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = rh * kEG + cq * 32 + 8 * j + 2 * t + e;
        rmx[ch] = run.mx[j][e];
        rmn[ch] = run.mn[j][e];
        rax[ch] = run.amax[j][e];
        ran[ch] = run.amin[j][e];
      }
  }
  __syncthreads();
  if (tid < kEG) {
    float vx = rmx[tid], vn = rmn[tid];
    int ix = rax[tid], in = ran[tid];
    if (beats_max(rmx[kEG + tid], rax[kEG + tid], vx, ix)) { vx = rmx[kEG + tid]; ix = rax[kEG + tid]; }
    if (beats_min(rmn[kEG + tid], ran[kEG + tid], vn, in)) { vn = rmn[kEG + tid]; in = ran[kEG + tid]; }
    const size_t o = (size_t)cloud * e_total + e0 + tid;
    args.mx[o] = vx;
    args.mn[o] = vn;
    args.amax[o] = ix;
    args.amin[o] = in;
  }
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads, 1) pool_stats_kernel(StatsArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wt_hi = reinterpret_cast<bf16*>(smem);
  bf16* x_hi = wt_hi + (kF32 ? 2 : 1) * kEG * kLd;
  bf16* x_lo = x_hi + kTile * kLd;  // f32 only
  // The reductions at the end reuse the W^T slice's shared memory (the
  // Gram block has none; a channel block is past its last use there).
  unsigned char* red = smem;
  if (blockIdx.x == gridDim.x - 1)
    gram_block<kF32>(args, x_hi, x_lo, reinterpret_cast<float*>(red));
  else
    channel_block<kF32>(args, wt_hi, x_hi, x_lo, red);
}

// G = sum_b gpart[b], colsum = sum_b cspart[b], over b in index order.
__global__ void __launch_bounds__(kThreads) pool_stats_reduce(const float* gpart, const float* cspart,
                                                              float* G, float* colsum, int batch) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kK * kK + kK) return;
  const float* src = i < kK * kK ? gpart + i : cspart + (i - kK * kK);
  const size_t stride = i < kK * kK ? (size_t)kK * kK : (size_t)kK;
  float s = 0.f;
  for (int b0 = 0; b0 < batch; b0 += kReduceUnroll) {
    float v[kReduceUnroll];
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) v[u] = b0 + u < batch ? src[(b0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < kReduceUnroll; ++u) s += v[u];
  }
  if (i < kK * kK) G[i] = s; else colsum[i - kK * kK] = s;
}

// Four consecutive columns of a row of a bf16 or f32 matrix, as f32.
template <bool kF32>
__device__ __forceinline__ void load4(float (&f)[4], const void* base, size_t off) {
  if constexpr (kF32) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(base) + off);
    bf16 h[4];
    memcpy(h, &v, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = __bfloat162float(h[q]);
  }
}

// dx_sp of one cloud a block (see the header).
template <bool kF32>
__global__ void __launch_bounds__(kThreads) pool_bwd_dx_kernel(const int* idx, const float* dsel,
                                                               const void* wt, float* dx, int n_pts,
                                                               int e_total, int e_pow2) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);  // [e_pow2]
  float* coef = reinterpret_cast<float*>(keys + e_pow2);  // [e_total]
  const int cloud = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < e_pow2; e += kThreads) {
    uint32_t key = 0xffffffffu;
    if (e < e_total) {
      const int n = idx[(size_t)cloud * e_total + e];
      if (n >= 0 && n < n_pts) key = (static_cast<uint32_t>(n) << 12) | static_cast<uint32_t>(e);
      const float d = dsel[(size_t)cloud * e_total + e];
      coef[e] = kF32 ? d : __bfloat162float(__float2bfloat16_rn(d));
    }
    keys[e] = key;
  }
  __syncthreads();
  for (int k = 2; k <= e_pow2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < e_pow2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint32_t a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[ixj] = a; }
        }
      }
      __syncthreads();
    }

  float* out = dx + (size_t)cloud * n_pts * kK;
  for (int n = warp; n < n_pts; n += kWarps) {
    const uint32_t want = static_cast<uint32_t>(n) << 12;
    int lo = 0, hi = e_total;  // the first key >= want
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < want) lo = mid + 1; else hi = mid;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = lo; i < e_total; ++i) {
      const uint32_t key = keys[i];
      if ((key >> 12) != static_cast<uint32_t>(n)) break;
      const int e = key & 0xfff;
      float w[4];
      load4<kF32>(w, wt, (size_t)e * kK + 4 * lane);
      const float d = coef[e];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(d, w[q], acc[q]);
    }
    *reinterpret_cast<float4*>(out + (size_t)n * kK + 4 * lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// dW_sel^T (E, 128): warp w of block i owns channel e = 8 i + w.
template <bool kF32>
__global__ void __launch_bounds__(kThreads) pool_bwd_dw_kernel(const int* idx, const float* dsel,
                                                               const void* x, float* dwt, int batch,
                                                               int n_pts, int e_total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= e_total) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < batch; b0 += 8) {
    int my_n = -1;
    float my_d = 0.f;
    if (lane < 8 && b0 + lane < batch) {
      my_n = idx[(size_t)(b0 + lane) * e_total + e];
      my_d = dsel[(size_t)(b0 + lane) * e_total + e];
    }
    float v[8][4], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = __shfl_sync(0xffffffffu, my_n, u);
      d[u] = __shfl_sync(0xffffffffu, my_d, u);
      if (n >= 0 && n < n_pts) {
        load4<kF32>(v[u], x, ((size_t)(b0 + u) * n_pts + n) * kK + 4 * lane);
      } else {
        v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
        d[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(v[u][q], d[u], acc[q]);
  }
  *reinterpret_cast<float4*>(dwt + (size_t)e * kK + 4 * lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <bool kF32>
int launch_stats(const void* x, const void* wt, const float* c, float* mx, float* mn, int* amax,
                 int* amin, float* gpart, float* cspart, float* G, float* colsum, int batch, int n_pts,
                 int e_total, cudaStream_t stream) {
  const int bytes = stats_smem_bytes(kF32);
  cudaError_t err = cudaFuncSetAttribute(pool_stats_kernel<kF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  StatsArgs args{x, wt, c, mx, mn, amax, amin, gpart, cspart, n_pts, e_total};
  pool_stats_kernel<kF32><<<dim3(e_total / kEG + 1, batch), kThreads, bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_stats_reduce<<<(kK * kK + kK + kThreads - 1) / kThreads, kThreads, 0, stream>>>(gpart, cspart, G, colsum,
                                                                                      batch);
  return (int)cudaGetLastError();
}

template <bool kF32>
int launch_bwd(const int* idx, const float* dsel, const void* wt, const void* x, float* dx, float* dwt,
               int batch, int n_pts, int e_total, cudaStream_t stream) {
  int e_pow2 = 1;
  while (e_pow2 < e_total) e_pow2 <<= 1;
  const int bytes = 4 * (e_pow2 + e_total);
  cudaError_t err = cudaFuncSetAttribute(pool_bwd_dx_kernel<kF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  pool_bwd_dx_kernel<kF32><<<batch, kThreads, bytes, stream>>>(idx, dsel, wt, dx, n_pts, e_total, e_pow2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_bwd_dw_kernel<kF32><<<(e_total + kWarps - 1) / kWarps, kThreads, 0, stream>>>(idx, dsel, x, dwt, batch,
                                                                                    n_pts, e_total);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes. All pointers are device pointers to
// contiguous tensors; K = 128. Each returns the CUDA error code of its
// launches (0 on success).
//
// K3: x (B, N, 128) and wt = W^T (E, 128), both bf16 (is_f32 = 0) or both
// f32; c (E,) f32; out mx, mn (B, E) f32, amax, amin (B, E) int32, G
// (128, 128) f32, colsum (128,) f32; scratch gpart (B, 128, 128) and
// cspart (B, 128) f32. E % 128 == 0, N >= 1.
extern "C" int pool_stats(const void* x, const void* wt, const float* c, int is_f32, float* mx, float* mn,
                          int* amax, int* amin, float* gpart, float* cspart, float* G, float* colsum,
                          int batch, int n_pts, int e_total, void* stream) {
  if (batch <= 0 || batch > 65535 || n_pts <= 0 || e_total <= 0 || e_total % kEG != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_stats<true>(x, wt, c, mx, mn, amax, amin, gpart, cspart, G, colsum, batch, n_pts,
                                     e_total, s)
                : launch_stats<false>(x, wt, c, mx, mn, amax, amin, gpart, cspart, G, colsum, batch, n_pts,
                                      e_total, s);
}

// K4: idx (B, E) int32, dsel (B, E) f32, wt = W^T (E, 128) and x (B, N, 128)
// both bf16 (is_f32 = 0) or both f32; out dx (B, N, 128) f32 and dwt =
// dW_sel^T (E, 128) f32. E <= 4096, N < 2^20.
extern "C" int pool_bwd(const int* idx, const float* dsel, const void* wt, const void* x, int is_f32,
                        float* dx, float* dwt, int batch, int n_pts, int e_total, void* stream) {
  if (batch <= 0 || n_pts <= 0 || n_pts >= (1 << 20) || e_total <= 0 || e_total > kMaxE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_bwd<true>(idx, dsel, wt, x, dx, dwt, batch, n_pts, e_total, s)
                : launch_bwd<false>(idx, dsel, wt, x, dx, dwt, batch, n_pts, e_total, s);
}
