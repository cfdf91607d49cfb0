// Farthest-point sampling for Hopper (sm_90a). xyz (B, N, 3) f32 and start
// (B,) int32 in; idx (B, npoint) int32 out: idx[b, 0] = start[b], then each
// next pick is the point whose distance to the picks so far is largest, the
// first (smallest index) of equal maxima.
//
// Replaces the TPU kernel learning3d_tpu/kernels/sampling.py::fps_pallas
// (body `_fps_kernel`). Same math as the port's plain version
// `fps_reference`, every operation rounded on its own (__fsub_rn/__fmul_rn/
// __fadd_rn, so that nvcc cannot contract a product and a sum into one FMA,
// which would move a near-tied pick):
//   dist[i] starts at 1e10; at every step, with c the current pick,
//   d = ((x - cx)^2 + (y - cy)^2) + (z - cz)^2, dist[i] = min(dist[i], d),
//   the next pick is argmax(dist), ties to the smaller index.
// Once every point has been picked, dist is 0 everywhere and the picks
// repeat the first index whose dist is 0, as the TPU kernel's do.
//
// Bound. A step does ~10 f32 operations a point (3 differences, 3 products,
// 2 sums, the min and the comparison of the argmax): at FlowNet3D's widest
// call (B=16, N=2048, npoint=1024) 0.34 G operations, 0.005 ms at 67
// TFLOP/s; the bytes (the points once, the indices once) are 0.46 MB,
// 0.0001 ms. Neither sets this kernel's time: the npoint steps are a serial
// chain, each ending in a block-wide argmax, so a launch costs about
// (npoint - 1) x (one step's latency), whatever the card's rates. The floor
// of that chain is a step with no point work: the two warp reductions, the
// barrier and the exchange of the warps' winners (`fps_chain_floor` runs
// just that).
//
// Design. The TPU kernel advances a tile of batch items together, the
// (Bt, N) min-distance vector in VMEM, one full-width VPU pass a step. Here
// one block takes a batch item and a step is as short a chain as it can be:
// * the points and their running minimum live in registers: thread t owns
//   the run of points t P .. t P + P - 1 (P = 1, 2, 4, 8 or 16, one instance
//   each; T the block's threads, chosen per N by measurement,
//   `fps_default_threads`). Past P = 16 at 256 threads (or 8 at 1024) the
//   points and distances live in shared memory (16 bytes a point, N <=
//   kSmemPoints), past that in a global scratch the wrapper allocates, so
//   any N is taken;
// * a thread takes its argmax as a tree over its P points, keeping its best
//   distance, index and coordinates (the later of a pair wins only if
//   strictly larger). The runs are in index order, so of equal maxima the
//   lowest lane holds the smallest index: a warp takes the max of the
//   distance bits with one redux (the distances are >= +0, so their bits
//   order as unsigned integers) and its lowest holder by a ballot, which
//   writes (bits, index, x, y, z) to a slot of its warp;
// * one barrier a step: the slots are double-buffered by step parity, and
//   after the barrier every warp reduces all the slots itself (a redux and
//   a ballot again, the lowest warp of the maxima winning; the winner's
//   index and coordinates by shuffles), so every thread knows the next pick
//   and its coordinates with no second barrier and no dependent load. A
//   warp can reach step j + 2's write of a parity only after every warp has
//   passed step j + 1's barrier, so after every warp has read step j's
//   slots. (Reading every thread's candidate after the barrier instead, with
//   no reduction before it, measured slower from 128 threads up: each lane
//   then scans T / 32 slots in a dependent chain.)
// * B = 16 items fill 16 of 132 SMs. A cluster of blocks an item would pay
//   for a cluster barrier a step; the chain floor says whether the point
//   work or the reduction sets a step's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned int u32;

constexpr int kMaxThreads = 1024;
constexpr int kSmemPoints = 12288;  // 16 bytes a point: 192 KiB of shared memory
constexpr u32 kFull = 0xffffffffu;

// The warps' winners of one step: (distance bits, index, x, y) and z.
struct Slots {
  uint4 kxy[2][kMaxThreads / 32];
  float z[2][kMaxThreads / 32];
};

// One step's argmax across the block from each thread's best (bits, index
// and coordinates): the next pick's index into `cur` and its coordinates
// into (cx, cy, cz) on every thread. Threads own runs of points in index
// order, so of equal maxima the lowest lane (the lowest warp) holds the
// smallest index. One barrier.
__device__ __forceinline__ void block_argmax(Slots& slots, int parity, u32 best, u32 bi, float bx, float by,
                                             float bz, int& cur, float& cx, float& cy, float& cz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const u32 wmax = __reduce_max_sync(kFull, best);
  if (lane == __ffs(__ballot_sync(kFull, best == wmax)) - 1) {
    slots.kxy[parity][warp] = make_uint4(wmax, bi, __float_as_uint(bx), __float_as_uint(by));
    slots.z[parity][warp] = bz;
  }
  __syncthreads();
  uint4 s = make_uint4(0u, 0u, 0u, 0u);  // past the warps: distance 0 after every warp, never first
  float sz = 0.f;
  if (lane < warps) {
    s = slots.kxy[parity][lane];
    sz = slots.z[parity][lane];
  }
  const u32 gmax = __reduce_max_sync(kFull, s.x);
  const int src = __ffs(__ballot_sync(kFull, s.x == gmax)) - 1;
  cur = static_cast<int>(__shfl_sync(kFull, s.y, src));
  cx = __shfl_sync(kFull, __uint_as_float(s.z), src);
  cy = __shfl_sync(kFull, __uint_as_float(s.w), src);
  cz = __shfl_sync(kFull, sz, src);
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// P > 0: thread t's points t P .. t P + P - 1 in registers (missing points:
// distance 0 past every real point, so they never come first). P == 0: the
// points and distances in shared memory (scratch == null) or in the scratch
// (4 planes of N floats an item), thread t's run of ceil(N / T) in order.
template <int P>
__global__ void __launch_bounds__(P >= 16 ? 256 : kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
               float* __restrict__ scratch, int n, int npoint) {
  extern __shared__ float smem[];
  __shared__ Slots slots;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* src = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;
  int cur = start != nullptr ? start[b] : 0;
  float cx = src[3 * (size_t)cur], cy = src[3 * (size_t)cur + 1], cz = src[3 * (size_t)cur + 2];

  if constexpr (P > 0) {
    float px[P], py[P], pz[P], pd[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid * P + p;
      const bool ok = i < n;
      px[p] = ok ? src[3 * i] : 0.f;
      py[p] = ok ? src[3 * i + 1] : 0.f;
      pz[p] = ok ? src[3 * i + 2] : 0.f;
      pd[p] = ok ? 1e10f : 0.f;
    }
    for (int j = 0; j < npoint; ++j) {
      if (tid == 0) o[j] = cur;
      if (j + 1 == npoint) break;
      u32 key[P], at[P];
      float bx[P], by[P], bz[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        pd[p] = fminf(pd[p], sq_dist(px[p], py[p], pz[p], cx, cy, cz));
        key[p] = __float_as_uint(pd[p]);
        at[p] = p;
        bx[p] = px[p];
        by[p] = py[p];
        bz[p] = pz[p];
      }
#pragma unroll
      for (int w = 1; w < P; w <<= 1)
#pragma unroll
        for (int p = 0; p < P; p += 2 * w)
          if (key[p + w] > key[p]) {
            key[p] = key[p + w];
            at[p] = at[p + w];
            bx[p] = bx[p + w];
            by[p] = by[p + w];
            bz[p] = bz[p + w];
          }
      block_argmax(slots, j & 1, key[0], tid * P + at[0], bx[0], by[0], bz[0], cur, cx, cy, cz);
    }
  } else {
    float* buf = scratch != nullptr ? scratch + (size_t)b * 4 * n : smem;
    float* xs = buf;
    float* ys = buf + n;
    float* zs = buf + 2 * (size_t)n;
    float* ds = buf + 3 * (size_t)n;
    const int per = (n + nt - 1) / nt, lo = min(n, tid * per), hi = min(n, lo + per);  // this thread's run
    for (int i = lo; i < hi; ++i) {
      xs[i] = src[3 * (size_t)i];
      ys[i] = src[3 * (size_t)i + 1];
      zs[i] = src[3 * (size_t)i + 2];
      ds[i] = 1e10f;
    }
    // each thread reads back only what it wrote: no barrier before the loop
    for (int j = 0; j < npoint; ++j) {
      if (tid == 0) o[j] = cur;
      if (j + 1 == npoint) break;
      u32 best = 0, bi = n;  // an empty run: distance 0 past every real point
      float bx = 0.f, by = 0.f, bz = 0.f;
      for (int i = lo; i < hi; ++i) {
        const float x = xs[i], y = ys[i], z = zs[i];
        const float m = fminf(ds[i], sq_dist(x, y, z, cx, cy, cz));
        ds[i] = m;
        if (i == lo || __float_as_uint(m) > best) {
          best = __float_as_uint(m);
          bi = i;
          bx = x;
          by = y;
          bz = z;
        }
      }
      block_argmax(slots, j & 1, best, bi, bx, by, bz, cur, cx, cy, cz);
    }
  }
}

// The chain alone: the same steps with no point work (each thread's best is
// a value that changes with the step, so nothing is hoisted), for timing the
// floor a step sets.
__global__ void __launch_bounds__(kMaxThreads) fps_chain_kernel(int* __restrict__ out, int npoint) {
  __shared__ Slots slots;
  const int tid = threadIdx.x;
  int* o = out + (size_t)blockIdx.x * npoint;
  int cur = 0;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int j = 0; j < npoint; ++j) {
    if (tid == 0) o[j] = cur;
    if (j + 1 == npoint) break;
    const u32 best = ((static_cast<u32>(cur) + 1u) * 2654435761u) ^ static_cast<u32>(tid);
    block_argmax(slots, j & 1, best >> 1, tid, cx, cy, cz, cur, cx, cy, cz);
  }
}

// Points a thread in registers for N points over `threads`: the smallest
// instance that holds them, or 0 (shared memory or scratch).
int register_points(int n, int threads) {
  const int per = (n + threads - 1) / threads;
  for (int p = 1; p <= 16; p <<= 1)
    if (per <= p) return p == 16 && threads > 256 ? 0 : p;
  return 0;
}

}  // namespace

// The block size for N points, from a sweep of 32 to 1024 threads at
// FlowNet3D's four shapes on the H100 (recorded in PERF.md): 32 threads at
// N = 64, 128 at 256 (2 points a thread), 256 at 1024 (4), 128 at 2048
// (16); past that 16 a thread at 256 threads, then 8 at 1024, then 1024
// threads over shared memory or the scratch.
extern "C" int fps_default_threads(int n) {
  if (n <= 64) return 32;
  if (n <= 512) return 128;
  if (n <= 1024) return 256;
  if (n <= 2048) return 128;
  if (n <= 4096) return 256;
  return kMaxThreads;
}

// Whether fps_sample needs a scratch for N points: past the register path
// and past shared memory.
extern "C" int fps_scratch_needed(int n) {
  return register_points(n, fps_default_threads(n)) == 0 && n > kSmemPoints;
}

// C entry, bound with ctypes. xyz (B, N, 3) f32, start (B,) int32 (each in
// [0, N); null: 0 for every item) and idx (B, npoint) int32 are device
// pointers to contiguous tensors. ``scratch`` is a device buffer of 4 * B * N
// floats where fps_scratch_needed(N), else null. A block of
// fps_default_threads(N) threads takes each item. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int fps_sample(const float* xyz, const int* start, int* idx, float* scratch, int batch, int n, int npoint,
                          void* stream) {
  if (batch <= 0 || n <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  const int threads = fps_default_threads(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (register_points(n, threads)) {
    case 1: fps_kernel<1><<<batch, threads, 0, s>>>(xyz, start, idx, nullptr, n, npoint); break;
    case 2: fps_kernel<2><<<batch, threads, 0, s>>>(xyz, start, idx, nullptr, n, npoint); break;
    case 4: fps_kernel<4><<<batch, threads, 0, s>>>(xyz, start, idx, nullptr, n, npoint); break;
    case 8: fps_kernel<8><<<batch, threads, 0, s>>>(xyz, start, idx, nullptr, n, npoint); break;
    case 16: fps_kernel<16><<<batch, threads, 0, s>>>(xyz, start, idx, nullptr, n, npoint); break;
    default: {
      const bool in_smem = n <= kSmemPoints;
      if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
      const size_t smem = in_smem ? (size_t)16 * n : 0;
      if (smem + sizeof(Slots) > 48 * 1024) {  // set on the current device, whichever it is
        const cudaError_t err =
            cudaFuncSetAttribute(fps_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * kSmemPoints);
        if (err != cudaSuccess) return (int)err;
      }
      fps_kernel<0><<<batch, threads, smem, s>>>(xyz, start, idx, in_smem ? nullptr : scratch, n, npoint);
    }
  }
  return (int)cudaGetLastError();
}

// The chain floor of fps_sample at (B, N, npoint): `batch` blocks of
// fps_default_threads(N) run npoint - 1 steps of the reductions and the
// barrier with no point work; idx (B, npoint) int32 receives meaningless
// picks. For timing only.
extern "C" int fps_chain_floor(int* idx, int batch, int n, int npoint, void* stream) {
  if (batch <= 0 || n <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  fps_chain_kernel<<<batch, fps_default_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(idx, npoint);
  return (int)cudaGetLastError();
}
