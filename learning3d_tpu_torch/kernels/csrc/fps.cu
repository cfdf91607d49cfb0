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
// chain, each ending in a block-wide argmax (two barriers), so a launch
// costs about npoint x (one step's latency), whatever the card's rates.
//
// Design. The TPU kernel advances a tile of batch items together, the
// (Bt, N) min-distance vector in VMEM, one full-width VPU pass a step. Here:
// * one block a batch item (up to 1024 threads, each looping over every
//   1024th point: 2 a thread at N = 2048); the points (x, y, z as three
//   planes) and the min-distance vector live in shared memory (16 bytes a
//   point, N <= kSmemPoints), past that in a global scratch the wrapper
//   allocates (L2-resident at these sizes), so any N is taken;
// * each thread updates its points and keeps the largest 64-bit key
//   (distance bits << 32 | ~index): the distances are >= +0, so the bits
//   order as the floats, and of equal distances the smaller index has the
//   larger key. A warp's max by shuffles, the block's by warp 0 over the
//   warps' maxima through shared memory; the winner's index is broadcast
//   and its coordinates read from shared memory by every thread;
// * B = 16 items fill 16 of 132 SMs: the card is mostly idle during a
//   launch. Thread-block clusters splitting an item over several SMs are
//   speed work for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 1024;
constexpr int kSmemPoints = 12288;  // 16 bytes a point: 192 KiB of shared memory

__device__ __forceinline__ u64 fps_key(float d, int i) {
  return (static_cast<u64>(__float_as_uint(d)) << 32) | static_cast<u64>(~static_cast<unsigned>(i));
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads) fps_kernel(const float* __restrict__ xyz,
                                                          const int* __restrict__ start, int* __restrict__ out,
                                                          float* __restrict__ scratch, int n, int npoint) {
  extern __shared__ float smem[];
  __shared__ u64 warp_best[kMaxThreads / 32];
  __shared__ int pick;

  const int b = blockIdx.x;
  const float* src = xyz + (size_t)b * n * 3;
  float* buf = scratch != nullptr ? scratch + (size_t)b * 4 * n : smem;
  float* xs = buf;
  float* ys = buf + n;
  float* zs = buf + 2 * (size_t)n;
  float* ds = buf + 3 * (size_t)n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;

  for (int i = tid; i < n; i += blockDim.x) {
    xs[i] = src[3 * (size_t)i];
    ys[i] = src[3 * (size_t)i + 1];
    zs[i] = src[3 * (size_t)i + 2];
    ds[i] = 1e10f;
  }
  __syncthreads();

  int* o = out + (size_t)b * npoint;
  int cur = start[b];
  for (int j = 0; j < npoint; ++j) {
    if (tid == 0) o[j] = cur;
    if (j + 1 == npoint) break;
    const float cx = xs[cur], cy = ys[cur], cz = zs[cur];
    u64 best = 0;
    for (int i = tid; i < n; i += blockDim.x) {
      const float dx = __fsub_rn(xs[i], cx), dy = __fsub_rn(ys[i], cy), dz = __fsub_rn(zs[i], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(ds[i], d);
      ds[i] = m;
      const u64 key = fps_key(m, i);
      best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      u64 v = lane < warps ? warp_best[lane] : 0ull;
      v = warp_max(v);
      if (lane == 0) pick = static_cast<int>(~static_cast<unsigned>(v & 0xffffffffull));
    }
    __syncthreads();
    cur = pick;
  }
}

}  // namespace

// C entry, bound with ctypes. xyz (B, N, 3) f32, start (B,) int32 (each in
// [0, N)) and idx (B, npoint) int32 are device pointers to contiguous
// tensors. ``scratch`` is null where N <= fps_smem_points(), else a device
// buffer of 4 * B * N floats. Returns the CUDA error code of the launch (0
// on success).
extern "C" int fps_smem_points() { return kSmemPoints; }

extern "C" int fps_sample(const float* xyz, const int* start, int* idx, float* scratch, int batch, int n, int npoint,
                          void* stream) {
  if (batch <= 0 || n <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  const bool in_smem = n <= kSmemPoints;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)16 * n : 0;
  if (smem > 48 * 1024) {  // set on the current device, whichever it is
    const cudaError_t err =
        cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * kSmemPoints);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = n >= kMaxThreads ? kMaxThreads : ((n + 31) / 32) * 32;
  fps_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, start, idx,
                                                                           in_smem ? nullptr : scratch, n, npoint);
  return (int)cudaGetLastError();
}
