// Chamfer nearest neighbour, one direction, for Hopper (sm_90a): for every
// point of x (B, N, 3) f32 the squared distance to its nearest point of y
// (B, M, 3) f32 and that point's index, ties to the smaller index.
//
// Replaces the TPU kernel learning3d_tpu/kernels/chamfer.py::
// _nn_oneway_pallas (body `_nn_kernel`). Same math as the port's plain
// version `_nn_oneway_reference`: the squared distance from exact
// per-coordinate differences, (d0*d0 + d1*d1) + d2*d2, written with
// __fsub_rn/__fmul_rn/__fadd_rn so that nvcc cannot contract it into FMAs
// (a contraction rounds once where the plain version and the TPU kernel
// round twice, and a near-tied neighbour swaps). The running minimum takes
// a candidate only when it is strictly smaller, scanning y in ascending
// index order, so a tie keeps the smaller index, as jnp.argmin within a
// tile and the strict < across tiles do on the TPU.
//
// Bound. The function computes B * N * M distances of 8 f32 operations
// each and one comparison a distance, on the CUDA cores: at the multistart
// shape (B=256, N=M=1024) that is 2.4 G operations, 0.036 ms at the
// 67 TFLOP/s of f32 outside the tensor cores. It reads x and y (6.3 MB) and
// writes (B, N) distances and indices (2.1 MB), 0.0025 ms at 3.35 TB/s: the
// operations bound it.
//
// Design. The TPU kernel's (sub, 128) output tiles and padding are not
// carried over.
// * One thread a query point, its running (distance, index) in registers.
//   Grid B * ceil(N / 256) blocks of 256 threads, one dimension (B is not
//   bounded by a grid's y extent).
// * y streams through shared memory in tiles of kTile points, as float4
//   (x, y, z, 0): every thread of a warp reads the same candidate at the
//   same time, a broadcast without bank conflicts.
// * The ragged edge is masked in the kernel: the last tile loads only the
//   valid points and the scan stops at M; query threads past N load and
//   scan but write nothing. Any B, N, M >= 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // y points a tile: 32 KB of shared memory

__global__ void __launch_bounds__(kThreads) nn_oneway_kernel(const float* __restrict__ x,
                                                             const float* __restrict__ y,
                                                             float* __restrict__ min_d,
                                                             int* __restrict__ arg, int n_x, int n_y) {
  __shared__ float4 ys[kTile];
  const int blocks_per_cloud = (n_x + kThreads - 1) / kThreads;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int q = (blockIdx.x - cloud * blocks_per_cloud) * kThreads + threadIdx.x;
  const bool valid = q < n_x;
  const float* xq = x + ((size_t)cloud * n_x + (valid ? q : 0)) * 3;
  const float qx = xq[0], qy = xq[1], qz = xq[2];
  const float* yc = y + (size_t)cloud * n_y * 3;

  float best = 0.f;
  int best_i = 0;
  for (int t0 = 0; t0 < n_y; t0 += kTile) {
    const int len = min(kTile, n_y - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* p = yc + (size_t)(t0 + i) * 3;
      ys[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float4 p = ys[i];
      const float d0 = __fsub_rn(qx, p.x), d1 = __fsub_rn(qy, p.y), d2 = __fsub_rn(qz, p.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
      const int j = t0 + i;
      if (j == 0 || d < best) {
        best = d;
        best_i = j;
      }
    }
  }
  if (valid) {
    const size_t row = (size_t)cloud * n_x + q;
    min_d[row] = best;
    arg[row] = best_i;
  }
}

}  // namespace

// C entry, bound with ctypes. x (B, N, 3), y (B, M, 3) f32, min_d (B, N) f32
// and arg (B, N) int32 are device pointers to contiguous tensors. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int nn_oneway(const float* x, const float* y, float* min_d, int* arg, int batch, int n_x, int n_y,
                         void* stream) {
  if (batch <= 0 || n_x <= 0 || n_y <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch * ((n_x + kThreads - 1) / kThreads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nn_oneway_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, y, min_d, arg, n_x,
                                                                                         n_y);
  return (int)cudaGetLastError();
}
