// Exact kNN over xyz and the neighbor gather of DGCNN's edge features, for
// Hopper (sm_90a). x (B, N, 3) f32 in; for every point its k nearest points
// of the same cloud, itself included, nearest first, ties to the smaller
// index; out (B, N, k, 6) f32, the edge features concat(neighbor xyz,
// center xyz).
//
// Replaces the TPU kernel learning3d_tpu/kernels/edgeconv.py::
// knn_neighbors_pallas (body `_edge_kernel`). Same math as the port's plain
// version `knn_neighbors_reference`: squared distances as exact
// per-coordinate differences (d0*d0 + d1*d1) + d2*d2, written with
// __fsub_rn/__fmul_rn/__fadd_rn so that nvcc cannot contract them into FMAs
// (a contraction changes the rounding and a near-tied neighbor swaps). The
// coordinates are copied, so they are exact: the TPU kernel gathers them by
// a one-hot product on its matrix unit through a bf16 hi/lo split, accurate
// to about 1e-5 relative on the chip.
//
// Bound. The function computes B * N^2 distances of 8 f32 operations each
// and at least one comparison a distance to select: at B=32, N=1024 that is
// 0.30 G operations, 4.5 us at the 67 TFLOP/s of f32 on the CUDA cores.
// It reads x (0.4 MB) and writes the (B, N, k, 6) edge tensor (15.7 MB at
// k=20), 4.8 us at 3.35 TB/s; so the two bounds are close, the bytes
// slightly ahead. (The TPU kernel's own cost estimate, 2 B N^2 (3 + k)
// operations, counts the one-hot products of its gather, which a copy
// replaces here.)
//
// Design: K5's selection (csrc/dgcnn_fused.cu, phase 1) without its conv
// stages.
// * Grid B * ceil(N / 32), one dimension (so B is not bounded by a grid's
//   y extent): a block of 8 warps takes 32 query rows of one cloud, one
//   warp a row at a time. The cloud's xyz (12 N bytes) goes to shared
//   memory, so N <= 16384 fits in one block's 227 KB.
// * Selection: each distance becomes a 64-bit key (distance bits, index):
//   for non-negative floats the bits order as the values, so key order is
//   (distance, index) order and ties go to the smaller index by
//   construction. A scan over the N points keeps each lane's 8 smallest
//   keys above the last pick, sorted, in registers; the warp then pops the
//   smallest head across lanes (a shuffle reduction) until k are picked,
//   scanning again (distances recomputed, not stored) only if one lane's 8
//   were all taken. One scan usually yields all k.
// * Output: the warp writes its row's k * 6 floats with consecutive lanes on
//   consecutive addresses, neighbor xyz from shared memory by the picked
//   index, the center's beside them.
// * Ragged N: blocks stop at the last valid row; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned int u32;
typedef unsigned long long u64;

constexpr int kRows = 32;  // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 8;  // sorted keys each lane keeps per scan
constexpr int kMaxK = 64;
constexpr int kMaxN = 16384;
constexpr u64 kNone = ~0ull;

__host__ __device__ constexpr int smem_bytes(int n, int k) { return 4 * 3 * n + 4 * kWarps * k; }

__global__ void __launch_bounds__(kThreads) knn_neighbors_kernel(const float* __restrict__ x,
                                                                 float* __restrict__ out, int n_pts,
                                                                 int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* px = reinterpret_cast<float*>(smem);
  float* py = px + n_pts;
  float* pz = py + n_pts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* picks = reinterpret_cast<int*>(pz + n_pts) + warp * k;
  const int blocks_per_cloud = (n_pts + kRows - 1) / kRows;
  const int block = blockIdx.x;
  const int cloud = block / blocks_per_cloud, q0 = (block - cloud * blocks_per_cloud) * kRows;
  const float* xc = x + (size_t)cloud * n_pts * 3;
  for (int i = threadIdx.x; i < n_pts * 3; i += kThreads) {
    const int p = i / 3, d = i - 3 * p;
    (d == 0 ? px : d == 1 ? py : pz)[p] = xc[i];
  }
  __syncthreads();

  const int q_end = min(n_pts, q0 + kRows);
  for (int q = q0 + warp; q < q_end; q += kWarps) {
    const float qx = px[q], qy = py[q], qz = pz[q];
    u64 last = 0;
    int j = 0;
    while (j < k) {
      u64 l[kT];
#pragma unroll
      for (int p = 0; p < kT; ++p) l[p] = kNone;
      for (int i = lane; i < n_pts; i += 32) {
        const float d0 = __fsub_rn(qx, px[i]), d1 = __fsub_rn(qy, py[i]), d2 = __fsub_rn(qz, pz[i]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
        const u64 key = (static_cast<u64>(__float_as_uint(d)) << 32) | static_cast<u32>(i);
        if ((j == 0 || key > last) && key < l[kT - 1]) {
#pragma unroll
          for (int p = kT - 1; p > 0; --p) l[p] = key < l[p - 1] ? l[p - 1] : (key < l[p] ? key : l[p]);
          l[0] = key < l[0] ? key : l[0];
        }
      }
      int popped = 0;
      while (j < k) {
        u64 w = l[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const u64 o = __shfl_xor_sync(0xffffffffu, w, off);
          w = o < w ? o : w;
        }
        // kNone only once no key is left, which N >= k rules out
        if (lane == 0) picks[j] = w == kNone ? q : static_cast<int>(w & 0xffffffffu);
        ++j;
        last = w;
        if (w != kNone && l[0] == w) {  // the owner pops its head
#pragma unroll
          for (int p = 0; p < kT - 1; ++p) l[p] = l[p + 1];
          l[kT - 1] = kNone;
          ++popped;
        }
        if (__any_sync(0xffffffffu, popped == kT)) break;
      }
    }
    __syncwarp();
    const size_t row = (size_t)cloud * n_pts + q;
    float* orow = out + row * k * 6;
    for (int t = lane; t < k * 6; t += 32) {
      const int jj = t / 6, c = t - jj * 6;
      const int p = c < 3 ? picks[jj] : q;
      const int cc = c < 3 ? c : c - 3;
      orow[t] = (cc == 0 ? px : cc == 1 ? py : pz)[p];
    }
    __syncwarp();  // picks are rewritten by the warp's next row
  }
}

}  // namespace

// C entry, bound with ctypes. x (B, N, 3) f32 and out (B, N, k, 6) f32 are
// device pointers to contiguous tensors. Needs 1 <= k <= 64 and k <= N <= 16384. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int knn_neighbors(const float* x, float* out, int batch, int n_pts, int k, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK || n_pts < k || n_pts > kMaxN)
    return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(n_pts, k);
  cudaError_t err =
      cudaFuncSetAttribute(knn_neighbors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)batch * ((n_pts + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  knn_neighbors_kernel<<<(unsigned)blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, out, n_pts, k);
  return (int)cudaGetLastError();
}
