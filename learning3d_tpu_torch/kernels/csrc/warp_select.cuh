// Warp-wide bitonic sort and merge of 64-bit keys, shared by K8 (knn.cu)
// and K9 (dgcnn_int8.cu): a warp keeps a row's running smallest keys sorted
// across its lanes (lane l holds position l), and merges each batch of new
// keys that pass the k-th key by a bitonic sort of the batch and the lower
// half of a bitonic merge, several rows at once. Keys are distinct (they
// carry the index), or kNone.

#pragma once

#include <stdint.h>

namespace warp_select {

constexpr unsigned long long kNone = ~0ull;
constexpr unsigned int kFull = 0xffffffffu;

typedef unsigned int u32;
typedef unsigned long long u64;

// One side of a compare-exchange: the smaller of c and o where `keep_min`,
// else the larger (keys are distinct, or both kNone).
__device__ __forceinline__ u64 keep(u64 c, u64 o, bool keep_min) { return (c < o) == keep_min ? c : o; }

// sort32 of R independent rows at once (row r's keys in c[r], one a lane;
// 32- or 64-bit keys): the rows' shuffles interleave, so their latencies
// overlap.
template <int R, typename K>
__device__ __forceinline__ void sort32_rows(K (&c)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lower = ((lane & size) == 0) == ((lane & stride) == 0);
      K o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(kFull, c[r], stride);
#pragma unroll
      for (int r = 0; r < R; ++r) c[r] = (c[r] < o[r]) == lower ? c[r] : o[r];
    }
  }
}

// The bitonic clean of R rows at once: each bitonic row c[r] (one key a
// lane) sorted ascending.
template <int R>
__device__ __forceinline__ void clean32_rows(u64 (&c)[R], int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
    u64 o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(kFull, c[r], stride);
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = keep(c[r], o[r], lower);
  }
}

// Merge R rows at once, each sorted batch c[r] (one key a lane) into the
// sorted list of 32 lo[r], keeping the smallest: the lower half of a bitonic
// merge of the list with the reversed batch, then a bitonic clean.
template <int R>
__device__ __forceinline__ void merge32_rows(u64 (&lo)[R], const u64 (&c)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) lo[r] = keep(lo[r], __shfl_sync(kFull, c[r], 31 - lane), true);
  clean32_rows<R>(lo, lane);
}

}  // namespace warp_select
