// Warp-wide bitonic sort and merge of 64-bit keys, shared by K8 (knn.cu)
// and the DGCNN selection of K5, K7 and K9 (dgcnn_select.cu): a warp keeps a
// row's running smallest keys sorted across its lanes (lane l holds
// position l; a list of 64 holds positions l and 32 + l in two registers),
// and merges each batch of new keys that pass the k-th key by a bitonic
// sort of the batch and the lower half of a bitonic merge, several rows at
// once. Keys are distinct (they carry the index), or kNone.

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
// lane; 32- or 64-bit keys) sorted ascending.
template <int R, typename K>
__device__ __forceinline__ void clean32_rows(K (&c)[R], int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
    K o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(kFull, c[r], stride);
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = (c[r] < o[r]) == lower ? c[r] : o[r];
  }
}

// The full bitonic merge of R rows at once: the sorted rows a[r] and b[r]
// (one key a lane each) become one sorted row of 64, positions 0..31 in a[r]
// and 32..63 in b[r]: a against b reversed, the smaller of each pair in a,
// the larger in b (both bitonic), then each cleaned.
template <int R, typename K>
__device__ __forceinline__ void merge64_rows(K (&a)[R], K (&b)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const K o = __shfl_sync(kFull, b[r], 31 - lane);
    b[r] = a[r] < o ? o : a[r];
    a[r] = a[r] < o ? a[r] : o;
  }
  clean32_rows<R>(a, lane);
  clean32_rows<R>(b, lane);
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

// Merge R rows at once, each sorted batch c[r] into the sorted list of 64
// (lo[r], hi[r]), keeping the smallest 64: the smallest 32 of hi and the
// batch (no key of hi past them can be among the 64, and the batch has only
// 32), then the full merge of lo with them.
template <int R>
__device__ __forceinline__ void merge64_batch_rows(u64 (&lo)[R], u64 (&hi)[R], const u64 (&c)[R], int lane) {
  merge32_rows<R>(hi, c, lane);
  merge64_rows<R>(lo, hi, lane);
}

}  // namespace warp_select
