// PPFNet's ball grouping for Hopper (sm_90a), K16. xyz (B, N, 3), new_xyz
// (B, S, 3) and values (B, N, C) f32, itself (B, S) int32 in; out
// (B, S, nsample, C) f32: for each query, slot j holds the values of the
// j-th point within the radius in ascending index order, the point
// itself[b, s] left out; the slots past the count hold the values of point
// itself[b, s] (zeros where that index lies outside [0, N)).
//
// Replaces the TPU kernel learning3d_tpu/kernels/sampling.py::
// ball_group_pallas (body `_ball_group_kernel`). Same math as the port's
// plain version `ball_group_reference`: the in-ball test of K15
// (ball_query.cu), every operation rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction, which would move a point that
// lies on the radius in or out),
//   d = ((qx - x)^2 + (qy - y)^2) + (qz - z)^2, in the ball where d <= r2,
// r2 the wrapper's f32 rounding of the Python float radius ** 2. The values
// are copied exactly; the TPU kernel gathers them through a bf16 hi/lo split
// on its matrix unit (~2^-17 relative), the JAX package's oracle
// (index_points) exactly.
//
// Bound. The output dominates the bytes: B S nsample C f32 written once
// (25 MB at RPMNet's B=16, S=N=1024, nsample 64, C=6) against the clouds'
// and values' few hundred KB read once, so the bytes bound it; a query reads
// points in index order until it has nsample in the ball, 9 f32 operations a
// point (chip_smoke.py counts the points this run's queries need).
//
// Design. The TPU kernel builds a (tile, N) distance tile in VMEM, ranks the
// in-ball columns with a triangular-matrix product and gathers with nsample
// one-hot products, so that neither the mask nor the ranks reach HBM. Here
// a block of 8 warps takes up to kQueries queries of one cloud (fewer where
// the blocks would not fill the SMs: queries_of), a warp one query at a
// time.
// * The cloud in shared memory. The block stages its cloud once, by
//   cp.async with every load in flight: xyz as three arrays (x, y, z: a
//   warp's 32 consecutive points read without bank conflicts) and the values
//   as they lie (N C), in chunks of points in index order that fit
//   kCloudBytes (the whole cloud at RPMNet's 1024 points with C = 6: 36 KB);
//   past 32 points' worth the values stay in device memory. Every warp scans
//   each chunk for its queries, each query's count carries over to the next
//   chunk, and the block stops staging chunks once every one of its queries
//   has nsample.
// * The scan: 32 points a round (lane l the point j0 + l), kRounds rounds
//   an iteration (their distances independent), a ballot of the in-ball
//   lanes kept in the warp's round masks in shared memory; a query stops
//   once it has nsample. Then the masks become the warp's list of in-ball
//   indices (kList slots): lane l takes round l (32 rounds a pass), its
//   points' ranks the counts of the rounds before it (a warp scan) plus the
//   in-ball lanes below each, so the slots come out in ascending index
//   order without a sort, and the scan's rounds carry no list bookkeeping.
// * Staged rows, coalesced stores. The row (nsample C floats) is written
//   from the list by the whole warp: for C <= kGatherC lane l takes floats
//   4l.. of each 128, each float's (slot, channel) stepped from the last
//   without a division, the value read from the staged cloud (or the
//   centre's C values, held once in shared memory, past the count), and
//   stores them with 16-byte stores, with 4-byte stores before the first
//   and after the last 16-byte boundary of the device address (so rows
//   whose start is not 16-byte aligned, nsample * C % 4 != 0, are written by
//   the same code); wider C slot by slot, lanes over the channels. At the
//   end of a chunk with the query still open the slots found in it are
//   written (their values leave shared memory with the chunk); at the end
//   of the query the rest of the row. Either goes a list (kList slots) at a
//   time, so longer rows go out in pieces.
//   (Copying each in-ball point's C values into a staged row lane by lane,
//   then writing the row, ran slower on the H100 than the earlier kernel
//   that stored each value straight to device memory: ~35 instructions a
//   round for the copies, against ~4 a float here.)
// Any N, S, nsample and C that ball_group_kernel_limit admits; row
// positions are 64-bit, with no 64-bit division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueries = 32;        // queries a block, at most (four a warp)
constexpr int kList = 256;          // slots of a warp's index list
constexpr int kRounds = 4;          // 32-point rounds an iteration of the scan
constexpr int kMasks = 128;         // a warp's round masks: a chunk's 3392 points at most (106 rounds)
constexpr int kGatherC = 32;        // C up to this: float-wise gather; past it, slot by slot
constexpr int kCloudBytes = 40960;  // a chunk's points: xyz (12 bytes) and, where they fit, values (4 C)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// The chunk of points a block stages at once, and whether the values are
// staged with the coordinates.
struct Chunk {
  int points;
  bool values;
};

inline Chunk chunk_of(int n, int c) {
  const bool values = 32LL * (12 + 4LL * c) <= kCloudBytes;
  const long long per = 12 + (values ? 4LL * c : 0);
  const long long fit = kCloudBytes / per / 32 * 32;
  return Chunk{(int)(fit < n ? fit : n), values};
}

// The lists, the round masks, the centres' values (kGatherC floats a warp),
// the queries' counts and first unwritten slots, then the chunk.
constexpr int kStateBytes = 4 * kWarps * (kList + kMasks + kGatherC) + 8 * kQueries;

// Queries a block: kQueries, halved down to one a warp while the blocks
// would not fill every SM's four resident blocks.
inline int queries_of(int batch, int s, int sms) {
  int nq = kQueries;
  while (nq > kWarps && (long long)batch * ((s + nq - 1) / nq) < 4LL * sms) nq /= 2;
  return nq;
}

inline int smem_bytes(const Chunk& ch, int c) { return kStateBytes + ch.points * (12 + (ch.values ? 4 * c : 0)); }

__device__ __forceinline__ int offset_of(const float* p) { return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3); }

// A 4-byte copy from device to shared memory that does not wait for its
// load (cp.async): a chunk's loads are all in flight at once.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Where a query's slots take their values: slot < cnt the point at
// lst[slot - s_lo] (its values at vals + (point - base) c: the staged chunk
// or device memory), the others the centre's (cen: C floats, or null for
// zeros).
struct Slots {
  const int* lst;
  int s_lo, cnt;
  const float* vals;
  int base, c;
  const float* cen;
  __device__ float value(int slot, int k) const {
    return slot < cnt ? vals[(size_t)(lst[slot - s_lo] - base) * c + k] : (cen ? cen[k] : 0.f);
  }
};

// Row floats [a C, b C) (slots a..b-1, b - a <= kList), C <= kGatherC:
// 4-byte stores up to the first 16-byte boundary of the device address,
// 16-byte stores (lane l floats 4l.. of every 128; (slot, channel) stepped
// by (dq, dr) = divmod(128, C)), 4-byte stores after the last.
__device__ __forceinline__ void write_gather(float* row, const Slots& sl, int a, int b, int lane, int dq, int dr) {
  const int c = sl.c;
  const int n = (b - a) * c;
  float* dst = row + (long long)a * c;
  const int head = min((4 - offset_of(dst)) & 3, n);
  if (lane < head) dst[lane] = sl.value(a + lane / c, lane % c);
  const int vec = (n - head) >> 2;
  int e = head + 4 * lane;
  int q = e / c, k = e - q * c;
  for (int v = lane; v < vec; v += 32) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int qi = q, ki = k + i;
      while (ki >= c) {  // at most 3 times (C = 1)
        ki -= c;
        ++qi;
      }
      f[i] = sl.value(a + qi, ki);
    }
    *reinterpret_cast<float4*>(dst + head + 4 * v) = make_float4(f[0], f[1], f[2], f[3]);
    q += dq;
    k += dr;
    if (k >= c) {
      k -= c;
      ++q;
    }
  }
  const int t0 = head + 4 * vec;
  if (lane < n - t0) {
    const int et = t0 + lane, qt = et / c;
    dst[et] = sl.value(a + qt, et - qt * c);
  }
}

// Row floats [a C, b C), C > kGatherC: slot by slot, lanes over the
// channels (each slot's floats contiguous on both sides).
__device__ __forceinline__ void write_slotwise(float* row, const Slots& sl, int a, int b, int lane) {
  const int c = sl.c;
  for (int slot = a; slot < b; ++slot) {
    float* dst = row + (long long)slot * c;
    for (int k = lane; k < c; k += 32) dst[k] = sl.value(slot, k);
  }
}

__device__ __forceinline__ void write_slots(float* row, const Slots& sl, int a, int b, int lane, int dq, int dr) {
  if (b <= a) return;
  if (sl.c <= kGatherC)
    write_gather(row, sl, a, b, lane, dq, dr);
  else
    write_slotwise(row, sl, a, b, lane);
}

__global__ void __launch_bounds__(kThreads, 4) ball_group_kernel(const float* __restrict__ xyz,
                                                                 const float* __restrict__ new_xyz,
                                                                 const int* __restrict__ itself,
                                                                 const float* __restrict__ values,
                                                                 float* __restrict__ out, int n, int s, int nsample,
                                                                 int c, float r2, int nq, int qblocks,
                                                                 int chunk_pts, int stage_values) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / qblocks, s0 = (blockIdx.x - b * qblocks) * nq;
  int* lst = reinterpret_cast<int*>(smem) + warp * kList;
  unsigned* msk = reinterpret_cast<unsigned*>(smem + kWarps * kList) + warp * kMasks;
  float* cen = smem + kWarps * (kList + kMasks) + warp * kGatherC;
  // a query's count (-1 once its row is written) and first unwritten slot
  int* found_s = reinterpret_cast<int*>(smem + kWarps * (kList + kMasks + kGatherC));
  int* slo_s = found_s + kQueries;
  float* cx = reinterpret_cast<float*>(slo_s + kQueries);  // x | y | z of the chunk, then its values
  float* cv = cx + 3 * chunk_pts;
  const float* vb = values + (size_t)b * n * c;
  const int dq = 128 / c, dr = 128 - dq * c;

  if (threadIdx.x < nq) {
    found_s[threadIdx.x] = 0;
    slo_s[threadIdx.x] = 0;
  }
  for (int c0 = 0; c0 < n; c0 += chunk_pts) {
    const int cn = min(chunk_pts, n - c0);
    const bool last = c0 + cn >= n;
    __syncthreads();  // the previous chunk is read (and the counts are set)
    const float* pc = xyz + ((size_t)b * n + c0) * 3;
    for (int i = threadIdx.x; i < 3 * cn; i += kThreads) {
      const int p = i / 3;
      copy4(cx + (i - 3 * p) * chunk_pts + p, pc + i);
    }
    if (stage_values) {
      const float* pv = vb + (size_t)c0 * c;
      for (int i = threadIdx.x; i < cn * c; i += kThreads) copy4(cv + i, pv + i);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const float* vals = stage_values ? cv : vb;
    const int base = stage_values ? c0 : 0;
    bool open = false;
    for (int qi = warp; qi < nq && s0 + qi < s; qi += kWarps) {
      int found = found_s[qi];
      if (found < 0) continue;  // its row is written
      const int first = found;  // the rank of the chunk's first in-ball point
      const size_t q = (size_t)b * s + s0 + qi;
      const float qx = __ldg(new_xyz + 3 * q), qy = __ldg(new_xyz + 3 * q + 1), qz = __ldg(new_xyz + 3 * q + 2);
      const int self = __ldg(itself + q);
      float* row = out + q * (size_t)nsample * c;
      auto in_ball = [&](int j) {
        if (j >= c0 + cn || j == self) return false;
        const int p = j - c0;
        const float d0 = __fsub_rn(qx, cx[p]);
        const float d1 = __fsub_rn(qy, cx[chunk_pts + p]);
        const float d2 = __fsub_rn(qz, cx[2 * chunk_pts + p]);
        return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)) <= r2;
      };
      // the scan: kRounds rounds an iteration (their distances are
      // independent), each round's ballot kept in the warp's masks
      int rounds = 0;
      for (int j0 = c0; j0 < c0 + cn && found < nsample; j0 += 32 * kRounds) {
        bool in[kRounds];
        unsigned m[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) in[r] = in_ball(j0 + 32 * r + lane);
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          m[r] = __ballot_sync(kFull, in[r]);
          found += __popc(m[r]);
        }
        if (lane < kRounds) {
          unsigned mine = m[0];
#pragma unroll
          for (int r = 1; r < kRounds; ++r) mine = lane == r ? m[r] : mine;
          msk[rounds + lane] = mine;
        }
        rounds += kRounds;
      }
      __syncwarp();
      const int cnt = min(found, nsample);
      // The list entries of ranks [lo, hi): round r's masks, 32 rounds a
      // pass, each lane its round's in-ball points at their ranks (the
      // rounds' counts summed across the lanes).
      auto list = [&](int lo, int hi) {
        int rank0 = first;
        for (int r0 = 0; r0 < rounds && rank0 < hi; r0 += 32) {
          unsigned mr = r0 + lane < rounds ? msk[r0 + lane] : 0u;
          const int k = __popc(mr);
          int incl = k;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += v;
          }
          int rank = rank0 + incl - k;
          if (rank < hi && rank + k > lo)
            for (const int pt = c0 + 32 * (r0 + lane); mr; mr &= mr - 1, ++rank)
              if (rank >= lo && rank < hi) lst[rank - lo] = pt + __ffs(mr) - 1;
          rank0 += __shfl_sync(kFull, incl, 31);
        }
      };
      const int end = found >= nsample || last ? nsample : cnt;  // write the padding too, or the listed slots
      Slots sl{lst, 0, cnt, vals, base, c, nullptr};
      if (end == nsample) {
        const bool has_self = self >= 0 && self < n;
        if (c <= kGatherC) {
          if (lane < c) cen[lane] = has_self ? __ldg(vb + (size_t)self * c + lane) : 0.f;
          sl.cen = cen;
        } else {
          sl.cen = has_self ? vb + (size_t)self * c : nullptr;
        }
      }
      for (long long a = slo_s[qi]; a < end; a += kList) {  // a list's worth of slots at a time
        const int lo = (int)a, hi = (int)min(a + kList, (long long)end);
        sl.s_lo = lo;
        if (lo < cnt) list(lo, min(hi, cnt));
        __syncwarp();
        write_slots(row, sl, lo, hi, lane, dq, dr);
        __syncwarp();
      }
      if (end == nsample) {
        if (lane == 0) found_s[qi] = -1;
      } else {
        // the chunk ends with the query open: its listed slots are written,
        // whose values leave shared memory with the chunk
        if (lane == 0) {
          found_s[qi] = found;
          slo_s[qi] = cnt;
        }
        open = true;
      }
    }
    if (!__syncthreads_or(open)) break;  // every query of the block has its row
  }
}

}  // namespace

// C entry: the points a chunk of K16's cloud holds for (N, C), negative
// where the values stay in device memory (the Python statement is
// kernels/sampling.py's ball_group_chunk).
extern "C" int ball_group_chunk(int n, int c) {
  if (n <= 0 || c <= 0) return 0;
  const Chunk ch = chunk_of(n, c);
  return ch.values ? ch.points : -ch.points;
}

// C entry: the queries a block takes for (B, S) on `sms` SMs (the Python
// statement is kernels/sampling.py's ball_group_queries).
extern "C" int ball_group_queries(int batch, int s, int sms) {
  if (batch <= 0 || s <= 0 || sms <= 0) return 0;
  return queries_of(batch, s, sms);
}

// C entry, bound with ctypes. xyz (B, N, 3) f32, new_xyz (B, S, 3) f32,
// itself (B, S) int32, values (B, N, C) f32 and out (B, S, nsample, C) f32
// (4-byte aligned) are device pointers to contiguous tensors; r2 the squared
// radius. Returns the CUDA error code of the launch (0 on success).
extern "C" int ball_group(const float* xyz, const float* new_xyz, const int* itself, const float* values, float* out,
                          int batch, int n, int s, int nsample, int c, float r2, void* stream) {
  if (batch <= 0 || n <= 0 || s <= 0 || nsample <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  // the SM count and the shared-memory limit (the largest chunk's), once a
  // device
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ball_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStateBytes + kCloudBytes);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  const int nq = queries_of(batch, s, sms_of[dev]);
  const int qblocks = (s + nq - 1) / nq;
  const long long blocks = (long long)batch * qblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Chunk ch = chunk_of(n, c);
  const int bytes = smem_bytes(ch, c);
  ball_group_kernel<<<(unsigned)blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, itself, values, out, n, s, nsample, c, r2, nq, qblocks, ch.points, ch.values ? 1 : 0);
  return (int)cudaGetLastError();
}
