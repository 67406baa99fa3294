// Shared device code of the segmented multisplit tile kernels (paper §4.5
// over the combined id cid = seg·m + b, DESIGN.md §9 of the JAX package).
//
// A tile's segment ids never decrease, so the tile is a sequence of segment
// runs and the (seg, b)-major order of the tile is the bucket-major order of
// each run, run after run. Within a run the problem is the flat one, so the
// per-bucket state stays m-wide (as in K1-K3) and shared memory does not
// grow with the number of segments s:
//
// * find_runs compacts the start of every run into a list (T + 1 ints),
//   with warp ballots and one scan of the per-chunk counts;
// * a run of at most kShortRun keys is solved by one warp alone, with no
//   block barrier: __match_any_sync ranks a lane among the run's keys of its
//   bucket and a shuffle loop counts the run's keys of smaller buckets;
// * a longer run goes through the flat machinery of multisplit_common.cuh
//   (warp-private counters, warp offsets, block scan) on the sub-range
//   [a, e) of the tile, one run after another. There are at most T / 33 of
//   them in a tile.
//
// Each segment owns exactly one run of a tile, so the runs write disjoint
// columns of the tile's (s·m) histogram row and disjoint slots of the tile.
// Nothing here uses atomics: ranks are stable by construction.
#pragma once

#include "multisplit_common.cuh"

namespace ms {

constexpr int kShortRun = 32;
constexpr int kMaxChunks = 8192 / 32 + 1;           // find_runs' chunk counts at T <= 8192

// Segment id of one strip entry, kept inside [0, s) so that a strip outside
// the contract can never index out of bounds.
__device__ __forceinline__ int seg_at(const int* __restrict__ seg, int i, int s) {
  return min(max(seg[i], 0), s - 1);
}

// The starts of the tile's segment runs, in order, into runs[0..n) with
// runs[n] = T; returns n (the same value in every thread). Warps take
// 32-key chunks; a ballot flags the chunk's run starts, one warp scans the
// chunk counts (chunk holds (T + 31) / 32 + 1 ints), and each chunk writes
// its starts at its offset: three barriers a tile. Every thread of the
// block must call it.
__device__ inline int find_runs(const int* __restrict__ seg, int T, int* runs, int* chunk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = (T + 31) >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  for (int c = warp; c < nch; c += kWarps) {
    const int i = (c << 5) + lane;
    const unsigned flags = __ballot_sync(kFull, i < T && (i == 0 || seg[i] != seg[i - 1]));
    if (lane == 0) chunk[c] = __popc(flags);
  }
  __syncthreads();
  if (warp == 0) {                                   // exclusive scan of the chunk counts
    int carry = 0;
    for (int base = 0; base < nch; base += 32) {
      const int v = base + lane < nch ? chunk[base + lane] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
      }
      if (base + lane < nch) chunk[base + lane] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) chunk[nch] = carry;
  }
  __syncthreads();
  for (int c = warp; c < nch; c += kWarps) {
    const int i = (c << 5) + lane;
    const bool start = i < T && (i == 0 || seg[i] != seg[i - 1]);
    const unsigned flags = __ballot_sync(kFull, start);
    if (start) runs[chunk[c] + __popc(flags & lanemask_lt)] = i;
  }
  const int n = chunk[nch];
  if (threadIdx.x == 0) runs[n] = T;
  __syncthreads();
  return n;
}

// One short run [a, a + len), len <= 32, in one warp: lane l takes key a + l
// and returns its bucket (-1 past the run), its stable rank among the run's
// keys of that bucket, the count of the run's keys in smaller buckets, and
// the match mask of its bucket. With kIds the bucket is read from the ids
// plane (label_at). Every lane of the warp must call it.
struct ShortRank {
  uint32_t w;
  int b, rank, before;
  unsigned peers;
};

template <bool kIds = false>
__device__ __forceinline__ ShortRank short_run_rank(const uint32_t* __restrict__ keys,
                                                    const uint32_t* __restrict__ ids, int a,
                                                    int len, const Label& L, const uint32_t* sp) {
  const int lane = threadIdx.x & 31;
  ShortRank r;
  const bool valid = lane < len;
  r.w = valid ? keys[a + lane] : 0u;
  r.b = valid ? label_at<kIds>(ids, a + lane, r.w, L, sp) : -1;
  r.peers = __match_any_sync(kFull, r.b);
  r.rank = __popc(r.peers & ((1u << lane) - 1u));
  r.before = 0;
  for (int j = 0; j < len; ++j) r.before += __shfl_sync(kFull, r.b, j) < r.b;
  return r;
}

}  // namespace ms
