// Shared device code of the segmented multisplit tile kernels (paper §4.5
// over the combined id cid = seg·m + b, DESIGN.md §9 of the JAX package).
//
// A tile's segment ids never decrease, so the tile is a sequence of segment
// runs and the (seg, b)-major order of the tile is the bucket-major order of
// each run, run after run. Within a run the problem is the flat one, so the
// per-bucket state stays m-wide (as in K1-K3) and shared memory does not
// grow with the number of segments s:
//
// * split_runs flags the starts of each 32-key chunk with one ballot (1 KiB
//   a tile), hands each short run to one warp as it meets it and lists only
//   the long runs;
// * a run of at most kShortRun keys is solved by one warp alone, with no
//   block barrier: __match_any_sync ranks a lane among the run's keys of its
//   bucket (short_run_rank's shuffle loop also counts the run's keys of
//   smaller buckets, for a reorder);
// * a longer run goes through the flat path of its kernel (warp-private
//   counters, warp offsets, block scan) on the sub-range [a, e) of the tile,
//   one run after another. There are at most T / 33 of them in a tile.
//
// Each segment owns exactly one run of a tile, so the runs write disjoint
// slots of the tile. Ranks are stable by construction. The users are the
// Hopper designs of K2s, K3s, K2p and K3p (seg_fused_postscan_reorder.cu,
// seg_tile_positions.cu, packed_fused_postscan_reorder.cu,
// packed_tile_positions.cu).
#pragma once

#include "multisplit_common.cuh"

namespace ms {

constexpr int kShortRun = 32;
constexpr int kMaxChunks = 8192 / 32;               // chunks a tile at T <= 8192
constexpr int kMaxLong = 8192 / (kShortRun + 1) + 1;   // split_runs' long runs at T <= 8192

// Segment id of one strip entry, kept inside [0, s) so that a strip outside
// the contract can never index out of bounds.
__device__ __forceinline__ int seg_at(const int* __restrict__ seg, int i, int s) {
  return min(max(seg[i], 0), s - 1);
}

// The run split of a tile of several segment runs, its strip `seg` in
// shared memory. A ballot a 32-key chunk flags the run starts (flags holds
// (T + 31) / 32 words); then each warp walks the starts of its chunks in
// order, a run's end the next flag, calls short_run(a, len) with every lane
// for a run of at most kShortRun keys, and lists a longer one [a, e) in
// longs (kMaxLong entries, in no set order). Returns the number of long
// runs, the same in every thread. Every thread of the block must call it;
// it synchronises the block twice, the last time after every short run.
template <typename Short>
__device__ __forceinline__ int split_runs(const int* seg, int T, unsigned* flags, int2* longs,
                                          int* n_long, Short&& short_run) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = (T + 31) >> 5;
  for (int c = warp; c < nch; c += kWarps) {
    const int i = (c << 5) + lane;
    const unsigned f = __ballot_sync(kFull, i < T && (i == 0 || seg[i] != seg[i - 1]));
    if (lane == 0) flags[c] = f;
  }
  if (threadIdx.x == 0) *n_long = 0;
  __syncthreads();
  for (int c = warp; c < nch; c += kWarps) {
    unsigned f = flags[c];
    while (f) {
      const int a = (c << 5) + __ffs(f) - 1;
      f &= f - 1;
      int e = T;                                     // the next start, or the tile's end
      if (f) {
        e = (c << 5) + __ffs(f) - 1;
      } else {
        for (int cc = c + 1; cc < nch; cc += 32) {
          const unsigned x = cc + lane < nch ? flags[cc + lane] : 0u;
          const unsigned nz = __ballot_sync(kFull, x != 0u);
          if (nz) {
            const int first = cc + __ffs(nz) - 1;
            e = (first << 5) + __ffs(flags[first]) - 1;
            break;
          }
        }
      }
      if (e - a > kShortRun) {
        if (lane == 0) longs[atomicAdd(n_long, 1)] = make_int2(a, e);
        continue;
      }
      short_run(a, e - a);
    }
  }
  __syncthreads();
  return *n_long;
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
