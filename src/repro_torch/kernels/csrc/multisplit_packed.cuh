// Shared device code of the packed-counter tile kernels K1p-K3p (paper
// §4.3, the privatised packed counters; the packed family of the JAX
// package, src/repro/kernels/common.py:150-410).
//
// The stable in-tile rank is two-level, as in the JAX family:
//
// * Level 1, inside a subtile of at most 255 keys: each warp keeps its
//   counters as 8-bit lanes, four to a 32-bit word, ⌈m/4⌉ words a warp in
//   shared memory (at most 64). It walks its subtile in rounds of 32 keys;
//   __match_any_sync groups the lanes of one bucket, a lane's rank is the
//   counter lane before the round plus popc(peers & lanemask_lt), and the
//   group's leader adds popc(peers) << 8·(b mod 4) to word b / 4. Two groups
//   can share a word, so that add is a shared atomicAdd. No lane can carry
//   into the next: a subtile holds at most 255 keys (the overflow guard of
//   the JAX packed_layout, repeated by the wrapper).
// * Level 2, across subtiles: at the end of each subtile the warp unpacks
//   its words into its int32 row cnt[warp][b], the carry of the subtiles it
//   walked before, and zeroes them. A warp walks a contiguous run of
//   subtiles, so after the walk the exclusive scan of cnt over the warps
//   (warp_offsets) turns each row into the warp's offset in each bucket:
//   rank = warp offset + carry of the warp's earlier subtiles + level-1
//   rank. Stable by construction; int32 throughout.
//
// The JAX family scans a (S, m) table of subtile totals down S; here the
// carry runs along each warp's subtiles and then over the 8 warps, so the
// shared memory is kWarps·m ints and 2 KB of packed words whatever the
// subtile (1 to 255 keys, a runtime argument). The subtile boundaries do
// not change the outputs.
//
// The segmented forms walk the tile's segment runs (multisplit_segmented.cuh):
// a short run is one warp's round, a longer one takes the two-level rank
// over its sub-range, with subtiles counted from the run's start. The state
// stays m-wide, never s·m.
#pragma once

#include "multisplit_segmented.cuh"

namespace ms {

constexpr int kPackedBits = 8;
constexpr int kLanesPerWord = 32 / kPackedBits;             // 4 counters a word
constexpr int kMaxWords = kMaxBuckets / kLanesPerWord;      // 64 words a warp
constexpr unsigned kLaneMask = (1u << kPackedBits) - 1u;    // 255: the largest subtile

// Subtiles of `sub` keys in a range of `len` keys, assigned to the warps in
// contiguous runs of this many.
__device__ __forceinline__ int subtiles_per_warp(int len, int sub) {
  const int n_sub = (len + sub - 1) / sub;
  return (n_sub + kWarps - 1) / kWarps;
}

// The warp that walked key j of the range.
__device__ __forceinline__ int packed_warp_of(int j, int sub, int spw) { return (j / sub) / spw; }

// The two-level rank over keys [0, len) of a range: each key's rank within
// its warp's run of subtiles goes into meta[j] (with kMeta) as rank << 9 |
// bucket, its word into ks[j] (with kKeys), and each warp's count of bucket
// b into cnt[warp * m + b]. With kIds the labels come from `ids`
// (label_at); `keys` is then read only with kKeys. cnt must be zeroed and
// the splitters loaded; `words` holds kWarps·kMaxWords words, any content.
// The caller synchronises the block afterwards.
template <bool kMeta, bool kKeys, bool kIds>
__device__ __forceinline__ void packed_rank_range(const uint32_t* __restrict__ keys,
                                                  const uint32_t* __restrict__ ids, int len,
                                                  int sub, const Label& L, const uint32_t* sp,
                                                  int* cnt, uint32_t* words, int* meta,
                                                  uint32_t* ks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = L.m, nw = (m + kLanesPerWord - 1) / kLanesPerWord;
  const int spw = subtiles_per_warp(len, sub);
  const int n_sub = (len + sub - 1) / sub;
  const int s1 = min((warp + 1) * spw, n_sub);
  int* mine = cnt + warp * m;
  uint32_t* pw = words + warp * kMaxWords;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  for (int q = lane; q < nw; q += 32) pw[q] = 0u;
  __syncwarp();
  for (int su = warp * spw; su < s1; ++su) {
    const int a = su * sub, e = min(a + sub, len);
    // level 1: rounds of 32 keys on the packed words
    for (int r = a; r < e; r += 32) {
      const int i = r + lane;
      const bool valid = i < e;
      const uint32_t w = valid && (kKeys || !kIds) ? keys[i] : 0u;
      const int b = valid ? label_at<kIds>(ids, i, w, L, sp) : -1;
      const unsigned peers = __match_any_sync(kFull, b);
      const int q = b / kLanesPerWord, shift = kPackedBits * (b - q * kLanesPerWord);
      // the same value for all peers: the warp's earlier subtiles plus this
      // subtile's earlier rounds
      const int before = valid ? mine[b] + static_cast<int>((pw[q] >> shift) & kLaneMask) : 0;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(&pw[q], static_cast<uint32_t>(__popc(peers)) << shift);
      __syncwarp();
      if (valid) {
        if (kMeta) meta[i] = ((before + __popc(peers & lanemask_lt)) << kLabelBits) | b;
        if (kKeys) ks[i] = w;
      }
    }
    // level 2: unpack the subtile's counters into the warp's int32 carry
    for (int q = lane; q < nw; q += 32) {
      const uint32_t x = pw[q];
      pw[q] = 0u;
#pragma unroll
      for (int t = 0; t < kLanesPerWord; ++t) {
        const int b = q * kLanesPerWord + t;
        if (b < m) mine[b] += static_cast<int>((x >> (kPackedBits * t)) & kLaneMask);
      }
    }
    __syncwarp();
  }
}

// The segment runs of a tile: with kSeg, find_runs over the segment strip
// (every thread must call it, it synchronises the block); else the whole
// tile is one run. runs[0..n] hold the starts and runs[n] = T.
template <bool kSeg>
__device__ __forceinline__ int tile_runs(const int* __restrict__ seg, int T, int* runs,
                                         int* chunk) {
  if (kSeg) return find_runs(seg, T, runs, chunk);
  if (threadIdx.x == 0) {
    runs[0] = 0;
    runs[1] = T;
  }
  __syncthreads();
  return 1;
}

}  // namespace ms
