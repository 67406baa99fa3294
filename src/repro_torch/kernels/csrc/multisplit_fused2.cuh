// Shared device code of the fused two-digit radix kernels K1f-K3f (paper
// §7.1 with two digit passes a tile residency; the fused2 bodies of the JAX
// package, src/repro/kernels/common.py:412-671).
//
// A pair is one stable pass over the combined digit pair = (u >> shift) &
// (m² - 1), m² = 2^bits: two chained stable single-digit passes equal one
// stable pass over the pair (the LSD identity), and the same identity
// decomposes the pair inside the tile into sub-digit stages of `sub` bits.
// The pair's rows (histogram, G) are m² = 65536 words wide at r = 8, 256 KB
// a row of int32, more than a block's 227 KB of shared memory:
//
// * K1f counts in 16-bit halves instead, two cells to a word: a tile of at
//   most 8192 keys never fills one, and m² = 65536 of them take 128 KB of
//   shared memory. Each warp adds its keys of one cell with one shared
//   atomicAdd a group of equal cells (__match_any_sync), and the block
//   writes its row once, widened to int32, a window of whole segments at a
//   time (fused2_tile_histograms.cu).
// * K2f and K3f sort the tile in shared memory by the pair, stably, in an
//   LSD sweep of sub-digit stages: each stage is the flat K2 machinery (the
//   warp-ballot rank, or the packed two-level rank of the packed family,
//   warp offsets, a block scan of the 2^sub bucket counts) and a reorder of
//   the key words and of a 16-bit source index between two ping-pong
//   buffers. Values never move per stage: the index gathers them once at
//   the end. After the sweep each cell (seg, pair) is a contiguous run of
//   the tile, so a key's stable rank in its cell is its position minus the
//   run's head, found with warp ballots and a max-carry over the warps; the
//   key's base G[tile, seg·m² + pair] is read from device memory, once a
//   key: G stays int32-wide, so nothing m²-wide of K2f / K3f lives in
//   shared memory.
// * Segmented tiles never sort by segment: segment ids never decrease
//   along a tile, so sorting each segment run by its pair is the (seg,
//   pair)-major order. A run of at most 32 keys is sorted by one warp with
//   shuffles; a longer one takes the sweep over its sub-range. The state
//   stays 2^sub-wide whatever s.
//
// Shared memory: two key buffers, two 16-bit index buffers and the rank's
// meta words (16 bytes a key; 128 KB at T = 8192), the run list when
// segmented (4 bytes a key more), and 12 KB of counters. Everything is
// int32: G + rank is exact for every n < 2^31.
#pragma once

#include "multisplit_packed.cuh"

namespace ms {

constexpr int kMaxPairBits = 16;      // the widest pair of the fused schedule (m² = 65536)
constexpr int kMaxSubBits = 8;        // a stage has 2^sub <= kMaxBuckets buckets
constexpr int kStageSubtile = 128;    // the packed stage's subtile (the JAX auto subtile)

__device__ __forceinline__ uint32_t pair_of(uint32_t w, int shift, int bits) {
  return (w >> shift) & ((1u << bits) - 1u);
}

// The bitfield label of one sub-digit stage: b bits at `shift`.
__device__ __forceinline__ Label stage_label(int shift, int b) {
  Label L;
  L.kind = kBitfield;
  L.key_kind = kU32;
  L.m = 1 << b;
  L.u0 = static_cast<unsigned>(shift);
  L.u1 = (1u << b) - 1u;
  L.f0 = L.f1 = 0.f;
  L.splitters = nullptr;
  L.n_split = 0;
  L.plane = 0;
  return L;
}

// The counters one stage of the sweep works in.
struct StageSmem {
  int* cnt;          // [kWarps][kMaxBuckets]
  int* start;        // [kMaxBuckets]
  int* wsum;         // [kWarps]
  uint32_t* words;   // [kWarps][kMaxWords] (packed family)
  int* meta;         // [len] rank << kLabelBits | bucket
};

// One stable stage over a range of len keys: the keys and source indices of
// (sk, si) go to (dk, di) in the order of their bucket under L, stably.
// Every thread of the block must call it; it synchronises the block before
// it returns.
template <bool kPacked>
__device__ __forceinline__ void stage_sort(const uint32_t* sk, const uint16_t* si, uint32_t* dk,
                                           uint16_t* di, int len, const Label& L,
                                           const StageSmem& S) {
  const int m = L.m;
  zero(S.cnt, kWarps * m);
  __syncthreads();
  if (kPacked)
    packed_rank_range<true, false, false>(sk, nullptr, len, kStageSubtile, L, nullptr, S.cnt,
                                          S.words, S.meta, nullptr);
  else
    rank_tile<true, false>(sk, nullptr, len, L, nullptr, S.cnt, S.meta);
  __syncthreads();
  const int count = warp_offsets(S.cnt, m);          // thread b: the range's count of bucket b
  const int first = block_exclusive_scan(count, S.wsum);
  if (threadIdx.x < m) S.start[threadIdx.x] = first;
  __syncthreads();
  const int R = rounds_per_warp(len);
  const int spw = subtiles_per_warp(len, kStageSubtile);
  const int mask = (1 << kLabelBits) - 1;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int v = S.meta[j];
    const int b = v & mask;
    const int w = kPacked ? packed_warp_of(j, kStageSubtile, spw) : (j >> 5) / R;
    const int dest = S.start[b] + S.cnt[w * m + b] + (v >> kLabelBits);
    dk[dest] = sk[j];
    di[dest] = si[j];
  }
  __syncthreads();
}

// The LSD sweep of one range [a, a + len) of the tile over the pair's bits,
// sub bits a stage, from buffer 0 to buffer (stages % 2). Every thread of
// the block must call it.
template <bool kPacked>
__device__ __forceinline__ void sweep_range(uint32_t* const* kb, uint16_t* const* ib, int a,
                                            int len, int shift, int bits, int sub,
                                            const StageSmem& S) {
  int from = 0;
  for (int off = 0; off < bits; off += sub) {
    const int b = min(sub, bits - off);
    stage_sort<kPacked>(kb[from] + a, ib[from] + a, kb[1 - from] + a, ib[1 - from] + a, len,
                        stage_label(shift + off, b), S);
    from = 1 - from;
  }
}

// One segment run [a, a + len) of at most 32 keys, sorted stably by its
// pair in one warp: lane l takes key a + l and counts the run's keys that
// go before it. The key and its source index go straight to the final
// buffers. Every lane of the warp must call it.
__device__ __forceinline__ void short_run_sort(const uint32_t* __restrict__ keys, int a, int len,
                                               int shift, int bits, uint32_t* fk,
                                               uint16_t* fi) {
  const int lane = threadIdx.x & 31;
  const bool valid = lane < len;
  const uint32_t w = valid ? keys[a + lane] : 0u;
  const uint32_t p = pair_of(w, shift, bits);
  int pos = 0;
  for (int j = 0; j < len; ++j) {
    const uint32_t q = __shfl_sync(kFull, p, j);
    pos += q < p || (q == p && j < lane);
  }
  if (valid) {
    fk[a + pos] = w;
    fi[a + pos] = static_cast<uint16_t>(a + lane);
  }
}

// Sort the tile by (segment run, pair), stably, into the final buffers
// kb[fin], ib[fin] (fin = the number of stages mod 2): load the keys and
// their positions into buffer 0, sort runs of at most 32 keys in one warp
// each (segmented), sweep the longer runs one after another. Returns fin.
// Every thread of the block must call it.
template <bool kSeg, bool kPacked>
__device__ __forceinline__ int sort_tile_by_pair(const uint32_t* __restrict__ k, int T,
                                                 const int* runs, int nruns, int shift,
                                                 int bits, int sub, uint32_t* const* kb,
                                                 uint16_t* const* ib, const StageSmem& S) {
  const int fin = ((bits + sub - 1) / sub) & 1;
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    kb[0][j] = k[j];
    ib[0][j] = static_cast<uint16_t>(j);
  }
  __syncthreads();
  if (kSeg) {                                        // short runs: one warp each
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < nruns; r += kWarps) {
      const int a = runs[r], len = runs[r + 1] - a;
      if (len <= kShortRun) short_run_sort(k, a, len, shift, bits, kb[fin], ib[fin]);
    }
  }
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (kSeg && len <= kShortRun) continue;
    sweep_range<kPacked>(kb, ib, a, len, shift, bits, sub, S);
  }
  __syncthreads();
  return fin;
}

// Walk the sorted tile (keys fk) in warp rounds, in order, and call
// emit(p, cg, rank) for every position p: cg = seg·m² + pair is the key's
// cell and rank its stable rank in the cell, p minus the head of the cell's
// run. A head is the tile's first key or a key whose (segment, pair)
// differs from the key before it; the segment of position p is seg[p],
// since sorting never moves a key out of its run. Warp w walks rounds [w·R,
// (w + 1)·R) and carries the last head it saw; its carry-in is the last
// head of the warps before it (wlast holds kWarps ints). Every thread of
// the block must call it.
template <bool kSeg, typename Emit>
__device__ __forceinline__ void walk_cells(const uint32_t* fk, const int* __restrict__ seg, int T,
                                           int s, int shift, int bits, int* wlast, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = (T + 31) >> 5, R = rounds_per_warp(T);
  const int r0 = warp * R, r1 = min(r0 + R, nr);
  auto is_head = [&](int p) -> bool {
    if (p == 0) return true;
    if (kSeg && seg[p] != seg[p - 1]) return true;
    return pair_of(fk[p], shift, bits) != pair_of(fk[p - 1], shift, bits);
  };
  int last = -1;                                     // this warp's last head
  for (int rd = r1 - 1; rd >= r0 && last < 0; --rd) {
    const int p = (rd << 5) + lane;
    const unsigned heads = __ballot_sync(kFull, p < T && is_head(p));
    if (heads) last = (rd << 5) + 31 - __clz(heads);
  }
  if (lane == 0) wlast[warp] = last;
  __syncthreads();
  int carry = -1;
  for (int w = 0; w < warp; ++w) carry = max(carry, wlast[w]);
  const unsigned lanemask_le = (2u << lane) - 1u;
  const uint32_t m2 = 1u << bits;
  for (int rd = r0; rd < r1; ++rd) {
    const int p = (rd << 5) + lane;
    const bool valid = p < T;
    const unsigned heads = __ballot_sync(kFull, valid && is_head(p));
    const unsigned mine = heads & lanemask_le;
    const int head = mine ? (rd << 5) + 31 - __clz(mine) : carry;
    if (heads) carry = (rd << 5) + 31 - __clz(heads);
    if (valid) {
      const size_t cg = (kSeg ? static_cast<size_t>(seg_at(seg, p, s)) * m2 : 0) +
                        pair_of(fk[p], shift, bits);
      emit(p, cg, p - head);
    }
  }
  __syncthreads();
}

}  // namespace ms
