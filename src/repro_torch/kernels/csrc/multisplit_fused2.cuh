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
// * K1f counts in 16-bit halves instead, two cells to a word
//   (fused2_tile_histograms.cu, which takes pair_of and kMaxPairBits here).
// * K2f (fused2_fused_postscan_reorder.cu) and K3f
//   (fused2_tile_positions.cu) are one kernel body, postscan_kernel below,
//   K3f its positions-only form: the tile is sorted by (segment run, pair)
//   in shared memory, each key's stable rank in its cell (seg, pair) is its
//   position minus the head of the cell's run, and its global destination
//   is G[tile, seg·m² + pair] + rank. K2f writes keys, values and
//   destinations (seg, pair)-major within the tile and perm, the
//   element-order destination; K3f writes perm alone.
//
// Design for Hopper (the body of K2f and K3f).
// * Persistent blocks of 8 warps, two an SM at T = 8192: the shared
//   footprint is two key buffers and two 16-bit source-index buffers (12
//   bytes a key, 96 KB at T = 8192), the warps' counters and a word of
//   cell heads a round, about 110 KB; no plane of ranks. A lane holds up to
//   kR = 16 rounds of state (T <= 4096; 32 up to 8192) in registers.
// * Staging: the next tile's keys are copied into a third key buffer by
//   cp.async, during the current tile's walk and write-out, where that
//   costs no block an SM (sm90::pick_stages: T <= 4096); at T = 8192 the
//   tile's keys are copied at its start and the second resident block
//   provides the overlap.
// * The sweep: `sub` bits a stage (two stages for a 16-bit pair at sub =
//   8), each a stable split of the range by its sub-digit into the other
//   key buffer: the warps' contiguous rounds ranked in registers
//   (sm90::warp_rank with ballots over the sub bits, or the packed
//   family's sm90::packed_warp_rank on subtiles of 128 keys), eight rounds
//   at a time, a key's rank in its warp kept in 16 bits, two to a register
//   (its bucket is taken again from its word); one thread a bucket turning
//   the warp counters into bucket start + warp offset (one barrier for the
//   block scan); and each lane moving its keys' words and 16-bit source
//   indices to their slots, a round at a time. The first stage reads the
//   positions themselves as the indices. Four barriers a stage. The result
//   depends on neither the family nor the stage width.
// * Segmented tiles never sort by segment: a tile whose first and last
//   segment ids agree takes the flat path whole; otherwise chunk flags
//   split it into runs (ms::split_runs), a run of at most 32 keys is sorted
//   by one warp with shuffles straight into the final buffers, and a
//   longer one takes the sweep over its range. The segment strip is read
//   from device memory (coalesced), never staged.
// * The walks: after the sweep each cell (seg, pair) is one run of the
//   sorted tile, its bases ascending along it. A first walk over the warps'
//   rounds marks the runs' heads (one ballot word a round in shared memory)
//   and reads each key's base G[cell], 8 rounds' reads in flight at once,
//   into the free key buffer at the key's position: in sorted order the
//   reads of a warp fall in a few sectors. The second walk finds each key's
//   head in the round's word, or carries it across rounds and, through the
//   words, across warps: pos = base + p - head. Reading G once a cell run
//   (at the head lanes only, the base then read at the head's position,
//   where pos = base) took longer on an H100: at F1 nearly every key heads
//   its cell (8192 keys over 65536 pairs; tools/k2fk2p_variants.py).
// * Stores: perm is scattered by source index into the sorted key buffer
//   once the walk has read it, so it lies in element order, and leaves 16
//   bytes a store where the rows are aligned. K2f writes keys_r from the
//   sorted buffer before that, pos_r from the second walk's registers (a
//   128-byte line a warp) and, once the bases are read, copies the tile's
//   values into the free key buffer and gathers them there by source
//   index, four to a 16-byte store: gathering them from the row in device
//   memory took longer on an H100 (tools/k2fk2p_variants.py). K3f reads no
//   value and writes no keys_r or pos_r, so two barriers a tile go too.
// * Registers: every instance fits the 128 of two blocks an SM without a
//   spill. That took the 16-bit ranks, the walk's reads 8 rounds at a
//   time, a warp sync after each round's moves in a stage, and no array of
//   buffer pointers (one lives in local memory); ptxas's spills moved by
//   tens of bytes with each such change, so the build of chip_smoke.py
//   checks every instance.
// Everything is int32: G + rank is exact for every n < 2^31.
#pragma once

#include "multisplit_segmented.cuh"
#include "multisplit_sm90.cuh"

namespace ms {

constexpr int kMaxPairBits = 16;      // the widest pair of the fused schedule (m² = 65536)

__device__ __forceinline__ uint32_t pair_of(uint32_t w, int shift, int bits) {
  return (w >> shift) & ((1u << bits) - 1u);
}

}  // namespace ms

namespace fused2 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
constexpr int kMaxRounds = kMaxTile / 32;
constexpr int kMaxWords = ms::kMaxBuckets / 4;       // packed words a warp
constexpr int kStageSubtile = 128;                   // the packed stage's subtile (the JAX auto subtile)
constexpr int kChunk = 8;                            // rounds a stage ranks at a time
static_assert(kWarps == ms::kWarps, "the short runs of multisplit_segmented.cuh");

struct Layout {
  int pitch;          // words a key plane: T rounded up to 16 bytes
  int stages;         // 1, or 2: the next tile's keys staged in a third key buffer
};

// A value the compiler must take as changed here, so that nothing computed
// from it is hoisted above this point (and held in registers meanwhile).
__device__ __forceinline__ void opaque(int& x) { asm volatile("" : "+r"(x)); }

// The label of one sub-digit stage, `b` bits at `shift`: the shift form.
__device__ __forceinline__ sm90::Label stage_label(int shift, int b) {
  sm90::Label F;
  F.L.kind = ms::kBitfield;
  F.L.key_kind = ms::kU32;
  F.L.m = 1 << b;
  F.L.u0 = static_cast<unsigned>(shift);
  F.L.u1 = (1u << b) - 1u;
  F.L.f0 = F.L.f1 = 0.f;
  F.L.splitters = nullptr;
  F.L.n_split = 0;
  F.L.plane = 0;
  F.dshift = -1;
  F.form = sm90::kShiftMask;
  F.shift = F.L.u0;
  F.mask = F.L.u1;
  return F;
}

// One stable stage over the range [a, a + len) of the tile: the words of sk
// and their source indices (si, or the positions themselves when si is
// null) go to dk and di in the order of their sub-digit under F, stably.
// cnt holds kWarps·m ints, zero on entry and on exit; pw the packed lanes
// (zero on entry and exit). Every thread of the block must call it; it
// synchronises the block before it returns.
template <bool kPacked, int kR>
__device__ __forceinline__ void stage_sort(const uint32_t* sk, const uint16_t* si, uint32_t* dk,
                                           uint16_t* di, int a, int len, const sm90::Label& F,
                                           int* cnt, uint32_t* pw, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = F.L.m, nbits = sm90::label_bits(m);
  const int nr = (len + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
  const int r0 = warp * R, r1 = min(r0 + R, nr);
  int* const mine = cnt + warp * m;
  // the warp's rounds ranked kChunk at a time, the carry running on in the
  // counters; a key's rank in the warp (below 1024) kept in 16 bits, two to
  // a register, its bucket taken again from its word in the reorder
  uint32_t rk[kR / 2];
#pragma unroll
  for (int c = 0; c < kR; c += kChunk) {
    int meta[kChunk] = {};
    const int c0 = r0 + c, c1 = min(r1, c0 + kChunk);
    if (kPacked)
      sm90::packed_warp_rank<kChunk, sm90::kShiftMask>(sk + a, len, F, nullptr, mine, pw, c0, c1,
                                                       nbits, kStageSubtile, meta);
    else
      sm90::warp_rank<kChunk, sm90::kShiftMask>(sk + a, len, F, nullptr, mine, c0, c1, nbits,
                                                meta);
#pragma unroll
    for (int k = 0; k < kChunk; k += 2)
      rk[(c + k) >> 1] = static_cast<uint32_t>(meta[k] >> ms::kLabelBits) |
                         (static_cast<uint32_t>(meta[k + 1] >> ms::kLabelBits) << 16);
  }
  __syncthreads();

  // warp offsets and the range's bucket starts: thread b < m; the block
  // scan of the m counts takes one barrier
  int total = 0;
  if (tid < m) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * m + tid];
      cnt[w * m + tid] = total;
      total += c;
    }
  }
  int x = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(ms::kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (tid < m) {
    int first = a + x - total;
    for (int w = 0; w < warp; ++w) first += wsum[w];
    for (int w = 0; w < kWarps; ++w) cnt[w * m + tid] += first;
  }
  __syncthreads();

  // each lane's keys and indices to their slots in the other buffers
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ((r0 + r) << 5) + lane;
    if (r0 + r < r1 && i < len) {
      const uint32_t w = sk[a + i];
      const int rank = static_cast<int>((rk[r >> 1] >> (16 * (r & 1))) & 0xffffu);
      const int dest = mine[sm90::label_of<sm90::kShiftMask>(w, F, nullptr)] + rank;
      dk[dest] = w;
      di[dest] = si ? si[a + i] : static_cast<uint16_t>(a + i);
    }
    __syncwarp();                                    // a round at a time: fewer registers
  }
  for (int b = lane; b < m; b += 32) mine[b] = 0;   // the warp's own row, read by it alone
  __syncthreads();
}

// K2f (kPositions false) and K3f (kPositions true): see the notes above.
// K3f passes null vals, keys_r, vals_r and pos_r.
template <bool kSeg, bool kPacked, int kR, bool kPositions>
__global__ void __launch_bounds__(kThreads, 2)
    postscan_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                    const int* __restrict__ g, const uint32_t* __restrict__ vals,
                    uint32_t* __restrict__ keys_r, uint32_t* __restrict__ vals_r,
                    int* __restrict__ pos_r, int* __restrict__ perm, int n_tiles, int T, int s,
                    int shift, int bits, int sub, Layout Y, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int wsum[kWarps];
  __shared__ uint32_t words[kPacked ? kWarps * kMaxWords : 1];   // the 8-bit lanes
  __shared__ unsigned flags[kSeg ? ms::kMaxChunks : 1];   // run starts, one ballot a chunk
  __shared__ int2 longs[kSeg ? ms::kMaxLong : 1];    // the tile's long runs [a, e)
  __shared__ int n_long;
  // the sweep's key buffers 0 and 1 and source-index buffers 0 and 1, as
  // offsets from smem (no array of pointers: it would live in local memory)
  auto kb = [&](int x) { return smem + (x & 1) * Y.pitch; };
  uint32_t* const staged = smem + 2 * Y.pitch;       // the next tile's keys (two stages)
  uint16_t* const ib0 = reinterpret_cast<uint16_t*>(smem + (Y.stages + 1) * Y.pitch);
  auto ib = [&](int x) { return ib0 + (x & 1) * Y.pitch; };
  int* const cnt = reinterpret_cast<int*>(ib0 + 2 * Y.pitch);   // [kWarps][2^sub]
  unsigned* const hmask = reinterpret_cast<unsigned*>(cnt + kWarps * ms::kMaxBuckets);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_vals = !kPositions && vals != nullptr;
  const int nst = (bits + sub - 1) / sub;            // stages of the sweep
  uint32_t* const fk = kb(nst);                      // the sorted keys
  uint16_t* const fi = ib(nst - 1);                  // their source indices
  uint32_t* const free_k = kb(nst + 1);              // free once the tile is sorted
  uint32_t* const in = Y.stages == 2 ? staged : kb(0);   // the tile's keys in element order
  const unsigned lanemask_le = (2u << lane) - 1u;

  for (int j = tid; j < kWarps * ms::kMaxBuckets; j += kThreads) cnt[j] = 0;
  if (kPacked)
    for (int j = tid; j < kWarps * kMaxWords; j += kThreads) words[j] = 0u;
  if (Y.stages == 2 && static_cast<int>(blockIdx.x) < n_tiles)
    sm90::stage_row<kThreads>(staged, keys + static_cast<size_t>(blockIdx.x) * T, T, vec);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t base = static_cast<size_t>(tile) * T;
    const int nr = (T + 31) >> 5, R = (nr + kWarps - 1) / kWarps;   // the walks' rounds
    const int r0 = warp * R, r1 = min(r0 + R, nr);
    if (Y.stages == 1) {
      __syncthreads();                               // the previous tile's write-out is done
      sm90::stage_row<kThreads>(in, keys + base, T, vec);
    }
    sm90::copy_wait_all();
    __syncthreads();                                 // the tile's keys have landed
    const int* const seg = kSeg ? segs + base : nullptr;
    const int* const grow = g + static_cast<size_t>(tile) * (static_cast<size_t>(s) << bits);
    const int seg0 = kSeg ? ms::seg_at(seg, 0, s) : 0;
    const bool one_run = !kSeg || seg[0] == seg[T - 1];

    // 1. the sort by (segment run, pair) into fk, fi: short runs by one
    // warp each, the tile or each long run by the sweep
    int nl = 1;
    if (kSeg && !one_run) {
      nl = ms::split_runs(seg, T, flags, longs, &n_long, [&](int a, int len) {
        const bool valid = lane < len;
        const uint32_t w = valid ? in[a + lane] : 0u;
        const uint32_t p = ms::pair_of(w, shift, bits);
        int pos = 0;
        for (int j = 0; j < len; ++j) {
          const uint32_t o = __shfl_sync(ms::kFull, p, j);
          pos += o < p || (o == p && j < lane);
        }
        __syncwarp();                                // the run is read (fk may be `in`)
        if (valid) {
          fk[a + pos] = w;
          fi[a + pos] = static_cast<uint16_t>(a + lane);
        }
        __syncwarp();
      });
    }
#pragma unroll 1
    for (int q = 0; q < nl; ++q) {
      const int a = one_run ? 0 : longs[q].x, len = one_run ? T : longs[q].y - a;
#pragma unroll 1
      for (int j = 0; j < nst; ++j) {
        const int off = j * sub, b = min(sub, bits - off);
        int len_j = len;                             // a stage's own: nothing hoisted over stages
        opaque(len_j);
        stage_sort<kPacked, kR>(j ? kb(j) : in, j ? ib(j - 1) : nullptr, kb(j + 1), ib(j), a,
                                len_j, stage_label(shift + off, b),
                                cnt, kPacked ? words + warp * kMaxWords : nullptr, wsum);
      }
    }
    __syncthreads();                                 // the tile is sorted; `in` is free
    const int next = tile + static_cast<int>(gridDim.x);
    if (Y.stages == 2 && next < n_tiles)
      sm90::stage_row<kThreads>(staged, keys + static_cast<size_t>(next) * T, T, vec);

    // 2. the cell runs' heads, a ballot word a round, and each key's base
    // G[cell] into the free buffer at its position, the reads of 8 rounds
    // in flight before the first is stored
    auto seg_of = [&](int p) { return kSeg && !one_run ? ms::seg_at(seg, p, s) : seg0; };
    constexpr int kHalf = kR < 8 ? kR : 8;            // rounds whose reads fly together
#pragma unroll
    for (int h = 0; h < kR; h += kHalf) {
      int gv[kHalf];
#pragma unroll
      for (int r = h; r < h + kHalf; ++r) {
        if (r0 + r < r1) {
          const int p = ((r0 + r) << 5) + lane;
          const bool valid = p < T;
          const uint32_t c = valid ? ms::pair_of(fk[p], shift, bits) : 0u;
          const int sc = valid ? seg_of(p) : 0;
          uint32_t pc = __shfl_up_sync(ms::kFull, c, 1);
          int ps = __shfl_up_sync(ms::kFull, sc, 1);
          if (lane == 0 && p > 0) {
            pc = ms::pair_of(fk[p - 1], shift, bits);
            ps = seg_of(p - 1);
          }
          const bool head = valid && (p == 0 || c != pc || sc != ps);
          const unsigned hm = __ballot_sync(ms::kFull, head);
          if (lane == 0) hmask[r0 + r] = hm;
          const int* const at = grow + ((static_cast<size_t>(sc) << bits) + c);
          gv[r - h] = valid ? __ldg(at) : 0;
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = h; r < h + kHalf; ++r) {
        const int p = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && p < T)
          free_k[p] = static_cast<uint32_t>(gv[r - h]);
      }
    }
    __syncthreads();                                 // every head word and base is written

    // 3. keys_r from the sorted keys, 16 bytes a store where aligned
    if (!kPositions) {
      if (vec) {
        for (int v = tid; v < (T >> 2); v += kThreads)
          reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(fk)[v];
      } else {
        for (int j = tid; j < T; j += kThreads) keys_r[base + j] = fk[j];
      }
    }

    // the head of the cell run the warp's first key continues: the last
    // head before the warp's rounds
    int hc = 0;
    if (r0 < r1 && r0 > 0) {
      for (int top = r0 - 1; top >= 0; top -= 32) {
        const unsigned hm = top - lane >= 0 ? hmask[top - lane] : 0u;
        const unsigned nz = __ballot_sync(ms::kFull, hm != 0u);
        if (nz) {
          const int l = __ffs(nz) - 1;
          hc = ((top - l) << 5) + 31 - __clz(__shfl_sync(ms::kFull, hm, l));
          break;
        }
      }
    }
    if (!kPositions) __syncthreads();                // keys_r is out: fk takes perm

    // 4. pos = G[cell] + p - head: pos_r from registers (sorted order, a
    // 128-byte line a warp), and perm by source index into fk (element
    // order)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r < r1) {
        const int rd = r0 + r, p = (rd << 5) + lane;
        const unsigned hm = hmask[rd];
        const unsigned mh = hm & lanemask_le;
        const int head = mh ? (rd << 5) + 31 - __clz(mh) : hc;
        if (p < T) {
          const int pos = static_cast<int>(free_k[p]) + p - head;
          if (!kPositions) pos_r[base + p] = pos;
          fk[fi[p]] = static_cast<uint32_t>(pos);
        }
        if (hm) hc = (rd << 5) + 31 - __clz(hm);
      }
    }
    __syncthreads();                                 // every base is read: the values
    if (!kPositions) {
      if (has_vals) {
        sm90::stage_row<kThreads>(free_k, vals + base, T, vec);
        sm90::copy_wait_all();
      }
      __syncthreads();
    }

    // 5. perm rows, and vals_r gathered by source index from the values in
    // the free buffer, 16 bytes a store where aligned
    if (vec) {
      const int nv = T >> 2;
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(perm + base)[v] = reinterpret_cast<const uint4*>(fk)[v];
      if (has_vals) {
        for (int v = tid; v < nv; v += kThreads) {
          const ushort4 x = reinterpret_cast<const ushort4*>(fi)[v];
          reinterpret_cast<uint4*>(vals_r + base)[v] =
              make_uint4(free_k[x.x], free_k[x.y], free_k[x.z], free_k[x.w]);
        }
      }
    } else {
      for (int j = tid; j < T; j += kThreads) {
        perm[base + j] = static_cast<int>(fk[j]);
        if (has_vals) vals_r[base + j] = free_k[fi[j]];
      }
    }
  }
}

template <bool kSeg, bool kPacked, int kR, bool kPositions>
int launch_kernel(const void* keys, const void* segs, const void* g, const void* vals,
                  void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
                  int shift, int bits, int sub, cudaStream_t stream) {
  auto kernel = postscan_kernel<kSeg, kPacked, kR, kPositions>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  // two key buffers, two 16-bit index buffers, the counters, the head words
  const size_t one = sizeof(uint32_t) * (2 * static_cast<size_t>(Y.pitch) + Y.pitch +
                                         kWarps * ms::kMaxBuckets + kMaxRounds);
  const size_t two = one + sizeof(uint32_t) * static_cast<size_t>(Y.pitch);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  if (sm90::report(kernel, kThreads, Y.stages, smem, &err)) return static_cast<int>(err);
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, keys) && sm90::rows_aligned(T, vals) &&
                   sm90::rows_aligned(T, keys_r) && sm90::rows_aligned(T, vals_r) &&
                   sm90::rows_aligned(T, pos_r) && sm90::rows_aligned(T, perm);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs),
      static_cast<const int*>(g), static_cast<const uint32_t*>(vals),
      static_cast<uint32_t*>(keys_r), static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r),
      static_cast<int*>(perm), n_tiles, T, s, shift, bits, sub, Y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSeg, bool kPacked, bool kPositions>
int launch_rounds(const void* keys, const void* segs, const void* g, const void* vals,
                  void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
                  int shift, int bits, int sub, cudaStream_t stream) {
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps)
    return launch_kernel<kSeg, kPacked, 16, kPositions>(keys, segs, g, vals, keys_r, vals_r,
                                                        pos_r, perm, n_tiles, T, s, shift, bits,
                                                        sub, stream);
  return launch_kernel<kSeg, kPacked, 32, kPositions>(keys, segs, g, vals, keys_r, vals_r, pos_r,
                                                      perm, n_tiles, T, s, shift, bits, sub,
                                                      stream);
}

// The launch of K2f or K3f in the form the arguments choose: segs null for
// the flat layout (s = 1), packed for the packed stage rank. Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a tile the kernel does not take (T above 8192), a pair or stage width
// outside 1 <= bits <= 16, shift + bits <= 32, 1 <= sub <= 8, or no segment.
template <bool kPositions>
int launch(const void* keys, const void* segs, const void* g, const void* vals, void* keys_r,
           void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s, int shift, int bits,
           int sub, int packed, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || bits < 1 || bits > ms::kMaxPairBits || shift < 0 ||
      shift + bits > 32 || sub < 1 || sub > 8 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs) {
    return packed ? launch_rounds<true, true, kPositions>(keys, segs, g, vals, keys_r, vals_r,
                                                          pos_r, perm, n_tiles, T, s, shift, bits,
                                                          sub, st)
                  : launch_rounds<true, false, kPositions>(keys, segs, g, vals, keys_r, vals_r,
                                                           pos_r, perm, n_tiles, T, s, shift,
                                                           bits, sub, st);
  }
  return packed ? launch_rounds<false, true, kPositions>(keys, segs, g, vals, keys_r, vals_r,
                                                         pos_r, perm, n_tiles, T, s, shift, bits,
                                                         sub, st)
                : launch_rounds<false, false, kPositions>(keys, segs, g, vals, keys_r, vals_r,
                                                          pos_r, perm, n_tiles, T, s, shift, bits,
                                                          sub, st);
}

}  // namespace fused2
