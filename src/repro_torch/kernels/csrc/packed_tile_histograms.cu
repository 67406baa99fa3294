// K1p: per-tile histograms from packed 8-bit subword counters (the packed
// prescan, paper §4.3).
//
// Replaces packed_tile_histograms_pallas
// (src/repro/kernels/multisplit_tile.py:662), whose body is packed_counts
// (src/repro/kernels/common.py:357). One kernel body, four forms: the labels
// are computed in the kernel from a declarative spec (the ten label
// arguments) or read from a materialised int32 ids strip under the identity
// label (min(max(id, 0), m - 1), the clamp form); the layout is flat, or
// segmented over the combined id cid = seg·m + b with an (L, T) int32
// segment strip that never decreases along a tile (a template flag).
//
// keys or ids (L, T) [+ seg (L, T)] -> hist (L, s·m) int32 (s = 1 flat).
//
// Bound: memory. It reads 4 bytes a key (or id) and writes the row, 4·s·m
// bytes a tile; of the strip it needs the two end ids of a tile of one
// segment run and all T ids of any other tile: (4·L·T + 4·L·m) bytes flat
// and (4·L·T + 4·L·s·m + 8·L1 + 4·T·L2) segmented (L1 the tiles of one run,
// L2 the others) over 3.35 TB/s on an H100 SXM: the bytes of K1 and K1s at
// equal shapes. The counters stay in shared memory.
//
// Design for Hopper: K1's order-free count (tile_histograms.cu), and K1s's
// window of segments (seg_tile_histograms.cu), on the packed family's
// counters. A histogram is order-free, so K1p ranks nothing and lists no
// runs; the subtile `sub` only bounds the JAX kernel's own lanes, and the
// count does not depend on it.
// * Persistent blocks of 512 threads, as many as fit on the card at once
//   (flat, four an SM up to T = 4096 at 32 registers, as K1; segmented,
//   three, whose instances spilled at 32 registers); block k counts tiles
//   k, k + gridDim.x, ... Each thread holds its keys of a tile in
//   registers (kVec 16-byte vectors; one 4-byte load a key where the rows
//   are off 16 bytes) and starts the next tile's loads as soon as the
//   current row is written. Labels take the cheapest form the spec allows
//   (multisplit_sm90.cuh).
// * Counters: the packed family's (the JAX packed_counts, which sums each
//   subtile's packed words and unpacks once). A copy of a window's counters
//   is ⌈words/4⌉ 32-bit words, four 8-bit lanes to a word, at the odd
//   stride ⌈words/4⌉ | 1; lane l of warp w adds 1 << 8·(c mod 4) to word
//   c / 4 of copy l + 32·(w mod kGroups) (a shared atomicAdd), so no two
//   lanes of a warp share a copy. At m = 256 a copy is 65 words: 32 copies
//   take 2080, about what K1's 8 int32 copies take (2056).
// * The lane cap: a lane may take at most 255 adds between two unpacks. A
//   lane of a copy is hit only by the threads that share the copy, each
//   with its 4·kVec keys of the tile: (16 / kGroups)·4·kVec adds at most,
//   when every key of the tile is in one bucket. With one copy a lane (32
//   copies) that is 16·16 = 256 at T = 8192 (kVec = 4), one too many, so
//   those tiles take two copies a lane (kGroups = 2, 64 copies): 128 at
//   most, as at T = 4096 with 32 copies (static_assert below).
// * The unpack, once a tile (a window): thread j takes word j of every copy,
//   zeroes it, and adds its even and its odd bytes into two accumulators of
//   two 16-bit lanes each (a tile's count of a bucket is at most 8192), so
//   one thread writes four columns of the row, 16 bytes a store where m % 4
//   == 0.
// * Segmented: the tile's clamped ids lie in [lo, hi], the ids at its two
//   ends, copied into shared memory a tile ahead by cp.async as K1s does. A
//   tile of one run (lo == hi) reads no other id: its count is the flat
//   count, written at column lo·m. Any other tile counts each key at (seg -
//   lo)·m + b of the window's counters; a window holds as many whole
//   segments as a copy's words allow (kSetWords / copies words), and a tile
//   of more segments walks its windows in order, each thread counting those
//   of its keys whose segment falls in the window.
// * Each row written once: the window's columns from the unpack and zeros
//   outside [lo·m, (hi + 1)·m), 16 bytes a store where s·m % 4 == 0.
// * Two sets of counters, used by turns: the unpack of tile i's set runs
//   while tile i + 1 counts into the other, so one barrier a tile (one more
//   a window past the first) separates the phases.
// * A strip outside the contract reads and writes nothing out of bounds:
//   each id is clamped into [lo, hi] and lo, hi into [0, s).
#include "multisplit_sm90.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSetWords = 4160;                      // a set of copies: 64 x 65, or 32 x 130

// copies a lane (kGroups) and the blocks an SM the registers must allow:
// K1's four at T <= 4096 flat, two above; three for the segmented forms at
// T <= 4096, whose instances spill at the 32 registers of four
template <int kVec>
__host__ __device__ constexpr int groups() {
  return kVec == 4 ? 2 : 1;
}
template <int kVec, bool kSeg>
__host__ __device__ constexpr int min_blocks() {
  return kVec == 4 ? 2 : (kSeg ? 3 : 4);
}

template <int kVec>
__host__ __device__ constexpr int lane_cap() {
  return (kThreads / 32 / groups<kVec>()) * 4 * kVec;
}
static_assert(lane_cap<1>() <= 255 && lane_cap<2>() <= 255 && lane_cap<4>() <= 255,
              "a lane of a copy takes at most 255 adds a tile");

template <int kVec, int kForm, bool kSeg>
__global__ void __launch_bounds__(kThreads, min_blocks<kVec, kSeg>())
    packed_tile_histograms_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                                  int* __restrict__ hist, int n_tiles, int T, int s,
                                  sm90::Label F, bool vec, bool vec_row) {
  extern __shared__ uint32_t cnt[];                  // [2][kSetWords]
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int2 ends[2];                           // a tile's end ids, beside its set
  constexpr int kCopies = 32 * groups<kVec>();
  constexpr int kCopyWords = kSetWords / kCopies;    // words a copy may take
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = F.L.m;
  const int width = s * m;                           // < 2^31, the wrapper's check
  // whole segments a window: ⌈per·m / 4⌉ | 1 <= kCopyWords
  const int per = max(1, 4 * ((kCopyWords - 1) | 1) / m);
  const int copy = lane + 32 * ((tid >> 5) & (groups<kVec>() - 1));
  const bool vec_out = (m & 3) == 0 && vec_row;      // every window's columns 16-byte aligned
  ms::load_splitters(F.L, sp);
  for (int j = tid; j < 2 * kSetWords; j += kThreads) cnt[j] = 0u;

  // a tile's keys into registers; with kSeg, the end ids of the tile after
  // it into ends[set ^ 1], waited for before the barrier that ends its own
  // tile's count
  uint32_t cur[4 * kVec];
  auto load = [&](int tile, int set) {
    sm90::load_keys<kVec, kThreads>(cur, keys + static_cast<size_t>(tile) * T, T, vec);
    const int after = tile + static_cast<int>(gridDim.x);
    if (kSeg && tid == 0 && after < n_tiles) {
      const int* sa = segs + static_cast<size_t>(after) * T;
      sm90::copy4(&ends[set ^ 1].x, sa);
      sm90::copy4(&ends[set ^ 1].y, sa + T - 1);
    }
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) {
    if (kSeg && tid == 0) {
      const int* s0 = segs + static_cast<size_t>(blockIdx.x) * T;
      ends[0] = make_int2(s0[0], s0[T - 1]);
    }
    load(blockIdx.x, 0);
  }
  __syncthreads();                                   // counters zero, splitters and ends[0] in

  int set = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, set ^= 1) {
    // the tile's clamped end ids (0 and 0 flat)
    const int lo = kSeg ? min(max(ends[set].x, 0), s - 1) : 0;
    const int hi = kSeg ? max(lo, min(ends[set].y, s - 1)) : 0;
    uint32_t* const base = cnt + set * kSetWords;
    int* const row = hist + static_cast<size_t>(tile) * width;
    const int* const sg = kSeg ? segs + static_cast<size_t>(tile) * T : nullptr;
    const int nwin = (hi - lo) / per + 1;
    for (int w = 0; w < nwin; ++w) {
      const int wlo = lo + w * per, wn = min(per, hi + 1 - wlo);
      const int words = wn * m, pw = (words + 3) >> 2, stride = pw | 1;
      uint32_t* const mine = base + copy * stride;
      if (w) __syncthreads();                        // the last window's sums are taken
      if (!kSeg || lo == hi) {
        sm90::count_keys<kVec, kThreads, kForm>(cur, T, F, sp, [&](int, int b) {
          atomicAdd(mine + (b >> 2), 1u << ((b & 3) << 3));
        });
      } else {
        sm90::count_keys<kVec, kThreads, kForm>(cur, T, F, sp, [&](int e, int b) {
          const int q = min(max(__ldg(sg + e), lo), hi) - wlo;
          const int c = q * m + b;
          if (q >= 0 && q < wn) atomicAdd(mine + (c >> 2), 1u << ((c & 3) << 3));
        });
      }
      if (kSeg) sm90::copy_wait_all();               // the next tile's end ids
      __syncthreads();                               // the window's counts are whole

      // zeros outside the tile's columns [lo·m, (hi + 1)·m), once a row
      if (kSeg && w == 0) {
        const unsigned r0 = lo * m, r1 = (hi + 1) * m;
        if (vec_row) {
          const int4 zero = make_int4(0, 0, 0, 0);
          for (unsigned v = tid; v < static_cast<unsigned>(width) / 4; v += kThreads)
            if (4 * v + 4 <= r0 || 4 * v >= r1) reinterpret_cast<int4*>(row)[v] = zero;
          for (unsigned c = (r0 & ~3u) + tid; c < r0; c += kThreads) row[c] = 0;
          for (unsigned c = r1 + tid; c < ((r1 + 3) & ~3u); c += kThreads) row[c] = 0;
        } else {
          for (unsigned c = tid; c < static_cast<unsigned>(width); c += kThreads)
            if (c < r0 || c >= r1) row[c] = 0;
        }
      }
      // the unpack: word j of every copy, zeroed, its even and odd bytes
      // summed in 16-bit lanes; four columns a thread
      int* const out = row + wlo * m;
      for (int j = tid; j < pw; j += kThreads) {
        uint32_t even = 0u, odd = 0u;
#pragma unroll 8
        for (int c = 0; c < kCopies; ++c) {
          const uint32_t x = base[c * stride + j];
          base[c * stride + j] = 0u;
          even += x & 0x00ff00ffu;
          odd += (x >> 8) & 0x00ff00ffu;
        }
        const int4 v = make_int4(static_cast<int>(even & 0xffffu), static_cast<int>(odd & 0xffffu),
                                 static_cast<int>(even >> 16), static_cast<int>(odd >> 16));
        if (vec_out) {
          reinterpret_cast<int4*>(out)[j] = v;
        } else {
          const int c = 4 * j;
          out[c] = v.x;
          if (c + 1 < words) out[c + 1] = v.y;
          if (c + 2 < words) out[c + 2] = v.z;
          if (c + 3 < words) out[c + 3] = v.w;
        }
      }
    }
    const int next = tile + static_cast<int>(gridDim.x);
    if (next < n_tiles) load(next, set ^ 1);
  }
}

template <int kVec, int kForm, bool kSeg>
int launch(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s,
           const sm90::Label& F, bool vec, bool vec_row, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * 2 * static_cast<size_t>(kSetWords);
  auto kernel = packed_tile_histograms_kernel<kVec, kForm, kSeg>;
  cudaError_t err = ms::allow_smem(kernel, smem);
  if (err == cudaSuccess && sm90::report(kernel, kThreads, 1, smem, &err))
    return static_cast<int>(err);
  int blocks = 0;
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const uint32_t*>(keys),
                                             static_cast<const int*>(segs),
                                             static_cast<int*>(hist), n_tiles, T, s, F, vec,
                                             vec_row);
  return static_cast<int>(cudaGetLastError());
}

template <int kVec, bool kSeg>
int launch_form(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s,
                const sm90::Label& F, bool vec, bool vec_row, cudaStream_t stream) {
  if (F.form == sm90::kShiftMask)
    return launch<kVec, sm90::kShiftMask, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row,
                                                stream);
  if (F.form == sm90::kClampedId)
    return launch<kVec, sm90::kClampedId, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row,
                                                stream);
  return launch<kVec, sm90::kAnySpec, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row,
                                            stream);
}

template <bool kSeg>
int launch_tile(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s,
                const sm90::Label& F, bool vec, bool vec_row, cudaStream_t stream) {
  if (T <= 4 * kThreads)
    return launch_form<1, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, stream);
  if (T <= 8 * kThreads)
    return launch_form<2, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, stream);
  return launch_form<4, kSeg>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, stream);
}

}  // namespace

// keys: the key words (labels in the kernel, ids null) or null (labels from
// ids, under the identity label arguments: the clamp form). segs: the
// segment strip, or null for the flat layout (s = 1). sub: the subtile of
// the JAX kernel's lanes, 1 to 255 keys; the count does not depend on it.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py), m outside [1, 256], no segment or a row
// of 2^31 counts or more.
extern "C" int ms_packed_tile_histograms(const void* keys, const void* ids, const void* segs,
                                         void* hist, int n_tiles, int T, int s, int sub,
                                         MS_LABEL_PARAMS, void* stream) {
  (void)sub;
  if (n_tiles == 0) return 0;
  if (T < 1 || T > 4 * 4 * kThreads || m < 1 || m > ms::kMaxBuckets || s < 1 ||
      static_cast<long long>(s) * m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  const void* x = keys ? keys : ids;
  const bool vec = sm90::rows_aligned(T, x);
  const bool vec_row = (s * m) % 4 == 0 && reinterpret_cast<uintptr_t>(hist) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return segs ? launch_tile<true>(x, segs, hist, n_tiles, T, s, F, vec, vec_row, st)
              : launch_tile<false>(x, segs, hist, n_tiles, T, s, F, vec, vec_row, st);
}
