// K1s: per-tile histograms of the combined id cid = seg·m + b, labels in
// the kernel (the segmented prescan).
//
// Replaces seg_spec_tile_histograms_pallas
// (src/repro/kernels/multisplit_tile.py:512) and its BitfieldSpec instance
// seg_radix_tile_histograms_pallas (src/repro/kernels/radix_pass.py:73).
// Launched on a materialised int32 ids strip as its keys under the identity
// label (min(max(id, 0), m - 1)), it is also seg_tile_histograms_pallas
// (src/repro/kernels/multisplit_tile.py:227).
//
// keys (L, T) 32-bit words, seg (L, T) int32 non-decreasing along each tile
// -> hist (L, s·m) int32.
//
// Bound: memory. It reads 4 bytes a key and writes the whole row, 4·s·m
// bytes a tile; of the strip it needs the two end ids of a tile of one
// segment run and all T ids of any other tile: (4·L·T + 4·L·s·m + 8·L1 +
// 4·T·L2) bytes / 3.35 TB/s on an H100 SXM, L1 the tiles of one run, L2 the
// others. At large s the row, mostly zeros, is most of it.
//
// Design for Hopper: K1's (tile_histograms.cu) over the tile's window of
// segments. A histogram is order-free, so K1s ranks nothing and lists no
// runs.
// * Persistent blocks of 512 threads, as many as fit on the card at once
//   (four an SM at T = 4096, 32 registers); block k counts tiles k, k +
//   gridDim.x, ... Each thread holds its keys of a tile in registers (kVec
//   16-byte vectors; one 4-byte load a key where the rows are off 16 bytes)
//   and issues the next tile's loads as soon as the current row is written.
// * Segment ids never decrease along a tile, so its clamped ids lie in
//   [lo, hi], the ids at its two ends. A tile of one run (lo == hi) reads no
//   more of the strip than those two words: its count is K1's count, written
//   at column lo·m of the row. Any other tile reads the id of each key.
//   The two end ids of the tile after next are copied into shared memory by
//   cp.async with the next tile's loads, a tile ahead of their use: held in
//   registers beside the keys, they made the T = 4096 instances spill at 32
//   registers and took 1-3 % longer (tools/k1sk3s_variants.py's build).
// * Counting: shared-memory atomicAdd at (seg - lo)·m + b into copies of
//   the window's counters, lane l adding into copy l % C, at the odd stride
//   words | 1; C as K1 picks it (C·stride <= 2056 words: 32 copies at m <=
//   63, 8 at m = 256, one for a wide window). The labels take the cheapest
//   form the spec allows (multisplit_sm90.cuh).
// * Windows: a set of counters holds kSetWords words, (kSetWords - 1) / m
//   segments. A tile of more segments (hundreds of tiny segments a tile)
//   walks its windows in order; each thread counts those of its keys whose
//   segment falls in the window, so every key is counted once.
// * Each row written once: thread j writes the sums of the window's columns
//   and zeros everywhere outside [lo·m, (hi + 1)·m), 16 bytes a store where
//   s·m % 4 == 0 (the plane is torch's, 16-byte aligned).
// * Two sets of counters, used by turns: the sums of tile i's set run while
//   tile i + 1 counts into the other, so one barrier a tile (one more a
//   window past the first) separates the phases.
// * A strip outside the contract reads and writes nothing out of bounds:
//   each id is clamped into [lo, hi] and lo, hi into [0, s).
#include "multisplit_sm90.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCopyWords = 2056;                     // K1's: copies while C·stride fits
constexpr int kSetWords = 4112;                      // a set of counters: the window

// blocks an SM the registers must allow: four at T <= 4096 (32 registers),
// as K1; three at T <= 2048, whose instances need 40; two above 4096
template <int kVec>
constexpr int min_blocks() {
  return kVec == 2 ? 4 : (kVec == 1 ? 3 : 2);
}

template <int kVec, int kForm>
__global__ void __launch_bounds__(kThreads, min_blocks<kVec>())
    seg_tile_histograms_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                               int* __restrict__ hist, int n_tiles, int T, int s, sm90::Label F,
                               bool vec, bool vec_row) {
  extern __shared__ int cnt[];                       // [2][kSetWords]
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int2 ends[2];                           // a tile's end ids, beside its set
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = F.L.m;
  const int width = s * m;                           // < 2^31, the wrapper's check
  const int per = (kSetWords - 1) / m;               // segments a window
  ms::load_splitters(F.L, sp);
  for (int j = tid; j < 2 * kSetWords; j += kThreads) cnt[j] = 0;

  // a tile's keys into registers; the end ids of the tile after it into
  // ends[set] (the slot its own tile read at its start), waited for before
  // the barrier that ends its own tile's count
  uint32_t cur[4 * kVec];
  auto load = [&](int tile, int set) {
    sm90::load_keys<kVec, kThreads>(cur, keys + static_cast<size_t>(tile) * T, T, vec);
    const int after = tile + static_cast<int>(gridDim.x);
    if (tid == 0 && after < n_tiles) {
      const int* sa = segs + static_cast<size_t>(after) * T;
      sm90::copy4(&ends[set ^ 1].x, sa);
      sm90::copy4(&ends[set ^ 1].y, sa + T - 1);
    }
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) {
    if (tid == 0) {
      const int* s0 = segs + static_cast<size_t>(blockIdx.x) * T;
      ends[0] = make_int2(s0[0], s0[T - 1]);
    }
    load(blockIdx.x, 0);
  }
  __syncthreads();                                   // counters zero, splitters and ends[0] in

  int set = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, set ^= 1) {
    // the tile's clamped end ids
    const int lo = min(max(ends[set].x, 0), s - 1);
    const int hi = max(lo, min(ends[set].y, s - 1));
    int* const base = cnt + set * kSetWords;
    int* const row = hist + static_cast<size_t>(tile) * width;
    const int* const sg = segs + static_cast<size_t>(tile) * T;
    const int nwin = (hi - lo) / per + 1;
    for (int w = 0; w < nwin; ++w) {
      const int wlo = lo + w * per, wn = min(per, hi + 1 - wlo);
      const int words = wn * m, stride = words | 1;
      const int copies = sm90::counter_copies(words, kCopyWords);
      int* const mine = base + (lane & (copies - 1)) * stride;
      if (w) __syncthreads();                        // the last window's sums are taken
      if (lo == hi) {
        sm90::count_keys<kVec, kThreads, kForm>(cur, T, F, sp,
                                                [&](int, int b) { atomicAdd(mine + b, 1); });
      } else {
        sm90::count_keys<kVec, kThreads, kForm>(cur, T, F, sp, [&](int e, int b) {
          const int q = min(max(__ldg(sg + e), lo), hi) - wlo;
          if (q >= 0 && q < wn) atomicAdd(mine + q * m + b, 1);
        });
      }
      sm90::copy_wait_all();                         // the next tile's end ids
      __syncthreads();                               // the window's counts are whole

      // zeros outside the tile's columns [lo·m, (hi + 1)·m), once a row
      if (w == 0) {
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
      // the window's columns: the sum over the copies, which are zeroed
      int* const out = row + wlo * m;
      for (int k = tid; k < words; k += kThreads) {
        int x = 0;
        for (int c = 0; c < copies; ++c) {
          x += base[c * stride + k];
          base[c * stride + k] = 0;
        }
        out[k] = x;
      }
    }
    const int next = tile + static_cast<int>(gridDim.x);
    if (next < n_tiles) load(next, set ^ 1);
  }
}

template <int kVec, int kForm>
int launch(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s,
           const sm90::Label& F, bool vec, bool vec_row, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(kSetWords);
  auto kernel = seg_tile_histograms_kernel<kVec, kForm>;
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

template <int kVec>
int launch_form(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s,
                const sm90::Label& F, bool vec, bool vec_row, cudaStream_t stream) {
  if (F.form == sm90::kShiftMask)
    return launch<kVec, sm90::kShiftMask>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row,
                                          stream);
  if (F.form == sm90::kClampedId)
    return launch<kVec, sm90::kClampedId>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row,
                                          stream);
  return launch<kVec, sm90::kAnySpec>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py), m outside [1, 256], no segment or a row
// of 2^31 counts or more.
extern "C" int ms_seg_tile_histograms(const void* keys, const void* segs, void* hist,
                                      int n_tiles, int T, int s, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > 4 * 4 * kThreads || m < 1 || m > ms::kMaxBuckets || s < 1 ||
      static_cast<long long>(s) * m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  const bool vec = sm90::rows_aligned(T, keys);
  const bool vec_row = (s * m) % 4 == 0 && reinterpret_cast<uintptr_t>(hist) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 4 * kThreads)
    return launch_form<1>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, st);
  if (T <= 8 * kThreads)
    return launch_form<2>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, st);
  return launch_form<4>(keys, segs, hist, n_tiles, T, s, F, vec, vec_row, st);
}
