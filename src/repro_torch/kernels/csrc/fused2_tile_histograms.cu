// K1f: the fused two-digit prescan: per-tile histograms over the combined
// pair digit pair = (u >> shift) & (m² - 1), m² = 2^bits, or over the cell
// cg = seg·m² + pair with a segment strip.
//
// Replaces fused2_tile_histograms_pallas
// (src/repro/kernels/multisplit_tile.py:863), whose body is
// fused2_counts_body (src/repro/kernels/common.py:493). One kernel body, two
// forms (a template flag): flat, or segmented over a segment strip of
// (L, T) int32 ids.
//
// keys (L, T) 32-bit integer words [, seg (L, T) int32] -> (L, s·m²) int32
// histograms. The counts are built in shared memory and each row is written
// once: no zero pass in device memory, no global atomic.
//
// * Counters: 16 bits, two cells to a 32-bit word (cell c in word c >> 1,
//   the low half for even c). A tile holds at most kMaxTile = 8192 keys
//   (MAX_TILE of multisplit_tile.py, which the wrapper checks on every
//   launch and this entry point checks again), so no count reaches 2^16 and
//   no half carries into its neighbour. The widest pair (m² = 65536 cells)
//   takes 128 KB, which fits one block's 227 KB.
// * Counting: each warp groups its 32 keys by cell with __match_any_sync;
//   the group's leader adds the group's size to the cell's half with one
//   shared atomicAdd of size << 16·(cell & 1). A tile whose keys fall in one
//   cell makes 256 adds, not 8192.
// * Writing: each thread reads two words (four cells), widens each half to
//   int32 and writes them as one coalesced 16-byte store (8-byte stores of
//   one word at m² = 2), and zeroes the words for the next use.
// * Windows of whole segments: a block counts `win` segments at once,
//   win·m² <= 65536 cells (win = 1 at 16-bit pairs, all s segments where
//   s·m² fits). It finds the lowest and highest segment of the tile, counts
//   and writes each window between them, and writes zeros straight to the
//   slices of the windows outside. Segment ids never decrease along a tile
//   (the plan layer makes them so), so a tile touches one or two windows at
//   F3's shape; a strip that breaks the rule still counts right. The bytes
//   written are the row either way.
// * Blocks: 1024 threads, persistent (as many as fit on the card, each
//   walking tiles L apart), with the tile's keys in registers, 8 a thread.
//   At 16-bit pairs a block's 128 KB leaves one block an SM, so the block is
//   as wide as a block may be, and the next tile's keys are loaded before
//   the current row's stores are issued: the stores of one tile overlap the
//   loads and counting of the next. Smaller pairs fit more blocks an SM.
//
// Bound: memory. It reads 4 bytes a key [and 4 of segment id] and writes
// the whole (L, s·m²) row of H: (4·L·T [+ 4·L·T] + 4·L·s·m²) bytes over
// 3.35 TB/s on an H100 SXM. At r = 8 the row dominates: 1 GiB of H at n =
// 2^25 in tiles of 8192 keys against 128 MiB of keys.
#include "multisplit_fused2.cuh"

namespace {

constexpr int kBlock = 1024;                           // threads a block
constexpr int kMaxTile = 8192;                         // MAX_TILE of multisplit_tile.py
constexpr int kPerThread = kMaxTile / kBlock;          // a tile's keys in registers
constexpr int kWindowCells = 1 << ms::kMaxPairBits;    // 16-bit counters: 128 KB
constexpr uint32_t kNone = 0xffffffffu;                // a key outside the window
static_assert(kMaxTile < (1 << 16), "a 16-bit counter must hold any count of one tile");
static_assert(kMaxTile % kBlock == 0, "a tile's keys must spread evenly over the threads");

// zeros over `cells` int32 of a row slice (16-byte stores when m² % 4 == 0)
__device__ __forceinline__ void store_zeros(int* out, size_t cells, bool wide) {
  if (wide) {
    int4* out4 = reinterpret_cast<int4*>(out);
    for (size_t w = threadIdx.x; w < cells / 4; w += kBlock) out4[w] = make_int4(0, 0, 0, 0);
  } else {
    int2* out2 = reinterpret_cast<int2*>(out);
    for (size_t w = threadIdx.x; w < cells / 2; w += kBlock) out2[w] = make_int2(0, 0);
  }
}

// the counters of `cells` cells widened to int32 into a row slice, and zeroed
__device__ __forceinline__ void store_counts(int* out, uint32_t* cnt, size_t cells, bool wide) {
  if (wide) {
    int4* out4 = reinterpret_cast<int4*>(out);
    uint2* cnt2 = reinterpret_cast<uint2*>(cnt);
    for (size_t w = threadIdx.x; w < cells / 4; w += kBlock) {
      const uint2 x = cnt2[w];
      cnt2[w] = make_uint2(0u, 0u);
      out4[w] = make_int4(static_cast<int>(x.x & 0xffffu), static_cast<int>(x.x >> 16),
                          static_cast<int>(x.y & 0xffffu), static_cast<int>(x.y >> 16));
    }
  } else {
    int2* out2 = reinterpret_cast<int2*>(out);
    for (size_t w = threadIdx.x; w < cells / 2; w += kBlock) {
      const uint32_t x = cnt[w];
      cnt[w] = 0u;
      out2[w] = make_int2(static_cast<int>(x & 0xffffu), static_cast<int>(x >> 16));
    }
  }
}

template <bool kSeg>
__global__ void __launch_bounds__(kBlock, 1)
    fused2_tile_histograms_kernel(const uint32_t* __restrict__ keys,
                                  const int* __restrict__ segs, int* __restrict__ hist,
                                  int n_tiles, int T, int s, int shift, int bits, int win) {
  extern __shared__ uint32_t cnt[];                  // win·m² / 2 words
  __shared__ int wlo[kBlock / 32], whi[kBlock / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t m2 = 1u << bits;
  const size_t width = static_cast<size_t>(s) * m2;
  const bool wide = (m2 & 3u) == 0;                  // rows and slices of whole int4s
  for (uint32_t w = tid; w < static_cast<uint32_t>(win) * m2 / 2; w += kBlock) cnt[w] = 0u;

  uint32_t key[kPerThread];
  int seg[kPerThread];
  auto load = [&](int tile) {
    const size_t base = static_cast<size_t>(tile) * T;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = tid + j * kBlock;
      if (i < T) {
        key[j] = keys[base + i];
        if (kSeg) seg[j] = ms::seg_at(segs + base, i, s);
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) load(blockIdx.x);
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int lo = 0, hi = 0;                              // the tile's segments
    if (kSeg) {
      int mn = s, mx = -1;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (tid + j * kBlock < T) {
          mn = min(mn, seg[j]);
          mx = max(mx, seg[j]);
        }
      mn = __reduce_min_sync(ms::kFull, mn);
      mx = __reduce_max_sync(ms::kFull, mx);
      if (lane == 0) {
        wlo[tid >> 5] = mn;
        whi[tid >> 5] = mx;
      }
      __syncthreads();
      lo = s;
      hi = -1;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) {
        lo = min(lo, wlo[w]);
        hi = max(hi, whi[w]);
      }
    }
    int* row = hist + static_cast<size_t>(tile) * width;
    const int next = tile + static_cast<int>(gridDim.x);
    for (int a = 0; a < s; a += win) {
      const int wn = min(win, s - a);
      const size_t cells = static_cast<size_t>(wn) * m2;
      int* out = row + static_cast<size_t>(a) * m2;
      if (a > hi || a + wn <= lo) {                  // no key of the tile in this window
        store_zeros(out, cells, wide);
        continue;
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        uint32_t cell = kNone;
        if (tid + j * kBlock < T && (!kSeg || (seg[j] >= a && seg[j] < a + wn)))
          cell = (kSeg ? static_cast<uint32_t>(seg[j] - a) * m2 : 0u) +
                 ms::pair_of(key[j], shift, bits);
        const unsigned peers = __match_any_sync(ms::kFull, cell);
        if (cell != kNone && lane == __ffs(peers) - 1)
          atomicAdd(&cnt[cell >> 1], static_cast<uint32_t>(__popc(peers)) << (16 * (cell & 1u)));
      }
      __syncthreads();                               // the window's counts are whole
      if (a + wn > hi && next < n_tiles) load(next); // the tile's last window: fetch the next
      store_counts(out, cnt, cells, wide);
      __syncthreads();                               // the counters are zero again
    }
  }
}

template <bool kSeg>
int launch(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s, int shift,
           int bits, void* stream) {
  const int m2 = 1 << bits;
  const int fit = kWindowCells / m2 > 1 ? kWindowCells / m2 : 1;   // whole segments a window
  const int win = s < fit ? s : fit;
  const size_t smem = static_cast<size_t>(win) * m2 / 2 * sizeof(uint32_t);
  auto kernel = fused2_tile_histograms_kernel<kSeg>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && sm90::report(kernel, kBlock, 1, smem, &err))
    return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm > 1 ? per_sm : 1) * sms;
  const int blocks = n_tiles < resident ? n_tiles : static_cast<int>(resident);
  kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs), static_cast<int*>(hist),
      n_tiles, T, s, shift, bits, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: the segment strip, or null for the flat layout (s = 1). The pair is
// `bits` wide at `shift` (1 <= bits <= 16, shift + bits <= 32), T at most
// kMaxTile and hist 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int ms_fused2_tile_histograms(const void* keys, const void* segs, void* hist,
                                         int n_tiles, int T, int s, int shift, int bits,
                                         void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || s < 1 || bits < 1 || bits > ms::kMaxPairBits ||
      reinterpret_cast<uintptr_t>(hist) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return segs ? launch<true>(keys, segs, hist, n_tiles, T, s, shift, bits, stream)
              : launch<false>(keys, segs, hist, n_tiles, T, s, shift, bits, stream);
}
