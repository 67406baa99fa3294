// K1p: per-tile histograms from packed 8-bit subword counters (the packed
// prescan, paper §4.3).
//
// Replaces packed_tile_histograms_pallas
// (src/repro/kernels/multisplit_tile.py:662). One kernel body, four forms,
// chosen by two template flags as the JAX kernel's static flags choose
// them: the labels are computed in the kernel from a declarative spec (the
// ten label arguments) or read from a materialised int32 ids strip
// (clamped into [0, m), label_at); the layout is flat, or segmented over
// the combined id cid = seg·m + b with an (L, T) int32 segment strip that
// never decreases along a tile.
//
// keys or ids (L, T) [+ seg (L, T)] -> hist (L, s·m) int32 (s = 1 flat).
// One block per tile. Each warp counts its subtiles on packed words and
// flushes them into its int32 row (multisplit_packed.cuh); the tile's count
// of b is the sum of the 8 rows, with no scan (the JAX packed_counts). The
// segmented form first writes its whole (s·m) row with zeros, then counts
// each segment run into its own m columns: a short run by one warp, whose
// bucket groups store their size, a longer one by the packed walk.
//
// Bound: memory. It reads 4 bytes a key (or id) [and 4 of segment id] and
// writes the row, 4·s·m bytes a tile: (4·L·T + 4·L·m) bytes flat and
// (8·L·T + 4·L·s·m) segmented, over 3.35 TB/s on an H100 SXM: the bytes of
// K1 and K1s at equal shapes. The counters stay in shared memory.
#include "multisplit_packed.cuh"

namespace {

template <bool kIds, bool kSeg>
__global__ void __launch_bounds__(ms::kThreads)
    packed_tile_histograms_kernel(const uint32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ ids, const int* __restrict__ segs,
                                  int* __restrict__ hist, int T, int s, int sub, ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* seg_runs = cnt + ms::kWarps * m;              // [T + 1] run starts (segmented)
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ uint32_t words[ms::kWarps * ms::kMaxWords];
  __shared__ int chunk[kSeg ? ms::kMaxChunks : 1];
  __shared__ int flat_runs[2];
  int* runs = kSeg ? seg_runs : flat_runs;
  const size_t tile = blockIdx.x;
  const size_t width = static_cast<size_t>(s) * m;
  const size_t base = tile * T;
  const uint32_t* k = keys + base;
  const uint32_t* id = kIds ? ids + base : nullptr;
  const int* seg = kSeg ? segs + base : nullptr;
  int* row = hist + tile * width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  if (kSeg)
    for (size_t j = threadIdx.x; j < width; j += blockDim.x) row[j] = 0;
  const int nruns = ms::tile_runs<kSeg>(seg, T, runs, chunk);   // synchronises

  if (kSeg) {                                        // short runs: one warp each
    for (int r = warp; r < nruns; r += ms::kWarps) {
      const int a = runs[r], len = runs[r + 1] - a;
      if (len > ms::kShortRun) continue;
      const ms::ShortRank x = ms::short_run_rank<kIds>(k, id, a, len, L, sp);
      if (x.b >= 0 && lane == __ffs(x.peers) - 1)
        row[static_cast<size_t>(ms::seg_at(seg, a, s)) * m + x.b] = __popc(x.peers);
    }
  }
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (kSeg && len <= ms::kShortRun) continue;
    ms::zero(cnt, ms::kWarps * m);
    __syncthreads();
    ms::packed_rank_range<false, false, kIds>(k + a, kIds ? id + a : nullptr, len, sub, L, sp,
                                              cnt, words, nullptr, nullptr);
    __syncthreads();
    int* out = row + (kSeg ? static_cast<size_t>(ms::seg_at(seg, a, s)) * m : 0);
    for (int b = threadIdx.x; b < m; b += blockDim.x) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < ms::kWarps; ++w) c += cnt[w * m + b];
      out[b] = c;
    }
    __syncthreads();                                 // the next run zeroes cnt
  }
}

template <bool kIds, bool kSeg>
int launch(const void* keys, const void* ids, const void* segs, void* hist, int n_tiles, int T,
           int s, int sub, const ms::Label& L, void* stream) {
  const size_t smem = sizeof(int) * (ms::kWarps * L.m + (kSeg ? static_cast<size_t>(T) + 1 : 0));
  cudaError_t err = ms::allow_smem(packed_tile_histograms_kernel<kIds, kSeg>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_tile_histograms_kernel<kIds, kSeg><<<n_tiles, ms::kThreads, smem,
                                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(segs), static_cast<int*>(hist), T, s, sub, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: the key words (labels in the kernel, ids null) or null (labels from
// ids, under the identity label arguments). segs: the segment strip, or
// null for the flat layout (s = 1). sub: the subtile, 1 to 255 keys.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_packed_tile_histograms(const void* keys, const void* ids, const void* segs,
                                         void* hist, int n_tiles, int T, int s, int sub,
                                         MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const void* x = keys ? keys : ids;                 // short runs read a word a key
  if (ids) {
    return segs ? launch<true, true>(x, ids, segs, hist, n_tiles, T, s, sub, L, stream)
                : launch<true, false>(x, ids, segs, hist, n_tiles, T, s, sub, L, stream);
  }
  return segs ? launch<false, true>(x, ids, segs, hist, n_tiles, T, s, sub, L, stream)
              : launch<false, false>(x, ids, segs, hist, n_tiles, T, s, sub, L, stream);
}
