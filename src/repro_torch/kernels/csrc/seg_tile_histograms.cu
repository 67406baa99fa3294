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
// -> hist (L, s·m) int32. One block per tile. The block first writes its
// whole (s·m) row with zeros, then counts each segment run of the tile
// (multisplit_segmented.cuh) into its own m columns with plain stores: a
// short run by one warp, whose bucket groups each store their size, a long
// run by the flat K1 walk over the run. No atomics.
//
// Bound: memory. It reads 4 bytes a key and 4 of segment id, and writes
// the whole row, 4·s·m bytes a tile: (8·L·T + 4·L·s·m) bytes / 3.35 TB/s on
// an H100 SXM. At large s the row, mostly zeros, is most of it.
#include "multisplit_segmented.cuh"

namespace {

__global__ void __launch_bounds__(ms::kThreads)
    seg_tile_histograms_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                               int* __restrict__ hist, int T, int s, ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* runs = cnt + ms::kWarps * m;                  // [T + 1] run starts
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int chunk[ms::kMaxChunks];
  const size_t tile = blockIdx.x;
  const size_t width = static_cast<size_t>(s) * m;
  const uint32_t* k = keys + tile * T;
  const int* sg = segs + tile * T;
  int* row = hist + tile * width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  for (size_t j = threadIdx.x; j < width; j += blockDim.x) row[j] = 0;
  const int nruns = ms::find_runs(sg, T, runs, chunk);   // synchronises: zeros land first

  for (int r = warp; r < nruns; r += ms::kWarps) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (len > ms::kShortRun) continue;
    const ms::ShortRank x = ms::short_run_rank(k, nullptr, a, len, L, sp);
    if (x.b >= 0 && lane == __ffs(x.peers) - 1)
      row[static_cast<size_t>(ms::seg_at(sg, a, s)) * m + x.b] = __popc(x.peers);
  }
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (len <= ms::kShortRun) continue;
    ms::zero(cnt, ms::kWarps * m);
    __syncthreads();
    ms::rank_tile<false, false>(k + a, nullptr, len, L, sp, cnt, nullptr, nullptr);
    __syncthreads();
    int* out = row + static_cast<size_t>(ms::seg_at(sg, a, s)) * m;
    for (int b = threadIdx.x; b < m; b += blockDim.x) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < ms::kWarps; ++w) c += cnt[w * m + b];
      out[b] = c;
    }
    __syncthreads();                                 // the next run zeroes cnt
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_seg_tile_histograms(const void* keys, const void* segs, void* hist,
                                      int n_tiles, int T, int s, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const size_t smem = sizeof(int) * (ms::kWarps * m + static_cast<size_t>(T) + 1);
  cudaError_t err = ms::allow_smem(seg_tile_histograms_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_tile_histograms_kernel<<<n_tiles, ms::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs), static_cast<int*>(hist),
      T, s, L);
  return static_cast<int>(cudaGetLastError());
}
