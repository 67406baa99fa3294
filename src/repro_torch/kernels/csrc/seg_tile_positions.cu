// K3s: the segmented DMS postscan with labels in the kernel: global
// destinations G[cid] + rank in element order, cid = seg·m + b, with no
// reorder.
//
// Replaces seg_spec_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:544) and its BitfieldSpec instance
// seg_radix_tile_positions_pallas (src/repro/kernels/radix_pass.py:84).
// Launched on a materialised int32 ids strip as its keys under the identity
// label (min(max(id, 0), m - 1)), it is also seg_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:259).
//
// keys (L, T) 32-bit words, seg (L, T) int32 non-decreasing along each
// tile, G (L, s·m) int32 -> pos (L, T) int32. One block per tile, run by run
// (multisplit_segmented.cuh): a short run's keys read their base from G
// directly; a long run stages its m bases of G in shared memory and takes
// the flat K3 rank over the run. The rank counts the earlier keys of the
// same cid in the tile, which all lie in the same run. int32 throughout:
// the Pallas kernel adds G and the rank in float32, wrong from 2^24 on.
//
// Bound: memory. It reads 4 bytes a key, 4 of segment id and the G bases
// its keys hit (4 bytes for each distinct cid of a tile, the nonzeros of
// the tile's histogram row) and writes 4 bytes a key: (12·L·T + 4·nnz(H))
// bytes / 3.35 TB/s on an H100 SXM.
#include "multisplit_segmented.cuh"

namespace {

__global__ void __launch_bounds__(ms::kThreads)
    seg_tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                              const int* __restrict__ g, int* __restrict__ pos, int T, int s,
                              ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* sg = cnt + ms::kWarps * m;                    // [m]  this run's bases
  int* meta = sg + m;                                // [T]  rank << 9 | bucket
  int* runs = meta + T;                              // [T + 1] run starts
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int chunk[ms::kMaxChunks];
  const size_t tile = blockIdx.x;
  const uint32_t* k = keys + tile * T;
  const int* seg = segs + tile * T;
  const int* grow = g + tile * static_cast<size_t>(s) * m;
  int* out = pos + tile * T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  const int nruns = ms::find_runs(seg, T, runs, chunk);

  for (int r = warp; r < nruns; r += ms::kWarps) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (len > ms::kShortRun) continue;
    const ms::ShortRank x = ms::short_run_rank(k, nullptr, a, len, L, sp);
    if (lane < len)
      out[a + lane] = grow[static_cast<size_t>(ms::seg_at(seg, a, s)) * m + x.b] + x.rank;
  }
  const int mask = (1 << ms::kLabelBits) - 1;
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (len <= ms::kShortRun) continue;
    const int* gseg = grow + static_cast<size_t>(ms::seg_at(seg, a, s)) * m;
    ms::zero(cnt, ms::kWarps * m);
    for (int b = threadIdx.x; b < m; b += blockDim.x) sg[b] = gseg[b];
    __syncthreads();
    ms::rank_tile<true>(k + a, nullptr, len, L, sp, cnt, meta + a);
    __syncthreads();
    ms::warp_offsets(cnt, m);
    __syncthreads();
    const int R = ms::rounds_per_warp(len);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int v = meta[a + j];
      const int b = v & mask, w = (j >> 5) / R;
      out[a + j] = sg[b] + cnt[w * m + b] + (v >> ms::kLabelBits);
    }
    __syncthreads();                                 // the next run rewrites cnt and sg
  }
}

}  // namespace

extern "C" int ms_seg_tile_positions(const void* keys, const void* segs, const void* g, void* pos,
                                     int n_tiles, int T, int s, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const size_t smem = sizeof(int) * (ms::kWarps * m + m + 2 * static_cast<size_t>(T) + 1);
  cudaError_t err = ms::allow_smem(seg_tile_positions_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_tile_positions_kernel<<<n_tiles, ms::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs),
      static_cast<const int*>(g), static_cast<int*>(pos), T, s, L);
  return static_cast<int>(cudaGetLastError());
}
