// K1: per-tile bucket histograms with in-kernel labels (the prescan direct
// solve, paper Alg. 2).
//
// Replaces spec_tile_histograms_pallas (src/repro/kernels/multisplit_tile.py:368)
// and its BitfieldSpec instance radix_tile_histograms_pallas
// (src/repro/kernels/radix_pass.py:37). Launched on a materialised int32
// ids strip as its keys under the identity label (min(max(id, 0), m - 1)),
// it is also tile_histograms_pallas (src/repro/kernels/multisplit_tile.py:94).
//
// keys (L, T) 32-bit words -> hist (L, m) int32. One block per tile; each
// warp counts its run of the tile in warp-private shared-memory counters
// (match_any groups a round's lanes by bucket, the group's first lane adds
// the group size), and the block sums the warp rows.
//
// Bound: memory. It reads 4 bytes a key and writes 4·m bytes a tile, so the
// least time is (4·L·T + 4·L·m) bytes / 3.35 TB/s on an H100 SXM; the
// counting happens in registers and shared memory.
#include "multisplit_common.cuh"

namespace {

__global__ void __launch_bounds__(ms::kThreads)
    tile_histograms_kernel(const uint32_t* __restrict__ keys, int* __restrict__ hist, int T,
                           ms::Label L) {
  extern __shared__ int cnt[];                       // [kWarps][m]
  __shared__ uint32_t sp[ms::kMaxBuckets];
  ms::load_splitters(L, sp);
  ms::zero(cnt, ms::kWarps * L.m);
  __syncthreads();
  const size_t tile = blockIdx.x;
  ms::rank_tile<false, false>(keys + tile * T, nullptr, T, L, sp, cnt, nullptr, nullptr);
  __syncthreads();
  for (int b = threadIdx.x; b < L.m; b += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < ms::kWarps; ++w) s += cnt[w * L.m + b];
    hist[tile * L.m + b] = s;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_tile_histograms(const void* keys, void* hist, int n_tiles, int T,
                                  MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const size_t smem = sizeof(int) * ms::kWarps * m;
  cudaError_t err = ms::allow_smem(tile_histograms_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_histograms_kernel<<<n_tiles, ms::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int*>(hist), T, L);
  return static_cast<int>(cudaGetLastError());
}
