// K3: the DMS postscan with in-kernel labels: global destinations
// G[b] + rank in element order (paper eq. (2)), with no reorder.
//
// Replaces spec_tile_positions_pallas (src/repro/kernels/multisplit_tile.py:396)
// and its BitfieldSpec instance radix_tile_positions_pallas
// (src/repro/kernels/radix_pass.py:46). Launched on a materialised int32
// ids strip as its keys under the identity label (min(max(id, 0), m - 1)),
// it is also tile_positions_pallas (src/repro/kernels/multisplit_tile.py:123).
//
// keys (L, T) 32-bit words, G (L, m) int32 -> pos (L, T) int32. One block
// per tile: the warp-ballot stable rank of multisplit_common.cuh, then one
// int32 add per key. The Pallas kernel adds G and the rank in float32,
// which is wrong from 2^24 on; this one is exact for every n < 2^31.
//
// Bound: memory. It reads 4 bytes a key and 4·m bytes of G a tile and
// writes 4 bytes a key: (8·L·T + 4·L·m) bytes / 3.35 TB/s on an H100 SXM.
#include "multisplit_common.cuh"

namespace {

__global__ void __launch_bounds__(ms::kThreads)
    tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ g,
                          int* __restrict__ pos, int T, ms::Label L) {
  extern __shared__ int smem[];
  int* cnt = smem;                                   // [kWarps][m]
  int* sg = cnt + ms::kWarps * L.m;                  // [m]  this tile's row of G
  int* meta = sg + L.m;                              // [T]  rank << 9 | bucket
  __shared__ uint32_t sp[ms::kMaxBuckets];
  const size_t tile = blockIdx.x;
  ms::load_splitters(L, sp);
  ms::zero(cnt, ms::kWarps * L.m);
  for (int b = threadIdx.x; b < L.m; b += blockDim.x) sg[b] = g[tile * L.m + b];
  __syncthreads();
  ms::rank_tile<true, false>(keys + tile * T, nullptr, T, L, sp, cnt, meta, nullptr);
  __syncthreads();
  ms::warp_offsets(cnt, L.m);
  __syncthreads();
  const int R = ms::rounds_per_warp(T);
  const int mask = (1 << ms::kLabelBits) - 1;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int v = meta[i];
    const int b = v & mask, w = (i >> 5) / R;
    pos[tile * T + i] = sg[b] + cnt[w * L.m + b] + (v >> ms::kLabelBits);
  }
}

}  // namespace

extern "C" int ms_tile_positions(const void* keys, const void* g, void* pos, int n_tiles, int T,
                                 MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const size_t smem = sizeof(int) * (ms::kWarps * m + m + static_cast<size_t>(T));
  cudaError_t err = ms::allow_smem(tile_positions_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_positions_kernel<<<n_tiles, ms::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(g), static_cast<int*>(pos), T,
      L);
  return static_cast<int>(cudaGetLastError());
}
