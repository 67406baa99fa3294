// B10: the standalone tile reorder of the unfused baseline (paper §4.7).
// Replaces tile_reorder_pallas (src/repro/kernels/multisplit_tile.py:1061),
// whose oracle is tile_reorder (src/repro/kernels/ref.py:37).
//
// ids (L, T) int32, keys (L, T) 32-bit words, optional values (L, T) 32-bit
// words -> keys_r, vals_r (L, T), stably bucket-major within each tile, and
// dest (L, T) int32, each element's destination inside its tile,
// starts[id] + rank. There is no G and no global destination: this is K2's
// ids body (fused_postscan_reorder.cu) without the G read and without
// pos_r / perm. Ids are clamped into [0, m), as every ids kernel clamps them.
//
// Design: one block of 8 warps a tile. The ids-strip rank (warp ballots and
// warp-private counters, ms::rank_tile), the warp offsets and one block
// scan give the tile's bucket starts; dest = start[b] + rank is written in
// element order, keys and values are staged bucket-major in shared memory
// and written out coalesced.
//
// Bound: memory. It reads ids, keys and values (12 bytes a key) and writes
// keys_r, vals_r and dest (12 bytes a key): 24·L·T bytes key-value, 16·L·T
// key-only, over 3.35 TB/s on an H100 SXM. The rank and the scans stay in
// registers and shared memory; the Pallas kernel's T×T permutation matmuls
// have no counterpart here.
#include "multisplit_common.cuh"

namespace {

__global__ void __launch_bounds__(ms::kThreads)
    tile_reorder_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ keys,
                        const uint32_t* __restrict__ vals, uint32_t* __restrict__ keys_r,
                        uint32_t* __restrict__ vals_r, int* __restrict__ dest, int T,
                        ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* start = cnt + ms::kWarps * m;                 // [m]  tile bucket starts
  int* meta = start + m;                             // [T]  rank << 9 | bucket
  uint32_t* sk = reinterpret_cast<uint32_t*>(meta + T);   // [T] keys, bucket-major
  uint32_t* sv = sk + T;                             // [T]  values, bucket-major
  __shared__ int wsum[ms::kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * T;
  const bool has_vals = vals != nullptr;

  ms::zero(cnt, ms::kWarps * m);
  __syncthreads();
  // the identity label reads no splitters and, with kIds, no keys
  ms::rank_tile<true, false, true>(nullptr, ids + base, T, L, nullptr, cnt, meta, nullptr);
  __syncthreads();
  const int count = ms::warp_offsets(cnt, m);        // thread b: tile count of bucket b
  const int first = ms::block_exclusive_scan(count, wsum);
  if (threadIdx.x < m) start[threadIdx.x] = first;
  __syncthreads();

  const int R = ms::rounds_per_warp(T);
  const int mask = (1 << ms::kLabelBits) - 1;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int v = meta[i];
    const int b = v & mask, w = (i >> 5) / R;
    const int d = start[b] + cnt[w * m + b] + (v >> ms::kLabelBits);
    dest[base + i] = d;
    sk[d] = keys[base + i];
    if (has_vals) sv[d] = vals[base + i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    keys_r[base + j] = sk[j];
    if (has_vals) vals_r[base + j] = sv[j];
  }
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int ms_tile_reorder(const void* ids, const void* keys, const void* vals, void* keys_r,
                               void* vals_r, void* dest, int n_tiles, int T, int m, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::identity_label(m);
  const size_t planes = vals ? 3 : 2;
  const size_t smem = sizeof(int) * (ms::kWarps * static_cast<size_t>(m) + m +
                                     planes * static_cast<size_t>(T));
  cudaError_t err = ms::allow_smem(tile_reorder_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_reorder_kernel<<<n_tiles, ms::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(keys_r),
      static_cast<uint32_t*>(vals_r), static_cast<int*>(dest), T, L);
  return static_cast<int>(cudaGetLastError());
}
