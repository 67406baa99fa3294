// K2: the fused WMS/BMS postscan (paper §4.5 + §4.7): stable in-tile rank
// -> tile bucket starts -> within-tile destination and global destination
// G[b] + rank, then the bucket-major reorder of keys, values and
// destinations through shared memory and coalesced writes. Two entry
// points share one kernel body, which a template flag gives its label
// source:
//
// * ms_fused_postscan_reorder: labels in the kernel from a declarative
//   spec. Replaces spec_fused_postscan_reorder_pallas
//   (src/repro/kernels/multisplit_tile.py:460) and its BitfieldSpec
//   instance radix_fused_postscan_reorder_pallas
//   (src/repro/kernels/radix_pass.py:55).
// * ms_fused_postscan_reorder_ids: labels read from a materialised int32
//   ids plane (a programmer's bucket function), clamped into [0, m).
//   Replaces fused_postscan_reorder_pallas
//   (src/repro/kernels/multisplit_tile.py:168).
//
// keys (L, T) 32-bit words [, ids (L, T) int32], G (L, m) int32, optional
// values (L, T) 32-bit words -> keys_r, vals_r, pos_r (L, T), bucket-major
// within each tile, with pos_r the global destination of each reordered
// slot, and perm (L, T) int32, the element-order destination. The caller's
// scatter of keys_r/vals_r to pos_r then writes runs of consecutive
// addresses per bucket (paper §4.7).
//
// Bound: memory. It reads 4 bytes a key (and a value) and 4·m bytes of G a
// tile and writes keys_r, pos_r, perm (and vals_r): (16·L·T + 4·L·m) bytes
// key-only, (24·L·T + 4·L·m) key-value, and 4·L·T more for the ids plane,
// over 3.35 TB/s on an H100 SXM. The rank, the scans and the reorder stay
// in registers and shared memory; the Pallas kernel's T×T permutation
// matmuls have no counterpart here. The ids plane takes no shared memory:
// each label goes into the meta word as a computed one does.
#include "multisplit_common.cuh"

namespace {

template <bool kIds>
__global__ void __launch_bounds__(ms::kThreads)
    fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ ids, const int* __restrict__ g,
                                  const uint32_t* __restrict__ vals, uint32_t* __restrict__ keys_r,
                                  uint32_t* __restrict__ vals_r, int* __restrict__ pos_r,
                                  int* __restrict__ perm, int T, ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* sg = cnt + ms::kWarps * m;                    // [m]  this tile's row of G
  int* start = sg + m;                               // [m]  tile bucket starts
  int* meta = start + m;                             // [T]  rank << 9 | bucket
  uint32_t* ks = reinterpret_cast<uint32_t*>(meta + T);   // [T] keys, element order
  uint32_t* sk = ks + T;                             // [T]  keys, bucket-major
  int* spos = reinterpret_cast<int*>(sk + T);        // [T]  destinations, bucket-major
  uint32_t* sv = reinterpret_cast<uint32_t*>(spos + T);   // [T] values, bucket-major
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int wsum[ms::kWarps];
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const bool has_vals = vals != nullptr;

  ms::load_splitters(L, sp);
  ms::zero(cnt, ms::kWarps * m);
  for (int b = threadIdx.x; b < m; b += blockDim.x) sg[b] = g[tile * m + b];
  __syncthreads();
  ms::rank_tile<true, true, kIds>(keys + base, kIds ? ids + base : nullptr, T, L, sp, cnt, meta,
                                  ks);
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
    const int off = cnt[w * m + b] + (v >> ms::kLabelBits);   // stable rank in the tile
    const int dest = start[b] + off;
    const int gpos = sg[b] + off;
    perm[base + i] = gpos;
    sk[dest] = ks[i];
    spos[dest] = gpos;
    if (has_vals) sv[dest] = vals[base + i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    keys_r[base + j] = sk[j];
    pos_r[base + j] = spos[j];
    if (has_vals) vals_r[base + j] = sv[j];
  }
}

template <bool kIds>
int launch(const void* keys, const void* ids, const void* g, const void* vals, void* keys_r,
           void* vals_r, void* pos_r, void* perm, int n_tiles, int T, const ms::Label& L,
           void* stream) {
  if (n_tiles == 0) return 0;
  const size_t planes = vals ? 5 : 4;
  const size_t smem = sizeof(int) * (ms::kWarps * L.m + 2 * L.m + planes * static_cast<size_t>(T));
  cudaError_t err = ms::allow_smem(fused_postscan_reorder_kernel<kIds>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_postscan_reorder_kernel<kIds><<<n_tiles, ms::kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(g), static_cast<const uint32_t*>(vals),
      static_cast<uint32_t*>(keys_r), static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r),
      static_cast<int*>(perm), T, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Both entry points return
// cudaGetLastError() after the launch (0 on success).
extern "C" int ms_fused_postscan_reorder(const void* keys, const void* g, const void* vals,
                                         void* keys_r, void* vals_r, void* pos_r, void* perm,
                                         int n_tiles, int T, MS_LABEL_PARAMS, void* stream) {
  return launch<false>(keys, nullptr, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T,
                       ms::make_label(MS_LABEL_ARGS), stream);
}

extern "C" int ms_fused_postscan_reorder_ids(const void* ids, const void* g, const void* keys,
                                             const void* vals, void* keys_r, void* vals_r,
                                             void* pos_r, void* perm, int n_tiles, int T, int m,
                                             void* stream) {
  return launch<true>(keys, ids, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T,
                      ms::identity_label(m), stream);
}
