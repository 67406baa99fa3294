// K2f: the fused two-digit WMS/BMS postscan: two radix digits a tile
// residency. The tile is sorted stably by its pair digit in shared memory
// (an LSD sweep of sub-digit stages, multisplit_fused2.cuh), each key's
// stable rank in its cell (seg, pair) is its position minus the head of the
// cell's run, its global destination is G[tile, seg·m² + pair] + rank, and
// keys, values and destinations go out (seg, pair)-major within the tile in
// coalesced writes; the caller's one scatter a pair replaces the two
// scatters of two chained single-digit passes, bit for bit.
//
// Replaces fused2_fused_postscan_reorder_pallas
// (src/repro/kernels/multisplit_tile.py:973), whose body is
// fused2_postscan_body (src/repro/kernels/common.py:521). One kernel body,
// four forms (template flags): flat or segmented (a segment strip that
// never decreases along a tile), and the onehot (warp-ballot) or packed
// (8-bit subword counters) rank in the sweep's stages. The result depends
// on neither the family nor the stage width `sub` (1 to 8 bits).
//
// keys (L, T) 32-bit integer words [, seg (L, T) int32], G (L, s·m²) int32,
// optional values (L, T) 32-bit words -> keys_r, vals_r, pos_r (L, T),
// (seg, pair)-major within each tile, pos_r the global destination of each
// reordered slot, and perm (L, T) int32, the element-order destination.
//
// Bound: memory. It reads 4 bytes a key (and a value) [, 4 of segment id]
// and one G base a key (4 bytes; the bases of distinct cells at most), and
// writes keys_r, pos_r, perm (and vals_r): (20·L·T) bytes key-only and
// (28·L·T) key-value [+ 4·L·T segmented] over 3.35 TB/s on an H100 SXM. The
// sweep, the heads and the reorder stay in shared memory; the perm and the
// values go through it too, so every device write is coalesced but the G
// reads.
#include "multisplit_fused2.cuh"

namespace {

template <bool kSeg, bool kPacked>
__global__ void __launch_bounds__(ms::kThreads)
    fused2_fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                         const int* __restrict__ segs, const int* __restrict__ g,
                                         const uint32_t* __restrict__ vals,
                                         uint32_t* __restrict__ keys_r,
                                         uint32_t* __restrict__ vals_r, int* __restrict__ pos_r,
                                         int* __restrict__ perm, int T, int s, int shift, int bits,
                                         int sub) {
  extern __shared__ int smem[];
  uint32_t* k0 = reinterpret_cast<uint32_t*>(smem);  // [T] keys, buffer 0
  uint32_t* k1 = k0 + T;                             // [T] keys, buffer 1
  int* meta = reinterpret_cast<int*>(k1 + T);        // [T] stage ranks, then perm staging
  int* seg_runs = meta + T;                          // [T + 1] run starts (segmented)
  uint16_t* i0 = reinterpret_cast<uint16_t*>(seg_runs + (kSeg ? T + 1 : 0));   // [T]
  uint16_t* i1 = i0 + T;                             // [T] source index, buffer 1
  __shared__ int cnt[ms::kWarps * ms::kMaxBuckets];
  __shared__ int start[ms::kMaxBuckets];
  __shared__ uint32_t words[kPacked ? ms::kWarps * ms::kMaxWords : 1];
  __shared__ int wsum[ms::kWarps];
  __shared__ int chunk[kSeg ? ms::kMaxChunks : 1];
  __shared__ int flat_runs[2];
  int* runs = kSeg ? seg_runs : flat_runs;
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const int* seg = kSeg ? segs + base : nullptr;
  const int* grow = g + tile * (static_cast<size_t>(s) << bits);
  uint32_t* kb[2] = {k0, k1};
  uint16_t* ib[2] = {i0, i1};
  const ms::StageSmem S{cnt, start, wsum, words, meta};

  const int nruns = ms::tile_runs<kSeg>(seg, T, runs, chunk);   // synchronises
  const int fin = ms::sort_tile_by_pair<kSeg, kPacked>(keys + base, T, runs, nruns, shift, bits,
                                                      sub, kb, ib, S);
  const uint32_t* fk = kb[fin];
  const uint16_t* fi = ib[fin];
  uint32_t* sv = kb[1 - fin];                        // the free key buffer: values, element order
  const bool has_vals = vals != nullptr;
  if (has_vals)
    for (int j = threadIdx.x; j < T; j += blockDim.x) sv[j] = vals[base + j];
  ms::walk_cells<kSeg>(fk, seg, T, s, shift, bits, wsum,
                       [&](int p, size_t cg, int rank) {
                         const int gpos = grow[cg] + rank;
                         const int src = fi[p];
                         keys_r[base + p] = fk[p];
                         pos_r[base + p] = gpos;
                         meta[src] = gpos;
                         if (has_vals) vals_r[base + p] = sv[src];
                       });                             // synchronises
  for (int j = threadIdx.x; j < T; j += blockDim.x) perm[base + j] = meta[j];
}

template <bool kSeg, bool kPacked>
int launch(const void* keys, const void* segs, const void* g, const void* vals, void* keys_r,
           void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s, int shift, int bits,
           int sub, void* stream) {
  const size_t smem = sizeof(int) * (3 * static_cast<size_t>(T) + (kSeg ? T + 1 : 0)) +
                      sizeof(uint16_t) * 2 * static_cast<size_t>(T);
  cudaError_t err = ms::allow_smem(fused2_fused_postscan_reorder_kernel<kSeg, kPacked>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused2_fused_postscan_reorder_kernel<kSeg, kPacked><<<n_tiles, ms::kThreads, smem,
                                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs),
      static_cast<const int*>(g), static_cast<const uint32_t*>(vals),
      static_cast<uint32_t*>(keys_r), static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r),
      static_cast<int*>(perm), T, s, shift, bits, sub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: the segment strip, or null for the flat layout (s = 1). vals and
// vals_r are null for a key-only reorder. The pair is `bits` wide at
// `shift` (1 <= bits <= 16, shift + bits <= 32), swept `sub` bits a stage
// (1 <= sub <= 8); packed selects the packed rank for the stages. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ms_fused2_fused_postscan_reorder(const void* keys, const void* segs, const void* g,
                                                const void* vals, void* keys_r, void* vals_r,
                                                void* pos_r, void* perm, int n_tiles, int T, int s,
                                                int shift, int bits, int sub, int packed,
                                                void* stream) {
  if (n_tiles == 0) return 0;
  if (segs) {
    return packed ? launch<true, true>(keys, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles,
                                       T, s, shift, bits, sub, stream)
                  : launch<true, false>(keys, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles,
                                        T, s, shift, bits, sub, stream);
  }
  return packed ? launch<false, true>(keys, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T,
                                      s, shift, bits, sub, stream)
                : launch<false, false>(keys, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles,
                                       T, s, shift, bits, sub, stream);
}
