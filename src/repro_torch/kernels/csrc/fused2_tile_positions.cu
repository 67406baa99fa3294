// K3f: the fused two-digit DMS postscan: each key's global destination
// G[tile, seg·m² + pair] + its stable rank in its cell, in element order.
// The rank comes from the sort of K2f (multisplit_fused2.cuh): the tile is
// sorted by its pair in shared memory, a key's rank is its position minus
// the head of its cell's run, and the destination is written at the key's
// source index; no key moves in device memory.
//
// Replaces fused2_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:909), whose body is
// fused2_positions_body (src/repro/kernels/common.py:652). One kernel body,
// four forms (template flags): flat or segmented, onehot or packed stage
// rank; the result depends on neither the family nor the stage width.
//
// keys (L, T) 32-bit integer words [, seg (L, T) int32], G (L, s·m²) int32
// -> (L, T) int32 destinations.
//
// Bound: memory. It reads 4 bytes a key [, 4 of segment id] and one G base
// a key and writes 4 bytes a key: (12·L·T) bytes [+ 4·L·T segmented] over
// 3.35 TB/s on an H100 SXM. The destinations are staged in shared memory
// in element order and written coalesced.
#include "multisplit_fused2.cuh"

namespace {

template <bool kSeg, bool kPacked>
__global__ void __launch_bounds__(ms::kThreads)
    fused2_tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                                 const int* __restrict__ g, int* __restrict__ pos, int T, int s,
                                 int shift, int bits, int sub) {
  extern __shared__ int smem[];
  uint32_t* k0 = reinterpret_cast<uint32_t*>(smem);  // [T] keys, buffer 0
  uint32_t* k1 = k0 + T;                             // [T] keys, buffer 1
  int* meta = reinterpret_cast<int*>(k1 + T);        // [T] stage ranks, then destinations
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
  const uint16_t* fi = ib[fin];
  ms::walk_cells<kSeg>(kb[fin], seg, T, s, shift, bits, wsum,
                       [&](int p, size_t cg, int rank) { meta[fi[p]] = grow[cg] + rank; });
  for (int j = threadIdx.x; j < T; j += blockDim.x) pos[base + j] = meta[j];
}

template <bool kSeg, bool kPacked>
int launch(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
           int s, int shift, int bits, int sub, void* stream) {
  const size_t smem = sizeof(int) * (3 * static_cast<size_t>(T) + (kSeg ? T + 1 : 0)) +
                      sizeof(uint16_t) * 2 * static_cast<size_t>(T);
  cudaError_t err = ms::allow_smem(fused2_tile_positions_kernel<kSeg, kPacked>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused2_tile_positions_kernel<kSeg, kPacked><<<n_tiles, ms::kThreads, smem,
                                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs),
      static_cast<const int*>(g), static_cast<int*>(pos), T, s, shift, bits, sub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: the segment strip, or null for the flat layout (s = 1). The pair is
// `bits` wide at `shift` (1 <= bits <= 16, shift + bits <= 32), swept `sub`
// bits a stage (1 <= sub <= 8); packed selects the packed rank for the
// stages. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_fused2_tile_positions(const void* keys, const void* segs, const void* g,
                                        void* pos, int n_tiles, int T, int s, int shift, int bits,
                                        int sub, int packed, void* stream) {
  if (n_tiles == 0) return 0;
  if (segs) {
    return packed ? launch<true, true>(keys, segs, g, pos, n_tiles, T, s, shift, bits, sub, stream)
                  : launch<true, false>(keys, segs, g, pos, n_tiles, T, s, shift, bits, sub,
                                        stream);
  }
  return packed ? launch<false, true>(keys, segs, g, pos, n_tiles, T, s, shift, bits, sub, stream)
                : launch<false, false>(keys, segs, g, pos, n_tiles, T, s, shift, bits, sub, stream);
}
