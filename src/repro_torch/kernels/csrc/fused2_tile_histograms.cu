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
// histograms. One block a tile: it zeroes its row in device memory (16-byte
// stores where the row width allows), synchronises, then each warp groups
// its 32 keys by cell with __match_any_sync and the group's leader adds the
// group's size with one global atomicAdd. The row is m² = 65536 words at r
// = 8 (256 KB), wider than shared memory, which is why the adds go to
// device memory; integer adds give the same counts in any order.
//
// Bound: memory. It reads 4 bytes a key [and 4 of segment id] and writes
// the whole (L, s·m²) row of H: (4·L·T [+ 4·L·T] + 4·L·s·m²) bytes over
// 3.35 TB/s on an H100 SXM. At r = 8 the row dominates: 1 GiB of H at n =
// 2^25 in tiles of 8192 keys against 128 MiB of keys.
#include "multisplit_fused2.cuh"

namespace {

template <bool kSeg>
__global__ void __launch_bounds__(ms::kThreads)
    fused2_tile_histograms_kernel(const uint32_t* __restrict__ keys,
                                  const int* __restrict__ segs, int* __restrict__ hist, int T,
                                  int s, int shift, int bits) {
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const uint32_t m2 = 1u << bits;
  const size_t width = static_cast<size_t>(s) * m2;
  int* row = hist + tile * width;
  if ((width & 3) == 0) {                            // rows of whole int4s, 16-byte aligned
    int4* row4 = reinterpret_cast<int4*>(row);
    const int4 z = make_int4(0, 0, 0, 0);
    for (size_t j = threadIdx.x; j < width / 4; j += blockDim.x) row4[j] = z;
  } else {
    for (size_t j = threadIdx.x; j < width; j += blockDim.x) row[j] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x - lane; r < T; r += blockDim.x) {   // rounds of 32 keys a warp
    const int i = r + lane;
    const bool valid = i < T;
    const size_t cg = valid ? (kSeg ? static_cast<size_t>(ms::seg_at(segs + base, i, s)) * m2 : 0) +
                                  ms::pair_of(keys[base + i], shift, bits)
                            : width;
    const unsigned peers = __match_any_sync(ms::kFull, cg);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&row[cg], __popc(peers));
  }
}

template <bool kSeg>
int launch(const void* keys, const void* segs, void* hist, int n_tiles, int T, int s, int shift,
           int bits, void* stream) {
  fused2_tile_histograms_kernel<kSeg><<<n_tiles, ms::kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(segs), static_cast<int*>(hist),
      T, s, shift, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// segs: the segment strip, or null for the flat layout (s = 1). The pair is
// `bits` wide at `shift` (1 <= bits <= 16, shift + bits <= 32). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ms_fused2_tile_histograms(const void* keys, const void* segs, void* hist,
                                         int n_tiles, int T, int s, int shift, int bits,
                                         void* stream) {
  if (n_tiles == 0) return 0;
  return segs ? launch<true>(keys, segs, hist, n_tiles, T, s, shift, bits, stream)
              : launch<false>(keys, segs, hist, n_tiles, T, s, shift, bits, stream);
}
