// K3p: the DMS postscan on the two-level packed rank: global destinations
// G[cid] + rank in element order (paper eq. (2)), with no reorder.
//
// Replaces packed_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:706). One kernel body, four forms
// (template flags, as the JAX kernel's static flags): labels in the kernel
// from a declarative spec or read from an int32 ids strip (clamped into
// [0, m)); flat, or segmented over cid = seg·m + b with a segment strip that
// never decreases along a tile.
//
// keys or ids (L, T) [+ seg (L, T)], G (L, s·m) int32 -> pos (L, T) int32.
// One block per tile, run by run (one run when flat): a short run's keys
// read their base from G directly; a longer run stages its m bases in
// shared memory and takes the packed two-level rank over the run
// (multisplit_packed.cuh). The rank of a cid counts earlier keys of the
// same cid in the tile, which all lie in its run, so the state stays m-wide.
// int32 throughout: exact for every n < 2^31, as the JAX packed kernel is
// (its pick_row_32 picks G in 16-bit halves).
//
// Bound: memory. It reads 4 bytes a key (or id) [and 4 of segment id] and
// the G bases its keys hit, and writes 4 bytes a key: (8·L·T + 4·L·m)
// bytes flat and (12·L·T + 4·nnz(H)) segmented, over 3.35 TB/s on an H100
// SXM: the bytes of K3 and K3s at equal shapes. The rank stays in shared
// memory: 4 bytes a key of meta and the kWarps·m carry.
#include "multisplit_packed.cuh"

namespace {

template <bool kIds, bool kSeg>
__global__ void __launch_bounds__(ms::kThreads)
    packed_tile_positions_kernel(const uint32_t* __restrict__ keys,
                                 const uint32_t* __restrict__ ids, const int* __restrict__ segs,
                                 const int* __restrict__ g, int* __restrict__ pos, int T, int s,
                                 int sub, ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* sg = cnt + ms::kWarps * m;                    // [m]  this run's bases
  int* meta = sg + m;                                // [T]  rank << 9 | bucket
  int* seg_runs = meta + T;                          // [T + 1] run starts (segmented)
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ uint32_t words[ms::kWarps * ms::kMaxWords];
  __shared__ int chunk[kSeg ? ms::kMaxChunks : 1];
  __shared__ int flat_runs[2];
  int* runs = kSeg ? seg_runs : flat_runs;
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const uint32_t* k = keys + base;
  const uint32_t* id = kIds ? ids + base : nullptr;
  const int* seg = kSeg ? segs + base : nullptr;
  const int* grow = g + tile * static_cast<size_t>(s) * m;
  int* out = pos + base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  const int nruns = ms::tile_runs<kSeg>(seg, T, runs, chunk);   // synchronises

  if (kSeg) {                                        // short runs: one warp each
    for (int r = warp; r < nruns; r += ms::kWarps) {
      const int a = runs[r], len = runs[r + 1] - a;
      if (len > ms::kShortRun) continue;
      const ms::ShortRank x = ms::short_run_rank<kIds>(k, id, a, len, L, sp);
      if (lane < len)
        out[a + lane] = grow[static_cast<size_t>(ms::seg_at(seg, a, s)) * m + x.b] + x.rank;
    }
  }
  const int mask = (1 << ms::kLabelBits) - 1;
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (kSeg && len <= ms::kShortRun) continue;
    const int* gseg = grow + (kSeg ? static_cast<size_t>(ms::seg_at(seg, a, s)) * m : 0);
    ms::zero(cnt, ms::kWarps * m);
    for (int b = threadIdx.x; b < m; b += blockDim.x) sg[b] = gseg[b];
    __syncthreads();
    ms::packed_rank_range<true, false, kIds>(k + a, kIds ? id + a : nullptr, len, sub, L, sp,
                                             cnt, words, meta + a, nullptr);
    __syncthreads();
    ms::warp_offsets(cnt, m);
    __syncthreads();
    const int spw = ms::subtiles_per_warp(len, sub);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int v = meta[a + j];
      const int b = v & mask, w = ms::packed_warp_of(j, sub, spw);
      out[a + j] = sg[b] + cnt[w * m + b] + (v >> ms::kLabelBits);
    }
    __syncthreads();                                 // the next run rewrites cnt and sg
  }
}

template <bool kIds, bool kSeg>
int launch(const void* keys, const void* ids, const void* segs, const void* g, void* pos,
           int n_tiles, int T, int s, int sub, const ms::Label& L, void* stream) {
  const size_t smem = sizeof(int) * (ms::kWarps * L.m + L.m + static_cast<size_t>(T) +
                                     (kSeg ? static_cast<size_t>(T) + 1 : 0));
  cudaError_t err = ms::allow_smem(packed_tile_positions_kernel<kIds, kSeg>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_tile_positions_kernel<kIds, kSeg><<<n_tiles, ms::kThreads, smem,
                                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(segs), static_cast<const int*>(g), static_cast<int*>(pos), T, s,
      sub, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: the key words (labels in the kernel, ids null) or null (labels from
// ids, under the identity label arguments). segs: the segment strip, or
// null for the flat layout (s = 1). sub: the subtile, 1 to 255 keys.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_packed_tile_positions(const void* keys, const void* ids, const void* segs,
                                        const void* g, void* pos, int n_tiles, int T, int s,
                                        int sub, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const void* x = keys ? keys : ids;                 // short runs read a word a key
  if (ids) {
    return segs ? launch<true, true>(x, ids, segs, g, pos, n_tiles, T, s, sub, L, stream)
                : launch<true, false>(x, ids, segs, g, pos, n_tiles, T, s, sub, L, stream);
  }
  return segs ? launch<false, true>(x, ids, segs, g, pos, n_tiles, T, s, sub, L, stream)
              : launch<false, false>(x, ids, segs, g, pos, n_tiles, T, s, sub, L, stream);
}
