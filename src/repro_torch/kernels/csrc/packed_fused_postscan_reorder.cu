// K2p: the fused WMS/BMS postscan on the two-level packed rank: stable
// in-tile rank -> tile (seg, b) starts -> within-tile destination and
// global destination G[cid] + rank, then the (seg, b)-major reorder of
// keys, values and destinations through shared memory and coalesced
// writes (paper §4.3 + §4.7).
//
// Replaces packed_fused_postscan_reorder_pallas
// (src/repro/kernels/multisplit_tile.py:772). One kernel body, four forms
// (template flags, as the JAX kernel's static flags): labels in the kernel
// from a declarative spec (keys are the labels' source and the words moved)
// or read from an int32 ids strip (clamped into [0, m); the keys plane only
// supplies the words to move); flat, or segmented over cid = seg·m + b with
// a segment strip that never decreases along a tile.
//
// keys (L, T) 32-bit words [, ids (L, T) int32] [, seg (L, T) int32], G
// (L, s·m) int32, optional values (L, T) 32-bit words -> keys_r, vals_r,
// pos_r (L, T), (seg, b)-major within each tile, with pos_r the global
// destination of each reordered slot, and perm (L, T) int32, the
// element-order destination. One block per tile, run by run (one run when
// flat): a short run is one warp's round, a longer one takes the packed
// two-level rank (multisplit_packed.cuh), its warp offsets and a block
// scan of its m counts for the run's bucket starts.
//
// Bound: memory. It reads 4 bytes a key (and a value) [, 4 of id] [, 4 of
// segment id] and the G bases its keys hit, and writes keys_r, pos_r, perm
// (and vals_r): (16·L·T + 4·L·m) bytes flat key-only, (24·L·T + 4·L·m)
// key-value, 4·L·T more for the ids strip, and segmented 4·L·T more with
// 4·nnz(H) of G, over 3.35 TB/s on an H100 SXM: the bytes of K2 and K2s at
// equal shapes. The rank, the scans and the reorder stay in shared memory.
#include "multisplit_packed.cuh"

namespace {

template <bool kIds, bool kSeg>
__global__ void __launch_bounds__(ms::kThreads)
    packed_fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                         const uint32_t* __restrict__ ids,
                                         const int* __restrict__ segs, const int* __restrict__ g,
                                         const uint32_t* __restrict__ vals,
                                         uint32_t* __restrict__ keys_r,
                                         uint32_t* __restrict__ vals_r, int* __restrict__ pos_r,
                                         int* __restrict__ perm, int T, int s, int sub,
                                         ms::Label L) {
  extern __shared__ int smem[];
  const int m = L.m;
  int* cnt = smem;                                   // [kWarps][m]
  int* sg = cnt + ms::kWarps * m;                    // [m]  this run's bases
  int* start = sg + m;                               // [m]  this run's (seg, b) tile starts
  int* meta = start + m;                             // [T]  rank << 9 | bucket
  uint32_t* ks = reinterpret_cast<uint32_t*>(meta + T);   // [T] keys, element order
  uint32_t* sk = ks + T;                             // [T]  keys, (seg, b)-major
  int* spos = reinterpret_cast<int*>(sk + T);        // [T]  destinations, (seg, b)-major
  uint32_t* sv = reinterpret_cast<uint32_t*>(spos + T);   // [T] values, (seg, b)-major
  int* seg_runs = reinterpret_cast<int*>(sv + (vals ? T : 0));   // [T + 1] (segmented)
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ uint32_t words[ms::kWarps * ms::kMaxWords];
  __shared__ int wsum[ms::kWarps];
  __shared__ int chunk[kSeg ? ms::kMaxChunks : 1];
  __shared__ int flat_runs[2];
  int* runs = kSeg ? seg_runs : flat_runs;
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const uint32_t* k = keys + base;
  const uint32_t* id = kIds ? ids + base : nullptr;
  const int* seg = kSeg ? segs + base : nullptr;
  const int* grow = g + tile * static_cast<size_t>(s) * m;
  const bool has_vals = vals != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  const int nruns = ms::tile_runs<kSeg>(seg, T, runs, chunk);   // synchronises

  if (kSeg) {                                        // short runs: one warp each
    for (int r = warp; r < nruns; r += ms::kWarps) {
      const int a = runs[r], len = runs[r + 1] - a;
      if (len > ms::kShortRun) continue;
      const ms::ShortRank x = ms::short_run_rank<kIds>(k, id, a, len, L, sp);
      if (lane < len) {
        const int i = a + lane;
        const int gpos = grow[static_cast<size_t>(ms::seg_at(seg, a, s)) * m + x.b] + x.rank;
        const int dest = a + x.before + x.rank;
        perm[base + i] = gpos;
        sk[dest] = x.w;
        spos[dest] = gpos;
        if (has_vals) sv[dest] = vals[base + i];
      }
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
    ms::packed_rank_range<true, true, kIds>(k + a, kIds ? id + a : nullptr, len, sub, L, sp,
                                            cnt, words, meta + a, ks + a);
    __syncthreads();
    const int count = ms::warp_offsets(cnt, m);      // thread b: the run's count of bucket b
    const int first = ms::block_exclusive_scan(count, wsum);
    if (threadIdx.x < m) start[threadIdx.x] = a + first;
    __syncthreads();
    const int spw = ms::subtiles_per_warp(len, sub);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int i = a + j;
      const int v = meta[i];
      const int b = v & mask, w = ms::packed_warp_of(j, sub, spw);
      const int off = cnt[w * m + b] + (v >> ms::kLabelBits);   // stable rank in the run
      const int dest = start[b] + off;
      const int gpos = sg[b] + off;
      perm[base + i] = gpos;
      sk[dest] = ks[i];
      spos[dest] = gpos;
      if (has_vals) sv[dest] = vals[base + i];
    }
    __syncthreads();                                 // the next run rewrites cnt, sg, start
  }
  __syncthreads();
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    keys_r[base + j] = sk[j];
    pos_r[base + j] = spos[j];
    if (has_vals) vals_r[base + j] = sv[j];
  }
}

template <bool kIds, bool kSeg>
int launch(const void* keys, const void* ids, const void* segs, const void* g, const void* vals,
           void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
           int sub, const ms::Label& L, void* stream) {
  const size_t planes = (vals ? 5 : 4) + (kSeg ? 1 : 0);
  const size_t smem = sizeof(int) * (ms::kWarps * L.m + 2 * L.m +
                                     planes * static_cast<size_t>(T) + (kSeg ? 1 : 0));
  cudaError_t err = ms::allow_smem(packed_fused_postscan_reorder_kernel<kIds, kSeg>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_fused_postscan_reorder_kernel<kIds, kSeg><<<n_tiles, ms::kThreads, smem,
                                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(segs), static_cast<const int*>(g),
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(keys_r),
      static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r), static_cast<int*>(perm), T, s,
      sub, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: the words to move, and the labels' source unless ids is given (then
// the label arguments are the identity's). segs: the segment strip, or null
// for the flat layout (s = 1). vals and vals_r are null for a key-only
// reorder. sub: the subtile, 1 to 255 keys. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int ms_packed_fused_postscan_reorder(const void* keys, const void* ids,
                                                const void* segs, const void* g,
                                                const void* vals, void* keys_r, void* vals_r,
                                                void* pos_r, void* perm, int n_tiles, int T,
                                                int s, int sub, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  if (ids) {
    return segs ? launch<true, true>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                     n_tiles, T, s, sub, L, stream)
                : launch<true, false>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                      n_tiles, T, s, sub, L, stream);
  }
  return segs ? launch<false, true>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                    n_tiles, T, s, sub, L, stream)
              : launch<false, false>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                     n_tiles, T, s, sub, L, stream);
}
