// K2s: the segmented fused WMS/BMS postscan: stable rank of the combined
// id cid = seg·m + b, the tile's (seg, b) starts, the global destination
// G[cid] + rank, then the (seg, b)-major reorder of keys, values and
// destinations through shared memory and coalesced writes. Two entry
// points share one kernel body, which a template flag gives its label
// source:
//
// * ms_seg_fused_postscan_reorder: labels in the kernel from a declarative
//   spec. Replaces seg_spec_fused_postscan_reorder_pallas
//   (src/repro/kernels/multisplit_tile.py:587) and its BitfieldSpec
//   instance seg_radix_fused_postscan_reorder_pallas
//   (src/repro/kernels/radix_pass.py:95).
// * ms_seg_fused_postscan_reorder_ids: labels read from a materialised
//   int32 ids plane, clamped into [0, m). Replaces
//   seg_fused_postscan_reorder_pallas
//   (src/repro/kernels/multisplit_tile.py:303).
//
// keys (L, T) 32-bit words [, ids (L, T) int32], seg (L, T) int32
// non-decreasing along each tile, G (L, s·m) int32, optional values (L, T)
// 32-bit words -> keys_r, vals_r, pos_r (L, T), (seg, b)-major within each
// tile, with pos_r the global destination of each reordered slot, and perm
// (L, T) int32, the element-order destination. One block per tile, run by
// run (multisplit_segmented.cuh). The tile start of (seg, b) is the first
// index of seg's run plus the exclusive scan of the run's m bucket counts:
// a short run counts its smaller buckets with shuffles, a long run takes
// the flat K2 machinery over the run. Shared memory is m-wide and T-long,
// never s·m; the ids plane takes none.
//
// Bound: memory. It reads 4 bytes a key, 4 of segment id (and 4 of value)
// and the G bases its keys hit (4 bytes for each distinct cid of a tile,
// the nonzeros of the tile's histogram row, at most m a run), and writes
// keys_r, pos_r, perm (and vals_r): (20·L·T + 4·nnz(H)) bytes key-only,
// (28·L·T + 4·nnz(H)) key-value, and 4·L·T more for the ids plane, over
// 3.35 TB/s on an H100 SXM.
#include "multisplit_segmented.cuh"

namespace {

template <bool kIds>
__global__ void __launch_bounds__(ms::kThreads)
    seg_fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                      const uint32_t* __restrict__ ids,
                                      const int* __restrict__ segs, const int* __restrict__ g,
                                      const uint32_t* __restrict__ vals,
                                      uint32_t* __restrict__ keys_r, uint32_t* __restrict__ vals_r,
                                      int* __restrict__ pos_r, int* __restrict__ perm, int T, int s,
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
  int* runs = spos + T;                              // [T + 1] run starts
  uint32_t* sv = reinterpret_cast<uint32_t*>(runs + T + 1);   // [T] values, (seg, b)-major
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int wsum[ms::kWarps];
  __shared__ int chunk[ms::kMaxChunks];
  const size_t tile = blockIdx.x;
  const size_t base = tile * T;
  const uint32_t* k = keys + base;
  const uint32_t* id = kIds ? ids + base : nullptr;
  const int* seg = segs + base;
  const int* grow = g + tile * static_cast<size_t>(s) * m;
  const bool has_vals = vals != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  ms::load_splitters(L, sp);
  const int nruns = ms::find_runs(seg, T, runs, chunk);

  // short runs: one warp each, no block barrier
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
  // long runs: the flat K2 body over [a, a + len), one run after another
  const int mask = (1 << ms::kLabelBits) - 1;
  for (int r = 0; r < nruns; ++r) {
    const int a = runs[r], len = runs[r + 1] - a;
    if (len <= ms::kShortRun) continue;
    const int* gseg = grow + static_cast<size_t>(ms::seg_at(seg, a, s)) * m;
    ms::zero(cnt, ms::kWarps * m);
    for (int b = threadIdx.x; b < m; b += blockDim.x) sg[b] = gseg[b];
    __syncthreads();
    ms::rank_tile<true, true, kIds>(k + a, kIds ? id + a : nullptr, len, L, sp, cnt, meta + a,
                                    ks + a);
    __syncthreads();
    const int count = ms::warp_offsets(cnt, m);      // thread b: the run's count of bucket b
    const int first = ms::block_exclusive_scan(count, wsum);
    if (threadIdx.x < m) start[threadIdx.x] = a + first;
    __syncthreads();
    const int R = ms::rounds_per_warp(len);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int i = a + j;
      const int v = meta[i];
      const int b = v & mask, w = (j >> 5) / R;
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

template <bool kIds>
int launch(const void* keys, const void* ids, const void* segs, const void* g, const void* vals,
           void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
           const ms::Label& L, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t planes = vals ? 6 : 5;
  const size_t smem =
      sizeof(int) * (ms::kWarps * L.m + 2 * L.m + planes * static_cast<size_t>(T) + 1);
  cudaError_t err = ms::allow_smem(seg_fused_postscan_reorder_kernel<kIds>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_fused_postscan_reorder_kernel<kIds><<<n_tiles, ms::kThreads, smem,
                                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(segs), static_cast<const int*>(g),
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(keys_r),
      static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r), static_cast<int*>(perm), T, s, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Both entry points return
// cudaGetLastError() after the launch (0 on success).
extern "C" int ms_seg_fused_postscan_reorder(const void* keys, const void* segs, const void* g,
                                             const void* vals, void* keys_r, void* vals_r,
                                             void* pos_r, void* perm, int n_tiles, int T, int s,
                                             MS_LABEL_PARAMS, void* stream) {
  return launch<false>(keys, nullptr, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T, s,
                       ms::make_label(MS_LABEL_ARGS), stream);
}

extern "C" int ms_seg_fused_postscan_reorder_ids(const void* ids, const void* segs, const void* g,
                                                 const void* keys, const void* vals, void* keys_r,
                                                 void* vals_r, void* pos_r, void* perm,
                                                 int n_tiles, int T, int s, int m, void* stream) {
  return launch<true>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T, s,
                      ms::identity_label(m), stream);
}
