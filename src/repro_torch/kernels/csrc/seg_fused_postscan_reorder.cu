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
// (L, T) int32, the element-order destination.
//
// Bound: memory. It reads 4 bytes a key, 4 of segment id (and 4 of value)
// and the G bases its keys hit (4 bytes for each distinct cid of a tile,
// the nonzeros of the tile's histogram row, at most m a run), and writes
// keys_r, pos_r, perm (and vals_r): (20·L·T + 4·nnz(H)) bytes key-only,
// (28·L·T + 4·nnz(H)) key-value, and 4·L·T more for the ids plane, over
// 3.35 TB/s on an H100 SXM.
//
// Design for Hopper: K2's (fused_postscan_reorder.cu) carried over to the
// segment runs of a tile. Segment ids never decrease along a tile, so a
// tile is a sequence of runs of one segment each, and run [a, e) owns the
// slots [a, e) of the (seg, b)-major order: each run is K2's problem over
// its own range of the tile, and the runs' reorders never meet.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR = 16
//   keys' state (T <= 4096; 32 up to 8192), two blocks an SM.
// * Staged tiles: keys, values, [ids] and segment ids are copied into a
//   stage in shared memory with cp.async, 16 bytes a copy where every row
//   is 16-byte aligned, else one word a copy. Two stages, the next tile's
//   copies in flight during the current one, where they cost no block an
//   SM: key-only with or without the ids plane and key-value at T = 4096
//   (96 KiB of stage and 9·m words of counters, two blocks an SM); one
//   stage for key-value with the ids plane (four planes: two stages would
//   take 128 KiB and leave one block an SM).
// * Runs: a tile whose first and last segment ids agree is one run (nearly
//   every tile of S1 and S2) and takes K2's path whole. Else one ballot a
//   32-key chunk flags the run starts (chunk flags, 1 KiB: a list of T + 1
//   run starts would take the 16 KiB that the second stage needs), and each warp walks the starts of its chunks in order, a run's
//   end the next flag (ms::split_runs, shared with K3s). A short run (<=
//   ms::kShortRun keys) is solved there by that warp alone
//   (ms::short_run_rank: __match_any_sync peers and a shuffle count of the
//   smaller buckets, G read directly); a long one is listed and then taken
//   by the whole block, one after another.
// * K2's path over a run [a, e): the warps' contiguous rounds of the run,
//   peers from ballots over the label's bits, warp counters in shared
//   memory, (rank, bucket) in registers (sm90::warp_rank, labels in the
//   cheapest form the spec allows); one thread a bucket turns the counters
//   into a + the bucket's start in the run + the warp's offset, with
//   G[seg·m + b] - start beside them (the run's m-wide row of G, read
//   directly); perm in element order.
// * The reorder without a second key plane: the segment id plane of the
//   stage is dead once the tile's runs are known and a run has read its
//   first id, so each key goes straight to its slot there (keys_r); the
//   values go straight to their slots in the ids plane, dead once the run
//   is ranked, or else are reordered in place, a lane holding one word a
//   value; and once every key of the run is read, each lane writes its
//   keys' pos_r[j] itself into the key plane at slot j. So the slot data of
//   pos_r is pos_r: no bucket byte and no per-run base outlives the run,
//   and only a key-value lane without the ids plane holds words (kR of
//   them beside its kR ranks, as in K2).
// * Registers: every instance fits 128 (two blocks an SM) up to T = 4096
//   with no spill. That took the write-out a plane at a time (with the
//   three 16-byte copies in one loop the instances spill,
//   tools/k3k2s_variants.py) and one call site of the long-run path (the
//   one-run tile and the listed runs through one loop).
// * Write-out: keys_r, vals_r and pos_r rows from the stage, 16 bytes a
//   store where the rows are aligned.
#include "multisplit_segmented.cuh"
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
static_assert(kWarps == ms::kWarps, "the block scan of multisplit_common.cuh");

struct Layout {
  int pitch;          // words a plane of one stage: T rounded up to 16 bytes
  int planes;         // keys [+ values] [+ ids] + segment ids
  int stage_words;    // planes·pitch
  int stages;         // 1 or 2
};

template <bool kIds, int kR, int kForm>
__global__ void __launch_bounds__(kThreads, kR <= 16 ? 2 : 1)
    seg_fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                      const uint32_t* __restrict__ ids,
                                      const int* __restrict__ segs, const int* __restrict__ g,
                                      const uint32_t* __restrict__ vals,
                                      uint32_t* __restrict__ keys_r, uint32_t* __restrict__ vals_r,
                                      int* __restrict__ pos_r, int* __restrict__ perm, int n_tiles,
                                      int T, int s, sm90::Label F, Layout Y, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int wsum[kWarps];
  __shared__ unsigned flags[ms::kMaxChunks];         // run starts, one ballot a chunk
  __shared__ int2 longs[ms::kMaxLong];               // the tile's long runs [a, e)
  __shared__ int n_long;
  const int m = F.L.m;
  const bool has_vals = vals != nullptr;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]
  int* const delta = cnt + kWarps * m;               // [m]  G[seg·m + b] - start[b], one run

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;
  const int p_ids = 1 + has_vals, p_seg = Y.planes - 1;

  // the stage's planes: keys, values (if any), ids (if kIds), segment ids
  auto plane = [&](int st, int p) { return smem + st * Y.stage_words + p * Y.pitch; };
  auto stage = [&](int tile, int st) {
    const size_t off = static_cast<size_t>(tile) * T;
    sm90::stage_row<kThreads>(plane(st, 0), keys + off, T, vec);
    if (has_vals) sm90::stage_row<kThreads>(plane(st, 1), vals + off, T, vec);
    if (kIds) sm90::stage_row<kThreads>(plane(st, p_ids), ids + off, T, vec);
    sm90::stage_row<kThreads>(plane(st, p_seg), reinterpret_cast<const uint32_t*>(segs) + off, T,
                              vec);
  };

  ms::load_splitters(F.L, sp);
  for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
  if (Y.stages == 2 && static_cast<int>(blockIdx.x) < n_tiles) stage(blockIdx.x, 0);

  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int st = Y.stages == 2 ? (k & 1) : 0;
    if (Y.stages == 1) {
      __syncthreads();                               // the previous tile's write-out is done
      stage(tile, 0);
    }
    sm90::copy_wait_all();
    __syncthreads();                                 // stage st has landed; st ^ 1 is free
    const int next = tile + static_cast<int>(gridDim.x);
    if (Y.stages == 2 && next < n_tiles) stage(next, st ^ 1);

    uint32_t* const ks = plane(st, 0);                // keys, then pos_r
    uint32_t* const vs = plane(st, 1);                // values
    const uint32_t* const src = kIds ? plane(st, p_ids) : ks;   // the label words
    // vals_r: in place, or in the ids plane, dead once the run is ranked
    uint32_t* const vr = kIds ? plane(st, p_ids) : vs;
    uint32_t* const kr = plane(st, p_seg);            // segment ids, then keys_r
    const int* const sg = reinterpret_cast<const int*>(kr);
    const size_t base = static_cast<size_t>(tile) * T;
    const int* const grow = g + static_cast<size_t>(tile) * s * m;

    const bool one_run = sg[0] == sg[T - 1];
    int nl = 1;
    if (!one_run) {
      // A, B. the run starts of each 32-key chunk; short runs solved by the
      // warp that meets them, long ones listed for the block
      nl = ms::split_runs(sg, T, flags, longs, &n_long, [&](int a, int len) {
        const ms::ShortRank x = ms::short_run_rank<kIds>(
            ks, kIds ? plane(st, p_ids) : nullptr, a, len, F.L, sp);
        const int seg = ms::seg_at(sg, a, s);
        const uint32_t v = has_vals && lane < len ? vs[a + lane] : 0u;
        const int gpos = lane < len ? grow[static_cast<size_t>(seg) * m + x.b] + x.rank : 0;
        __syncwarp();                                // the run's words are read
        if (lane < len) {
          const int dest = a + x.before + x.rank;
          perm[base + a + lane] = gpos;
          kr[dest] = x.w;
          ks[dest] = static_cast<uint32_t>(gpos);
          if (has_vals) vr[dest] = v;
        }
        __syncwarp();
      });
    }

    // C. K2's path over a run [a, e): the tile when it is one run, else each
    // long run, one after another
    for (int q = 0; q < nl; ++q) {
      const int a = one_run ? 0 : longs[q].x, e = one_run ? T : longs[q].y;
      const int len = e - a;
      const int nr = (len + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
      const int r0 = warp * R, r1 = min(r0 + R, nr);

      // 1. the warp's rounds of the run in order
      int meta[kR];
      sm90::warp_rank<kR, kForm>(src + a, len, F, sp, mine, r0, r1, nbits, meta);
      __syncthreads();

      // 2. warp offsets, the run's bucket starts, a + start + warp offset in
      // cnt and G[seg·m + b] - (a + start) in delta
      int total = 0;
      if (tid < m) {
        for (int w = 0; w < kWarps; ++w) {
          const int c = cnt[w * m + tid];
          cnt[w * m + tid] = total;
          total += c;
        }
      }
      const int first = a + ms::block_exclusive_scan(total, wsum);
      if (tid < m) {
        for (int w = 0; w < kWarps; ++w) cnt[w * m + tid] += first;
        delta[tid] = grow[static_cast<size_t>(ms::seg_at(sg, a, s)) * m + tid] - first;
      }
      __syncthreads();

      // 3. destinations: perm in element order, each key to its slot in the
      // segment id plane, each value to its slot in the ids plane (kIds) or
      // into registers
      uint32_t word[kR];
      const int label_mask = (1 << ms::kLabelBits) - 1;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < len) {
          const int b = meta[r] & label_mask;
          const int dest = mine[b] + (meta[r] >> ms::kLabelBits);
          perm[base + a + i] = dest + delta[b];
          kr[dest] = ks[a + i];
          if (has_vals) {
            if (kIds) vr[dest] = vs[a + i];
            else word[r] = vs[a + i];
          }
          meta[r] = dest | (b << 16);
        }
      }
      __syncthreads();                               // every key and value of the run is read

      // 4. pos_r into the key plane, the values in place
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < len) {
          const int dest = meta[r] & 0xffff;
          ks[dest] = static_cast<uint32_t>(dest + delta[meta[r] >> 16]);
          if (has_vals && !kIds) vs[dest] = word[r];
        }
      }
      for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
      __syncthreads();
    }

    // 5. write-out of keys_r, vals_r and pos_r rows
    if (vec) {                                       // a plane at a time: fewer registers
      const int nv = T >> 2;
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(kr)[v];
      if (has_vals)
        for (int v = tid; v < nv; v += kThreads)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(vr)[v];
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(pos_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];
    } else {
      for (int j = tid; j < T; j += kThreads) {
        keys_r[base + j] = kr[j];
        if (has_vals) vals_r[base + j] = vr[j];
        pos_r[base + j] = static_cast<int>(ks[j]);
      }
    }
  }
}

template <bool kIds, int kR, int kForm>
int launch_kernel(const void* keys, const void* ids, const void* segs, const void* g,
                  const void* vals, void* keys_r, void* vals_r, void* pos_r, void* perm,
                  int n_tiles, int T, int s, const sm90::Label& F, cudaStream_t stream) {
  auto kernel = seg_fused_postscan_reorder_kernel<kIds, kR, kForm>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.planes = 2 + (vals != nullptr) + kIds;
  Y.stage_words = Y.planes * Y.pitch;
  const size_t stage_bytes = sizeof(uint32_t) * static_cast<size_t>(Y.stage_words);
  const size_t one = stage_bytes + sizeof(int) * static_cast<size_t>(kWarps * F.L.m + F.L.m);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, one + stage_bytes, &Y.stages, &smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  if (sm90::report(kernel, kThreads, Y.stages, smem, &err)) return static_cast<int>(err);
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, keys) && sm90::rows_aligned(T, ids) &&
                   sm90::rows_aligned(T, segs) && sm90::rows_aligned(T, vals) &&
                   sm90::rows_aligned(T, keys_r) && sm90::rows_aligned(T, vals_r) &&
                   sm90::rows_aligned(T, pos_r);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(segs), static_cast<const int*>(g),
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(keys_r),
      static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r), static_cast<int*>(perm), n_tiles,
      T, s, F, Y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kIds, int kR>
int launch_form(const void* keys, const void* ids, const void* segs, const void* g,
                const void* vals, void* keys_r, void* vals_r, void* pos_r, void* perm,
                int n_tiles, int T, int s, const sm90::Label& F, cudaStream_t stream) {
  // an ids plane is read under the identity label: always the clamp form
  if (kIds || F.form == sm90::kClampedId)
    return launch_kernel<kIds, kR, sm90::kClampedId>(keys, ids, segs, g, vals, keys_r, vals_r,
                                                     pos_r, perm, n_tiles, T, s, F, stream);
  if (F.form == sm90::kShiftMask)
    return launch_kernel<false, kR, sm90::kShiftMask>(keys, ids, segs, g, vals, keys_r, vals_r,
                                                      pos_r, perm, n_tiles, T, s, F, stream);
  return launch_kernel<false, kR, sm90::kAnySpec>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r,
                                                  perm, n_tiles, T, s, F, stream);
}

template <bool kIds>
int launch(const void* keys, const void* ids, const void* segs, const void* g, const void* vals,
           void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
           const ms::Label& L, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || L.m < 1 || L.m > ms::kMaxBuckets || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps)
    return launch_form<kIds, 16>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles,
                                 T, s, F, st);
  return launch_form<kIds, 32>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T,
                               s, F, st);
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Both entry points return
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a tile the kernel does not take (T above 8192), m outside [1, 256] or
// no segment.
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
