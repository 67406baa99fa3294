// K2p: the fused WMS/BMS postscan on the two-level packed rank: stable
// in-tile rank -> tile (seg, b) starts -> within-tile destination and
// global destination G[cid] + rank, then the (seg, b)-major reorder of
// keys, values and destinations through shared memory and coalesced
// writes (paper §4.3 + §4.7).
//
// Replaces packed_fused_postscan_reorder_pallas
// (src/repro/kernels/multisplit_tile.py:772), whose body is
// packed_postscan_body (src/repro/kernels/common.py:383). One kernel body,
// four forms (template flags, as the JAX kernel's static flags): labels in
// the kernel from a declarative spec (keys are the labels' source and the
// words moved) or read from an int32 ids strip (clamped into [0, m); the
// keys plane only supplies the words to move); flat, or segmented over cid
// = seg·m + b with a segment strip that never decreases along a tile.
//
// keys (L, T) 32-bit words [, ids (L, T) int32] [, seg (L, T) int32], G
// (L, s·m) int32, optional values (L, T) 32-bit words -> keys_r, vals_r,
// pos_r (L, T), (seg, b)-major within each tile, with pos_r the global
// destination of each reordered slot, and perm (L, T) int32, the
// element-order destination.
//
// Bound: memory. It reads 4 bytes a key (and a value) [, 4 of id] [, 4 of
// segment id] and the G bases its keys hit, and writes keys_r, pos_r, perm
// (and vals_r): (16·L·T + 4·L·m) bytes flat key-only, (24·L·T + 4·L·m)
// key-value, 4·L·T more for the ids strip, and segmented 4·L·T more with
// 4·nnz(H) of G, over 3.35 TB/s on an H100 SXM: the bytes of K2 and K2s at
// equal shapes. The rank, the scans and the reorder stay in shared memory
// and registers.
//
// Design for Hopper: the skeleton of K2 and K2s (fused_postscan_reorder.cu,
// seg_fused_postscan_reorder.cu) with the packed family's own rank.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR = 16
//   keys' state (T <= 4096; 32 up to 8192), two blocks an SM.
// * Staged tiles: keys, values, [ids] and [segment ids] are copied into a
//   stage in shared memory with cp.async, 16 bytes a copy where every row
//   is 16-byte aligned, else one word a copy; two stages, the next tile's
//   copies in flight during the current one, where they cost no block an
//   SM (sm90::pick_stages).
// * The rank is the packed family's (sm90::packed_warp_rank): each warp
//   walks its contiguous rounds of 32 keys in order, a round's peers from
//   __match_any_sync (ballots over the label's bits took longer on an H100,
//   tools/k2fk2p_variants.py), its counters 8-bit lanes four to a word
//   (⌈m/4⌉ words a warp), unpacked into the warp's int32 carry at the end
//   of every subtile and after the warp's last round; a subtile is
//   max(1, ⌊sub/32⌋) whole rounds counted from the run's start (at most
//   sub keys for sub >= 32, one round below; sub is 1 to 255), so a lane
//   never passes 255; (rank, bucket) stays in registers. The warp offsets
//   across the warps and one block scan give the run's bucket starts. The
//   subtile changes no output.
// * Labels in the cheapest form the spec allows (multisplit_sm90.cuh): a
//   shift for BitfieldSpec and DeltaSpec over 2^k, the clamp for ids and
//   IdentitySpec, ms::bucket_of otherwise.
// * Runs (segmented): a tile whose first and last segment ids agree is one
//   run and takes the flat path whole; else chunk flags split it
//   (ms::split_runs): a run of at most 32 keys is solved by one warp
//   (ms::short_run_rank), a longer one is listed and takes the flat path
//   over its range, one after another. A flat tile's G row is read into
//   registers before its rank, so its latency hides behind it; a run's
//   entries are read after it (a register the fewer through the rank).
// * The reorder without a second key plane: each key goes straight to its
//   slot in a dead plane (the segment ids, the ids of a flat tile once
//   ranked, or a plane of its own for flat labels in the kernel). Flat, its
//   bucket goes into a byte plane, and once every key is out the values go
//   to their slots in the key plane: no word is held in registers, which
//   keeps the flat instances at two blocks an SM without a spill; pos_r[j]
//   = j + G[b] - start[b] comes from the byte of slot j at the write-out,
//   as in K2. Segmented, as in K2s: the values go to the ids plane (ids)
//   or are reordered in place, a lane holding one word a value, and each
//   lane writes its keys' pos_r[j] into the key plane at slot j.
// * Write-out: keys_r, vals_r and pos_r rows from the stage, a plane at a
//   time, 16 bytes a store where the rows are aligned.
#include "multisplit_segmented.cuh"
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
constexpr int kMaxWords = ms::kMaxBuckets / 4;       // packed words a warp
static_assert(kWarps == ms::kWarps, "the block scan of multisplit_common.cuh");

struct Layout {
  int pitch;          // words a plane of one stage: T rounded up to 16 bytes
  int planes;         // keys [+ values] [+ ids] [+ segment ids | + keys_r]
  int stage_words;    // planes·pitch
  int stages;         // 1 or 2
};

template <bool kIds, bool kSeg, int kR, int kForm>
__global__ void __launch_bounds__(kThreads, kR <= 16 ? 2 : 1)
    packed_fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                         const uint32_t* __restrict__ ids,
                                         const int* __restrict__ segs, const int* __restrict__ g,
                                         const uint32_t* __restrict__ vals,
                                         uint32_t* __restrict__ keys_r,
                                         uint32_t* __restrict__ vals_r, int* __restrict__ pos_r,
                                         int* __restrict__ perm, int n_tiles, int T, int s,
                                         int sub, sm90::Label F, Layout Y, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int wsum[kWarps];
  __shared__ uint32_t words[kWarps * kMaxWords];     // the 8-bit lanes, zero between runs
  __shared__ unsigned flags[kSeg ? ms::kMaxChunks : 1];   // run starts, one ballot a chunk
  __shared__ int2 longs[kSeg ? ms::kMaxLong : 1];    // the tile's long runs [a, e)
  __shared__ int n_long;
  const int m = F.L.m;
  const bool has_vals = vals != nullptr;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]
  int* const delta = cnt + kWarps * m;               // [m]  G[seg·m + b] - start[b], one run
  uint8_t* const sb = reinterpret_cast<uint8_t*>(delta + m);   // [T] flat: the bucket of each slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;
  uint32_t* const pw = words + warp * kMaxWords;
  const int p_ids = 1 + has_vals, p_last = Y.planes - 1;

  // the stage's planes: keys, values (if any), ids (if kIds), then the
  // segment ids (kSeg) or, flat with labels in the kernel, keys_r's plane
  auto plane = [&](int st, int p) { return smem + st * Y.stage_words + p * Y.pitch; };
  auto stage = [&](int tile, int st) {
    const size_t off = static_cast<size_t>(tile) * T;
    sm90::stage_row<kThreads>(plane(st, 0), keys + off, T, vec);
    if (has_vals) sm90::stage_row<kThreads>(plane(st, 1), vals + off, T, vec);
    if (kIds) sm90::stage_row<kThreads>(plane(st, p_ids), ids + off, T, vec);
    if (kSeg)
      sm90::stage_row<kThreads>(plane(st, p_last), reinterpret_cast<const uint32_t*>(segs) + off,
                                T, vec);
  };

  ms::load_splitters(F.L, sp);
  for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
  for (int j = tid; j < kWarps * kMaxWords; j += kThreads) words[j] = 0u;
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
    // keys_r: into the segment ids, the ranked ids of a flat tile, or a
    // plane of its own; vals_r: flat, into the key plane once the keys are
    // out; segmented, into the ids plane (the segment plane takes the keys)
    // or in place
    uint32_t* const kr = kSeg || !kIds ? plane(st, p_last) : plane(st, p_ids);
    uint32_t* const vr = kSeg ? (kIds ? plane(st, p_ids) : vs) : ks;
    constexpr bool kValsInPlace = !kIds;             // segmented: the values reordered in place
    const int* const sg = reinterpret_cast<const int*>(plane(st, p_last));
    const size_t base = static_cast<size_t>(tile) * T;
    const int* const grow = g + static_cast<size_t>(tile) * s * m;

    const bool one_run = !kSeg || sg[0] == sg[T - 1];
    int nl = 1;
    if (kSeg && !one_run) {
      // the run starts of each 32-key chunk; short runs solved by the warp
      // that meets them, long ones listed for the block
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

    // the flat path over a run [a, e): the tile when it is one run, else
    // each long run, one after another
    for (int q = 0; q < nl; ++q) {
      const int a = one_run ? 0 : longs[q].x, e = one_run ? T : longs[q].y;
      // the run's length, opaque to the compiler: else, flat, it hoists
      // every round's offset out of the tile loop and holds it in a
      // register for the whole kernel
      int len = e - a;
      asm volatile("" : "+r"(len));
      const int nr = (len + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
      const int r0 = warp * R, r1 = min(r0 + R, nr);
      // flat, the tile's G row is read before the rank, its latency hidden
      // behind it; segmented, after it (a register less through the rank)
      int gb = !kSeg && tid < m ? __ldg(grow + tid) : 0;

      // 1. the warp's rounds of the run in order, on the packed counters
      int meta[kR];
      sm90::packed_warp_rank<kR, kForm, !kSeg>(src + a, len, F, sp, mine, pw, r0, r1, nbits, sub,
                                               meta);
      __syncthreads();
      if (kSeg && tid < m) gb = __ldg(grow + static_cast<size_t>(ms::seg_at(sg, a, s)) * m + tid);

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
        delta[tid] = gb - first;
      }
      __syncthreads();

      // 3. destinations: perm in element order, each key to its slot in
      // keys_r's plane; flat, its bucket into the byte plane; segmented,
      // each value to its slot in the ids plane or into registers
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
          if (!kSeg) {
            sb[dest] = static_cast<uint8_t>(b);
          } else if (has_vals) {
            if (kValsInPlace) word[r] = vs[a + i];
            else vr[dest] = vs[a + i];
          }
          meta[r] = dest | (b << 16);
        }
      }
      __syncthreads();                               // every key and value of the run is read

      // 4. flat: the values into the key plane; segmented: pos_r into the
      // key plane, the values in place
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < len) {
          const int dest = meta[r] & 0xffff;
          if (!kSeg) {
            if (has_vals) ks[dest] = vs[a + i];
          } else {
            ks[dest] = static_cast<uint32_t>(dest + delta[meta[r] >> 16]);
            if (has_vals && kValsInPlace) vs[dest] = word[r];
          }
        }
      }
      for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
      __syncthreads();
    }

    // 5. write-out of keys_r, vals_r and pos_r rows, a plane at a time;
    // flat, pos_r[j] = j + G[b] - start[b] from the bucket byte of slot j
    if (vec) {
      const int nv = T >> 2;
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(kr)[v];
      if (has_vals)
        for (int v = tid; v < nv; v += kThreads)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(vr)[v];
      for (int v = tid; v < nv; v += kThreads) {
        if (kSeg) {
          reinterpret_cast<uint4*>(pos_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];
        } else {
          const uchar4 q = reinterpret_cast<const uchar4*>(sb)[v];
          const int j = 4 * v;
          reinterpret_cast<int4*>(pos_r + base)[v] =
              make_int4(j + delta[q.x], j + 1 + delta[q.y], j + 2 + delta[q.z], j + 3 + delta[q.w]);
        }
      }
    } else {
      for (int j = tid; j < T; j += kThreads) {
        keys_r[base + j] = kr[j];
        if (has_vals) vals_r[base + j] = vr[j];
        pos_r[base + j] = kSeg ? static_cast<int>(ks[j]) : j + delta[sb[j]];
      }
    }
  }
}

template <bool kIds, bool kSeg, int kR, int kForm>
int launch_kernel(const void* keys, const void* ids, const void* segs, const void* g,
                  const void* vals, void* keys_r, void* vals_r, void* pos_r, void* perm,
                  int n_tiles, int T, int s, int sub, const sm90::Label& F, cudaStream_t stream) {
  auto kernel = packed_fused_postscan_reorder_kernel<kIds, kSeg, kR, kForm>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.planes = 1 + (vals != nullptr) + kIds + (kSeg || !kIds);
  Y.stage_words = Y.planes * Y.pitch;
  const size_t stage_bytes = sizeof(uint32_t) * static_cast<size_t>(Y.stage_words);
  const size_t one = stage_bytes + sizeof(int) * static_cast<size_t>(kWarps * F.L.m + F.L.m) +
                     (kSeg ? 0 : static_cast<size_t>(Y.pitch));
  const size_t two = one + stage_bytes;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
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
      T, s, sub, F, Y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kIds, bool kSeg, int kR>
int launch_form(const void* keys, const void* ids, const void* segs, const void* g,
                const void* vals, void* keys_r, void* vals_r, void* pos_r, void* perm,
                int n_tiles, int T, int s, int sub, const sm90::Label& F, cudaStream_t stream) {
  // an ids strip is read under the identity label: always the clamp form
  if (kIds || F.form == sm90::kClampedId)
    return launch_kernel<kIds, kSeg, kR, sm90::kClampedId>(keys, ids, segs, g, vals, keys_r,
                                                           vals_r, pos_r, perm, n_tiles, T, s,
                                                           sub, F, stream);
  if (F.form == sm90::kShiftMask)
    return launch_kernel<false, kSeg, kR, sm90::kShiftMask>(keys, ids, segs, g, vals, keys_r,
                                                            vals_r, pos_r, perm, n_tiles, T, s,
                                                            sub, F, stream);
  return launch_kernel<false, kSeg, kR, sm90::kAnySpec>(keys, ids, segs, g, vals, keys_r, vals_r,
                                                        pos_r, perm, n_tiles, T, s, sub, F,
                                                        stream);
}

template <bool kIds, bool kSeg>
int launch(const void* keys, const void* ids, const void* segs, const void* g, const void* vals,
           void* keys_r, void* vals_r, void* pos_r, void* perm, int n_tiles, int T, int s,
           int sub, const ms::Label& L, void* stream) {
  const sm90::Label F = sm90::make_label(L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps)
    return launch_form<kIds, kSeg, 16>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                       n_tiles, T, s, sub, F, st);
  return launch_form<kIds, kSeg, 32>(keys, ids, segs, g, vals, keys_r, vals_r, pos_r, perm,
                                     n_tiles, T, s, sub, F, st);
}

}  // namespace

// keys: the words to move, and the labels' source unless ids is given (then
// the label arguments are the identity's). segs: the segment strip, or null
// for the flat layout (s = 1). vals and vals_r are null for a key-only
// reorder. sub: the subtile, 1 to 255 keys. Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a tile the
// kernel does not take (T above 8192), m outside [1, 256], a subtile outside
// [1, 255] or no segment.
extern "C" int ms_packed_fused_postscan_reorder(const void* keys, const void* ids,
                                                const void* segs, const void* g,
                                                const void* vals, void* keys_r, void* vals_r,
                                                void* pos_r, void* perm, int n_tiles, int T,
                                                int s, int sub, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  if (T < 1 || T > kMaxTile || L.m < 1 || L.m > ms::kMaxBuckets || sub < 1 || sub > 255 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
