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
// matmuls have no counterpart here.
//
// Design for Hopper.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... and writes each tile's rows
//   where the contract puts them. A lane holds up to kR = 16 keys' state
//   (T <= 4096; 32 up to 8192) in 128 registers (up to 255), two blocks an
//   SM. Blocks of 16 warps (8 keys a lane, 64 registers for two blocks an
//   SM) spill a little and took 7.5 % longer at m = 256 on an H100, 1-3 %
//   less at m <= 32 (tools/k1k2_variants.py).
// * Staged tiles: a tile's keys, values, ids and its row of G are copied
//   into a stage in shared memory with cp.async, 16 bytes a copy where the
//   rows are 16-byte aligned (T % 4 == 0 and every plane 16-byte aligned),
//   else one word a copy. With two stages the next tile's copies are issued
//   as soon as the current tile's have landed, so they fly during the whole
//   rank, reorder and write-out of the current one (one stage took 15-19 %
//   longer on an H100). The launcher takes two
//   stages where they cost no block an SM (key-value at T = 4096, ids plane
//   too: 79 and 111 KiB a block, two blocks an SM), one where a second
//   stage would cut the blocks an SM. At T = 8192 key-value with the ids
//   plane, two stages take 211 KiB, one block an SM.
// * The stable rank, from shared memory: each warp owns a contiguous run of
//   the tile and walks it in rounds of 32 keys, in order; a round's lanes of
//   one bucket are found with ballots over the label's bits (the warp's
//   peer mask) and ranked by popc(peers & lanemask_lt); warp-private
//   counters in shared memory carry the rank from round to round. Each lane
//   keeps (rank, bucket) of its keys in registers. On an H100, computing
//   every round's labels and peer masks ahead of the carry took 2-5 %
//   longer, and __match_any_sync peer masks took 3-15 % less at m <= 32 or
//   one bucket but 7 % more at m = 256, the main shape, so the ballots
//   stay. The rank (sm90::warp_rank), the cp.async staging and the choice
//   of stages are shared with K3 and K2s in multisplit_sm90.cuh.
// * Cross-warp offsets and eq. (2): one thread a bucket turns the warp
//   counters into exclusive offsets over the warps, a block scan gives the
//   tile's bucket starts, and the counters become start[b] + warp offset;
//   destination = that + rank, global destination G[b] + the bucket-local
//   rank, written to perm in element order (a coalesced 128-byte store a
//   round).
// * In-place reorder: each lane reads its keys from the stage into
//   registers, the block synchronises, and each lane writes them back into
//   the same stage at their bucket-major slots with their bucket in a byte
//   plane; then the values the same way, so a lane holds one word a key.
//   No separate output planes: a stage is keys, values [and ids] and G,
//   plus T bytes of buckets and 9·m words (the warps' counters and G[b] -
//   start[b]) for the block.
// * Write-out: keys_r and vals_r rows from the stage, pos_r[j] = j + G[b] -
//   start[b] from the bucket byte of slot j, as 16-byte stores where the
//   rows are aligned; the stage is free for the copies of the tile after
//   next as soon as every thread has read it.
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
static_assert(kWarps == ms::kWarps, "the block scan of multisplit_common.cuh");

struct Layout {
  int pitch;          // words a plane of one stage: T rounded up to 16 bytes
  int planes;         // keys [+ values] [+ ids]
  int stage_words;    // planes·pitch + m rounded up to 16 bytes (G's row)
  int stages;         // 1 or 2
};

template <bool kIds, int kR>
__global__ void __launch_bounds__(kThreads, kR <= 16 ? 2 : 1)
    fused_postscan_reorder_kernel(const uint32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ ids, const int* __restrict__ g,
                                  const uint32_t* __restrict__ vals, uint32_t* __restrict__ keys_r,
                                  uint32_t* __restrict__ vals_r, int* __restrict__ pos_r,
                                  int* __restrict__ perm, int n_tiles, int T, sm90::Label F,
                                  Layout Y, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ int wsum[kWarps];
  const int m = F.L.m;
  const bool has_vals = vals != nullptr;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]
  int* const delta = cnt + kWarps * m;               // [m]  G[b] - start[b]
  uint8_t* const sb = reinterpret_cast<uint8_t*>(delta + m);   // [T] bucket of each slot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nr = (T + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
  const int r0 = warp * R, r1 = min(r0 + R, nr);
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;

  // the stage's planes: keys, values (if any), ids (if kIds), G's row
  auto plane = [&](int s, int p) { return smem + s * Y.stage_words + p * Y.pitch; };
  auto stage = [&](int tile, int s) {
    const size_t off = static_cast<size_t>(tile) * T;
    sm90::stage_row<kThreads>(plane(s, 0), keys + off, T, vec);
    if (has_vals) sm90::stage_row<kThreads>(plane(s, 1), vals + off, T, vec);
    if (kIds) sm90::stage_row<kThreads>(plane(s, Y.planes - 1), ids + off, T, vec);
    uint32_t* gs = plane(s, Y.planes);
    const uint32_t* grow = reinterpret_cast<const uint32_t*>(g) + static_cast<size_t>(tile) * m;
    for (int b = tid; b < m; b += kThreads) sm90::copy4(gs + b, grow + b);
  };

  ms::load_splitters(F.L, sp);
  for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
  if (Y.stages == 2 && static_cast<int>(blockIdx.x) < n_tiles) stage(blockIdx.x, 0);

  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int s = Y.stages == 2 ? (k & 1) : 0;
    if (Y.stages == 1) {
      __syncthreads();                               // the previous tile's write-out is done
      stage(tile, 0);
    }
    sm90::copy_wait_all();
    __syncthreads();                                 // stage s has landed; stage s ^ 1 is free
    const int next = tile + static_cast<int>(gridDim.x);
    if (Y.stages == 2 && next < n_tiles) stage(next, s ^ 1);

    uint32_t* const ks = plane(s, 0);
    uint32_t* const vs = plane(s, 1);
    const uint32_t* const src = kIds ? plane(s, Y.planes - 1) : ks;   // the label words
    const int* const gs = reinterpret_cast<const int*>(plane(s, Y.planes));
    const size_t base = static_cast<size_t>(tile) * T;

    // 1. the warp's rounds in order: a round's peer mask from ballots over
    // the label's bits, the carry through the warp's counters
    int meta[kR];
    sm90::warp_rank<kR, sm90::kAnySpec>(src, T, F, sp, mine, r0, r1, nbits, meta);
    __syncthreads();

    // 2. warp offsets, the tile's bucket starts, start + warp offset in cnt
    int total = 0;
    if (tid < m) {
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w * m + tid];
        cnt[w * m + tid] = total;
        total += c;
      }
    }
    const int first = ms::block_exclusive_scan(total, wsum);
    if (tid < m) {
      for (int w = 0; w < kWarps; ++w) cnt[w * m + tid] += first;
      delta[tid] = gs[tid] - first;
    }
    __syncthreads();

    // 3. destinations: perm in element order, the keys into registers
    uint32_t word[kR];
    const int label_mask = (1 << ms::kLabelBits) - 1;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T) {
        const int b = meta[r] & label_mask;
        const int dest = mine[b] + (meta[r] >> ms::kLabelBits);
        perm[base + i] = dest + delta[b];
        word[r] = ks[i];
        meta[r] = dest | (b << 16);
      }
    }
    __syncthreads();                                 // every key of the stage is read

    // 4. the reorder in place, one plane at a time (the keys with their
    // buckets, then the values), so a lane holds one word a key
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T) {
        const int dest = meta[r] & 0xffff;
        ks[dest] = word[r];
        sb[dest] = static_cast<uint8_t>(meta[r] >> 16);
        if (has_vals) word[r] = vs[i];
      }
    }
    for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
    if (has_vals) {
      __syncthreads();                               // every value of the stage is read
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < T) vs[meta[r] & 0xffff] = word[r];
      }
    }
    __syncthreads();

    // 5. write-out of keys_r, vals_r and pos_r rows
    if (vec) {
      const int nv = T >> 2;
      uint4* const ko = reinterpret_cast<uint4*>(keys_r + base);
      uint4* const vo = reinterpret_cast<uint4*>(vals_r + base);
      int4* const po = reinterpret_cast<int4*>(pos_r + base);
      for (int v = tid; v < nv; v += kThreads) {
        ko[v] = reinterpret_cast<const uint4*>(ks)[v];
        if (has_vals) vo[v] = reinterpret_cast<const uint4*>(vs)[v];
        const uchar4 q = reinterpret_cast<const uchar4*>(sb)[v];
        const int j = 4 * v;
        po[v] = make_int4(j + delta[q.x], j + 1 + delta[q.y], j + 2 + delta[q.z],
                          j + 3 + delta[q.w]);
      }
    } else {
      for (int j = tid; j < T; j += kThreads) {
        keys_r[base + j] = ks[j];
        if (has_vals) vals_r[base + j] = vs[j];
        pos_r[base + j] = j + delta[sb[j]];
      }
    }
  }
}

inline size_t smem_bytes(const Layout& Y, int m) {
  const size_t fixed = sizeof(int) * static_cast<size_t>(kWarps * m + m) + Y.pitch;
  return sizeof(uint32_t) * static_cast<size_t>(Y.stages) * Y.stage_words + fixed;
}

template <bool kIds, int kR>
int launch_kernel(const void* keys, const void* ids, const void* g, const void* vals, void* keys_r,
                  void* vals_r, void* pos_r, void* perm, int n_tiles, int T, const ms::Label& L,
                  void* stream) {
  auto kernel = fused_postscan_reorder_kernel<kIds, kR>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.planes = 1 + (vals != nullptr) + kIds;
  Y.stage_words = Y.planes * Y.pitch + ((L.m + 3) & ~3);
  Y.stages = 2;
  const size_t two = smem_bytes(Y, L.m);
  Y.stages = 1;
  const size_t one = smem_bytes(Y, L.m);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  if (sm90::report(kernel, kThreads, Y.stages, smem, &err)) return static_cast<int>(err);
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, keys) && sm90::rows_aligned(T, ids) &&
                   sm90::rows_aligned(T, vals) && sm90::rows_aligned(T, keys_r) &&
                   sm90::rows_aligned(T, vals_r) && sm90::rows_aligned(T, pos_r);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(ids),
      static_cast<const int*>(g), static_cast<const uint32_t*>(vals),
      static_cast<uint32_t*>(keys_r), static_cast<uint32_t*>(vals_r), static_cast<int*>(pos_r),
      static_cast<int*>(perm), n_tiles, T, sm90::make_label(L), Y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kIds>
int launch(const void* keys, const void* ids, const void* g, const void* vals, void* keys_r,
           void* vals_r, void* pos_r, void* perm, int n_tiles, int T, const ms::Label& L,
           void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || L.m < 1 || L.m > ms::kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps)
    return launch_kernel<kIds, 16>(keys, ids, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T, L,
                                   stream);
  return launch_kernel<kIds, 32>(keys, ids, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T, L,
                                 stream);
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Both entry points return
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a tile the kernel does not take (T above 8192) or m outside [1, 256].
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
