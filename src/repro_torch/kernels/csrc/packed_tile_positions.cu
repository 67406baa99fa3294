// K3p: the DMS postscan on the two-level packed rank: global destinations
// G[cid] + rank in element order (paper eq. (2)), with no reorder.
//
// Replaces packed_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:706). One kernel body, four forms
// (as the JAX kernel's static flags): labels in the kernel from a
// declarative spec or read from an int32 ids strip (clamped into [0, m)),
// flat or segmented over cid = seg·m + b with a segment strip that never
// decreases along a tile. An ids strip is read as the keys under the clamp
// label form (sm90::kClampedId), so two template flags make the four
// forms: kSeg and the label form.
//
// keys or ids (L, T) [+ seg (L, T)], G (L, s·m) int32 -> pos (L, T) int32.
// The rank of a cid counts the earlier keys of the same cid in the tile,
// which all lie in its segment run. int32 throughout: exact for every n <
// 2^31, as the JAX packed kernel is (its pick_row_32 picks G in 16-bit
// halves).
//
// Bound: memory. It reads 4 bytes a key (or id) and the G bases its keys
// hit and writes 4 bytes a key: (8·L·T + 4·L·m) bytes flat, the bytes of
// K3. Segmented it reads of the strip the two end ids of a tile of one run
// and all T ids of any other, and of G the nonzeros of the tile's histogram
// row: (8·L·T + 4·nnz(H) + 8·L1 + 4·T·L2) bytes, L1 the tiles of one run,
// L2 the others, the bytes of K3s; all over 3.35 TB/s on an H100 SXM.
//
// Design for Hopper: K3's (tile_positions.cu) flat and K3s's
// (seg_tile_positions.cu) segmented, on the packed family's rank.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR = 16
//   keys' (rank, bucket) (T <= 4096; 32 up to 8192) in registers.
// * Staged tiles: a tile's keys are copied into a stage in shared memory
//   with cp.async (16 bytes a copy where the keys' and pos's rows are
//   16-byte aligned, else one word a copy), and beside them its m-wide row
//   of G at tile·s·m + seg·m (flat, or segmented when its end ids agree:
//   one run), else its strip of segment ids. Segmented, the next tile's two
//   end ids are copied with the stage before it, so the choice is made from
//   shared memory. Two stages (the next tile's copies in flight during the
//   current one) where they cost no block an SM (sm90::pick_stages).
// * A tile of one run takes the flat path whole. Any other is split as K2s
//   splits it (ms::split_runs): a run of at most ms::kShortRun keys is
//   solved by the warp that meets it (__match_any_sync peers, G read
//   directly; the rank does not depend on the family); the long runs are
//   listed and take the flat path over [a, e) one after another.
// * The flat path: the warp's contiguous rounds of 32 keys go through
//   sm90::packed_warp_rank (8-bit lanes four to a word, ⌈m/4⌉ words a
//   warp, unpacked into the warp's int32 carry after every subtile of
//   max(1, ⌊sub/32⌋) rounds counted from the run's start and after the
//   warp's last round; (rank, bucket) in registers); one thread a bucket
//   turns the carries into G[cid] + the warps' exclusive offsets; each
//   lane writes pos = counter + rank into the stage's key slot it read.
// * The row of pos is written from the stage, 16 bytes a store where
//   aligned.
// * A strip outside the contract reads and writes nothing out of bounds:
//   each segment id is clamped into [0, s).
#include "multisplit_segmented.cuh"
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
constexpr int kMaxWords = ms::kMaxBuckets / 4;       // packed words a warp
constexpr int kMaxSub = 255;                         // the largest subtile: an 8-bit lane
static_assert(kWarps == ms::kWarps, "ms::split_runs walks the chunks with ms::kWarps warps");
// Between two unpacks a lane counts at most a subtile's max(1, sub / 32)
// rounds of 32 keys: a one-bucket tile puts all of them into one lane, 224
// at sub = 255, so no lane passes 255 at any tile width (kR = 32 too)
static_assert(32 * (kMaxSub >> 5) <= kMaxSub && 32 <= kMaxSub, "a lane may carry");

struct Layout {
  int pitch;          // words of the key plane: T rounded up to 16 bytes
  int g_off;          // G's row in a stage: at pitch, in the strip's slot when segmented
  int stage_words;    // pitch + G's row (m), or segmented the larger of it and the strip
  int stages;         // 1 or 2
};

// blocks an SM the registers must allow: four up to T = 4096 (64
// registers: the shift and clamp forms spill 24-40 bytes there, and still
// ran 4 % faster than at three blocks without a spill, the general form 4 %
// faster than at three, tools/k3pb10_variants.py), two above (one block an
// SM took 1.7 times as long); the general form one above
template <int kR, int kForm>
constexpr int min_blocks() {
  return kR <= 16 ? 4 : (kForm == sm90::kAnySpec ? 1 : 2);
}

template <bool kSeg, int kR, int kForm>
__global__ void __launch_bounds__(kThreads, min_blocks<kR, kForm>())
    packed_tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                                 const int* __restrict__ g, int* __restrict__ pos, int n_tiles,
                                 int T, int s, int sub, sm90::Label F, Layout Y, bool vec,
                                 bool vec_seg) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ uint32_t words[kWarps * kMaxWords];     // the 8-bit lanes, zero between runs
  __shared__ unsigned flags[kSeg ? ms::kMaxChunks : 1];   // run starts, one ballot a chunk
  __shared__ int2 longs[kSeg ? ms::kMaxLong : 1];    // the tile's long runs [a, e)
  __shared__ int n_long;
  __shared__ int2 ends[3];                           // end ids of a block's tiles k mod 3
  const int m = F.L.m;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;
  uint32_t* const pw = words + warp * kMaxWords;

  // the block's k-th tile into stage st: its keys, and its row of G (flat,
  // or one run) or its strip; segmented, the end ids of its k + 1-th tile
  // beside them
  auto stage = [&](int tile, int st, int k) {
    const int2 e = kSeg ? ends[k % 3] : make_int2(0, 0);
    uint32_t* const ks = smem + st * Y.stage_words;
    sm90::stage_row<kThreads>(ks, keys + static_cast<size_t>(tile) * T, T, vec);
    if (e.x == e.y) {
      const int* grow = g + (static_cast<size_t>(tile) * s + min(max(e.x, 0), s - 1)) * m;
      for (int b = tid; b < m; b += kThreads) sm90::copy4(ks + Y.g_off + b, grow + b);
    } else {
      sm90::stage_row<kThreads>(ks + Y.pitch,
                                reinterpret_cast<const uint32_t*>(segs) +
                                    static_cast<size_t>(tile) * T,
                                T, vec_seg);
    }
    const int after = tile + static_cast<int>(gridDim.x);
    if (kSeg && tid == 0 && after < n_tiles) {
      const int* sa = segs + static_cast<size_t>(after) * T;
      sm90::copy4(&ends[(k + 1) % 3].x, sa);
      sm90::copy4(&ends[(k + 1) % 3].y, sa + T - 1);
    }
  };

  ms::load_splitters(F.L, sp);
  for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
  for (int j = tid; j < kWarps * kMaxWords; j += kThreads) words[j] = 0u;
  if (kSeg && tid == 0 && static_cast<int>(blockIdx.x) < n_tiles) {
    const int* s0 = segs + static_cast<size_t>(blockIdx.x) * T;
    ends[0] = make_int2(s0[0], s0[T - 1]);
  }
  __syncthreads();                                   // the first tile's end ids
  if (Y.stages == 2 && static_cast<int>(blockIdx.x) < n_tiles) stage(blockIdx.x, 0, 0);

  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int st = Y.stages == 2 ? (k & 1) : 0;
    if (Y.stages == 1) {
      __syncthreads();                               // the previous tile's write-out is done
      stage(tile, 0, k);
    }
    sm90::copy_wait_all();
    __syncthreads();                                 // stage st has landed; st ^ 1 is free
    const int next = tile + static_cast<int>(gridDim.x);
    if (Y.stages == 2 && next < n_tiles) stage(next, st ^ 1, k + 1);

    uint32_t* const ks = smem + st * Y.stage_words;  // keys, then pos
    const int* const gs = reinterpret_cast<const int*>(ks + Y.g_off);   // G's row: one run
    const int* const sg = reinterpret_cast<const int*>(ks + Y.pitch);   // the strip: several
    const int* const grow = g + static_cast<size_t>(tile) * s * m;
    const int2 e = kSeg ? ends[k % 3] : make_int2(0, 0);
    const bool one_run = e.x == e.y;

    // A, B. several runs: short ones solved by the warp that meets them,
    // long ones listed
    int nl = 1;
    if (kSeg && !one_run) {
      nl = ms::split_runs(sg, T, flags, longs, &n_long, [&](int a, int len) {
        const bool valid = lane < len;
        const int b = valid ? sm90::label_of<kForm>(ks[a + lane], F, sp) : -1;
        const unsigned peers = __match_any_sync(ms::kFull, b);
        if (valid)
          ks[a + lane] = static_cast<uint32_t>(
              grow[static_cast<size_t>(ms::seg_at(sg, a, s)) * m + b] +
              __popc(peers & ((1u << lane) - 1u)));
      });
    }

    // C. the flat path over a run [a, e): the tile when it is one run, else
    // each long run, one after another
    for (int q = 0; q < nl; ++q) {
      const int a = one_run ? 0 : longs[q].x, len = (one_run ? T : longs[q].y) - a;
      const int nr = (len + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
      const int r0 = warp * R, r1 = min(r0 + R, nr);

      // 1. the warp's rounds of the run in order, on the packed counters,
      // (rank, bucket) in registers
      int rb[kR];
      sm90::packed_warp_rank<kR, kForm>(ks + a, len, F, sp, mine, pw, r0, r1, nbits, sub, rb);
      __syncthreads();

      // 2. the warp carries become G[seg·m + b] + the warps' exclusive offsets
      if (tid < m) {
        int run = one_run ? gs[tid]
                          : grow[static_cast<size_t>(ms::seg_at(sg, a, s)) * m + tid];
        for (int w = 0; w < kWarps; ++w) {
          const int c = cnt[w * m + tid];
          cnt[w * m + tid] = run;
          run += c;
        }
      }
      __syncthreads();

      // 3. pos = G + offset + rank, into the key slot each lane read
      const int label_mask = (1 << ms::kLabelBits) - 1;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < len)
          ks[a + i] =
              static_cast<uint32_t>(mine[rb[r] & label_mask] + (rb[r] >> ms::kLabelBits));
      }
      __syncthreads();                               // every counter is read
      for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
      if (q + 1 < nl) __syncthreads();               // zeroed before the next run counts
    }

    // 4. the row of pos from the stage
    const size_t base = static_cast<size_t>(tile) * T;
    if (vec) {
      int4* const po = reinterpret_cast<int4*>(pos + base);
      for (int v = tid; v < (T >> 2); v += kThreads) po[v] = reinterpret_cast<const int4*>(ks)[v];
    } else {
      for (int j = tid; j < T; j += kThreads) pos[base + j] = static_cast<int>(ks[j]);
    }
  }
}

template <bool kSeg, int kR, int kForm>
int launch(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
           int s, int sub, const sm90::Label& F, cudaStream_t stream) {
  auto kernel = packed_tile_positions_kernel<kSeg, kR, kForm>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.g_off = Y.pitch;
  const int g_words = (F.L.m + 3) & ~3;
  Y.stage_words = Y.pitch + (kSeg && Y.pitch > g_words ? Y.pitch : g_words);
  const size_t counters = sizeof(int) * static_cast<size_t>(kWarps) * F.L.m;
  const size_t one = sizeof(uint32_t) * static_cast<size_t>(Y.stage_words) + counters;
  const size_t two = one + sizeof(uint32_t) * static_cast<size_t>(Y.stage_words);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
  if (err == cudaSuccess && sm90::report(kernel, kThreads, Y.stages, smem, &err))
    return static_cast<int>(err);
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, keys) && sm90::rows_aligned(T, pos);
  const bool vec_seg = sm90::rows_aligned(T, segs);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const uint32_t*>(keys),
                                             static_cast<const int*>(segs),
                                             static_cast<const int*>(g), static_cast<int*>(pos),
                                             n_tiles, T, s, sub, F, Y, vec, vec_seg);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSeg, int kR>
int launch_form(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
                int s, int sub, const sm90::Label& F, bool ids, cudaStream_t stream) {
  // an ids strip is read under the identity label: always the clamp form
  if (ids || F.form == sm90::kClampedId)
    return launch<kSeg, kR, sm90::kClampedId>(keys, segs, g, pos, n_tiles, T, s, sub, F, stream);
  if (F.form == sm90::kShiftMask)
    return launch<kSeg, kR, sm90::kShiftMask>(keys, segs, g, pos, n_tiles, T, s, sub, F, stream);
  return launch<kSeg, kR, sm90::kAnySpec>(keys, segs, g, pos, n_tiles, T, s, sub, F, stream);
}

template <bool kSeg>
int launch_tile(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
                int s, int sub, const sm90::Label& F, bool ids, cudaStream_t stream) {
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps)
    return launch_form<kSeg, 16>(keys, segs, g, pos, n_tiles, T, s, sub, F, ids, stream);
  return launch_form<kSeg, 32>(keys, segs, g, pos, n_tiles, T, s, sub, F, ids, stream);
}

}  // namespace

// keys: the key words (labels in the kernel, ids null) or null (labels from
// ids, under the identity label arguments). segs: the segment strip, or
// null for the flat layout (s = 1). sub: the subtile, 1 to 255 keys.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py), m outside [1, 256], a subtile outside
// [1, 255] or no segment.
extern "C" int ms_packed_tile_positions(const void* keys, const void* ids, const void* segs,
                                        const void* g, void* pos, int n_tiles, int T, int s,
                                        int sub, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || m < 1 || m > ms::kMaxBuckets || sub < 1 || sub > kMaxSub ||
      s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  const void* x = ids ? ids : keys;                  // the label words
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return segs ? launch_tile<true>(x, segs, g, pos, n_tiles, T, s, sub, F, ids != nullptr, st)
              : launch_tile<false>(x, segs, g, pos, n_tiles, T, s, sub, F, ids != nullptr, st);
}
