// K3s: the segmented DMS postscan with labels in the kernel: global
// destinations G[cid] + rank in element order, cid = seg·m + b, with no
// reorder.
//
// Replaces seg_spec_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:544) and its BitfieldSpec instance
// seg_radix_tile_positions_pallas (src/repro/kernels/radix_pass.py:84).
// Launched on a materialised int32 ids strip as its keys under the identity
// label (min(max(id, 0), m - 1)), it is also seg_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:259).
//
// keys (L, T) 32-bit words, seg (L, T) int32 non-decreasing along each
// tile, G (L, s·m) int32 -> pos (L, T) int32. The rank counts the earlier
// keys of the same cid in the tile, which all lie in the same segment run.
// int32 throughout: the Pallas kernel adds G and the rank in float32, wrong
// from 2^24 on.
//
// Bound: memory. It reads 4 bytes a key and the G bases its keys hit (4
// bytes for each distinct cid of a tile, the nonzeros of the tile's
// histogram row) and writes 4 bytes a key; of the strip it needs the two
// end ids of a tile of one segment run and all T ids of any other tile:
// (8·L·T + 4·nnz(H) + 8·L1 + 4·T·L2) bytes / 3.35 TB/s on an H100 SXM, L1
// the tiles of one run, L2 the others.
//
// Design for Hopper: K3's (tile_positions.cu) on a tile of one run, K2s's
// run split (seg_fused_postscan_reorder.cu) on any other.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR = 16
//   keys' (rank, bucket) (T <= 4096; 32 up to 8192) in registers.
// * Staged tiles: a tile's keys are copied into a stage in shared memory
//   with cp.async (16 bytes a copy where the keys' and pos's rows are
//   16-byte aligned, else one word a copy), and beside them the tile's
//   m-wide row of G at tile·s·m + seg·m when its end ids agree (one run),
//   else its strip of segment ids. The next tile's two end ids are copied
//   with the stage before it, so the choice is made from shared memory and
//   never waits for device memory. Two stages (the next tile's copies in
//   flight during the current one) where they cost no block an SM.
// * A tile of one run takes K3's path whole: the warps' contiguous rounds,
//   peers from ballots over the label's bits, warp counters in shared
//   memory, (rank, bucket) in registers (sm90::warp_rank); one thread a
//   bucket turns the counters into G[b] + the warps' offsets; each lane
//   writes pos = counter + rank into the stage's key slot it read.
// * Any other tile is split as K2s splits it (ms::split_runs): a ballot a
//   32-key chunk flags the run starts; a run of at most ms::kShortRun keys
//   is solved by the warp that meets it (__match_any_sync peers, its rank
//   among them, G read directly); the long runs are listed and take K3's
//   path over [a, e) one after another, their bases read from G directly.
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
static_assert(kWarps == ms::kWarps, "ms::split_runs walks the chunks with ms::kWarps warps");

struct Layout {
  int pitch;          // words of the key plane: T rounded up to 16 bytes
  int g_off;          // G's row in a stage: in the strip's slot, at pitch (a
                      // field, not Y.pitch in the code: so the T > 4096
                      // shift-form instance fits 128 registers, ptxas)
  int stage_words;    // pitch + the larger of the strip (pitch) and G's row (m)
  int stages;         // 1 or 2
};

// blocks an SM the registers must allow, as K3's: four up to T = 4096, two
// above; one fewer (one above 4096) for the general label form
template <int kR, int kForm>
constexpr int min_blocks() {
  return kR <= 16 ? (kForm == sm90::kAnySpec ? 3 : 4) : (kForm == sm90::kAnySpec ? 1 : 2);
}

template <int kR, int kForm>
__global__ void __launch_bounds__(kThreads, min_blocks<kR, kForm>())
    seg_tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ segs,
                              const int* __restrict__ g, int* __restrict__ pos, int n_tiles,
                              int T, int s, sm90::Label F, Layout Y, bool vec, bool vec_seg) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  __shared__ unsigned flags[ms::kMaxChunks];         // run starts, one ballot a chunk
  __shared__ int2 longs[ms::kMaxLong];               // the tile's long runs [a, e)
  __shared__ int n_long;
  __shared__ int2 ends[3];                           // end ids of a block's tiles k mod 3
  const int m = F.L.m;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;

  // the block's k-th tile into stage st: its keys, and its row of G (one
  // run) or its strip; the end ids of its k + 1-th tile beside them
  auto stage = [&](int tile, int st, int k) {
    const int2 e = ends[k % 3];
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
    if (tid == 0 && after < n_tiles) {
      const int* sa = segs + static_cast<size_t>(after) * T;
      sm90::copy4(&ends[(k + 1) % 3].x, sa);
      sm90::copy4(&ends[(k + 1) % 3].y, sa + T - 1);
    }
  };

  ms::load_splitters(F.L, sp);
  for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
  if (tid == 0 && static_cast<int>(blockIdx.x) < n_tiles) {
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
    const int2 e = ends[k % 3];
    const bool one_run = e.x == e.y;

    // A, B. several runs: short ones solved by the warp that meets them,
    // long ones listed
    int nl = 1;
    if (!one_run) {
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

    // C. K3's path over a run [a, e): the tile when it is one run, else each
    // long run, one after another
    for (int q = 0; q < nl; ++q) {
      const int a = one_run ? 0 : longs[q].x, len = (one_run ? T : longs[q].y) - a;
      const int nr = (len + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
      const int r0 = warp * R, r1 = min(r0 + R, nr);

      // 1. the warp's rounds of the run in order, (rank, bucket) in registers
      int meta[kR];
      sm90::warp_rank<kR, kForm>(ks + a, len, F, sp, mine, r0, r1, nbits, meta);
      __syncthreads();

      // 2. the warp counters become G[seg·m + b] + the warps' exclusive offsets
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
              static_cast<uint32_t>(mine[meta[r] & label_mask] + (meta[r] >> ms::kLabelBits));
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

template <int kR, int kForm>
int launch(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
           int s, const sm90::Label& F, cudaStream_t stream) {
  auto kernel = seg_tile_positions_kernel<kR, kForm>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.g_off = Y.pitch;
  const int g_words = (F.L.m + 3) & ~3;
  Y.stage_words = Y.pitch + (Y.pitch > g_words ? Y.pitch : g_words);
  const size_t counters = sizeof(int) * static_cast<size_t>(kWarps) * F.L.m;
  const size_t one = sizeof(uint32_t) * static_cast<size_t>(Y.stage_words) + counters;
  const size_t two = one + sizeof(uint32_t) * static_cast<size_t>(Y.stage_words);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  if (sm90::report(kernel, kThreads, Y.stages, smem, &err)) return static_cast<int>(err);
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, keys) && sm90::rows_aligned(T, pos);
  const bool vec_seg = sm90::rows_aligned(T, segs);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const uint32_t*>(keys),
                                             static_cast<const int*>(segs),
                                             static_cast<const int*>(g), static_cast<int*>(pos),
                                             n_tiles, T, s, F, Y, vec, vec_seg);
  return static_cast<int>(cudaGetLastError());
}

template <int kR>
int launch_form(const void* keys, const void* segs, const void* g, void* pos, int n_tiles, int T,
                int s, const sm90::Label& F, cudaStream_t stream) {
  if (F.form == sm90::kShiftMask)
    return launch<kR, sm90::kShiftMask>(keys, segs, g, pos, n_tiles, T, s, F, stream);
  if (F.form == sm90::kClampedId)
    return launch<kR, sm90::kClampedId>(keys, segs, g, pos, n_tiles, T, s, F, stream);
  return launch<kR, sm90::kAnySpec>(keys, segs, g, pos, n_tiles, T, s, F, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py), m outside [1, 256] or no segment.
extern "C" int ms_seg_tile_positions(const void* keys, const void* segs, const void* g, void* pos,
                                     int n_tiles, int T, int s, MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || m < 1 || m > ms::kMaxBuckets || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps) return launch_form<16>(keys, segs, g, pos, n_tiles, T, s, F, st);
  return launch_form<32>(keys, segs, g, pos, n_tiles, T, s, F, st);
}
