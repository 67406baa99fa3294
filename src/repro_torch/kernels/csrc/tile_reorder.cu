// B10: the standalone tile reorder of the unfused baseline (paper §4.7).
// Replaces tile_reorder_pallas (src/repro/kernels/multisplit_tile.py:1061),
// whose oracle is tile_reorder (src/repro/kernels/ref.py:37).
//
// ids (L, T) int32, keys (L, T) 32-bit words, optional values (L, T) 32-bit
// words -> keys_r, vals_r (L, T), stably bucket-major within each tile, and
// dest (L, T) int32, each element's destination inside its tile,
// starts[id] + rank, in element order. There is no G and no global
// destination: this is K2's ids body (fused_postscan_reorder.cu) without
// the G read and without pos_r / perm. Ids are clamped into [0, m), as
// every ids kernel clamps them.
//
// Bound: memory. It reads ids, keys and values (12 bytes a key) and writes
// keys_r, vals_r and dest (12 bytes a key): 24·L·T bytes key-value, 16·L·T
// key-only, over 3.35 TB/s on an H100 SXM. The rank and the scans stay in
// registers and shared memory; the Pallas kernel's T×T permutation matmuls
// have no counterpart here.
//
// Design for Hopper, K2's skeleton.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR keys'
//   (rank, bucket) in registers: 4 at T <= 1024 (three blocks an SM), 16
//   up to 4096 (two), 32 up to 8192 (one).
// * Staged tiles: a tile's ids, keys and values are copied into a stage in
//   shared memory with cp.async, 16 bytes a copy where every row is 16-byte
//   aligned (T % 4 == 0 and every plane 16-byte aligned), else one word a
//   copy. Two stages (the next tile's copies in flight during the current
//   one) where they cost no block an SM (sm90::pick_stages): key-value at T
//   = 4096 a stage is 48 KiB and a block 104 KiB, two blocks an SM; at T =
//   8192 one block an SM either way.
// * K2's rank on the staged ids (sm90::warp_rank, the clamp form): each
//   warp walks its contiguous rounds of 32 ids in order, a round's peers
//   from ballots over the label's bits, warp-private counters in shared
//   memory, (rank, bucket) in registers.
// * One thread a bucket turns the counters into exclusive offsets over the
//   warps, one block scan gives the tile's bucket starts, and the counters
//   become start[b] + warp offset; dest = that + rank is stored from
//   registers in element order (a 128-byte store a round).
// * The reorder without a register copy of the keys, as K2p's flat path
//   moves them: the ids plane is dead once ranked, so each key goes
//   straight to its bucket-major slot there; once every key is out, each
//   value goes to its slot in the key plane.
// * Write-out: keys_r from the ids plane and vals_r from the key plane, a
//   plane at a time, 16 bytes a store where the rows are aligned.
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
static_assert(kWarps == ms::kWarps, "the block scan of multisplit_common.cuh");

struct Layout {
  int pitch;          // words a plane of one stage: T rounded up to 16 bytes
  int planes;         // ids, keys [+ values]
  int stage_words;    // planes·pitch
  int stages;         // 1 or 2
};

// blocks an SM the registers must allow: two up to T = 4096 (kR = 16, 128
// registers, as K2), one above; at T <= 1024 (kR = 4, the unfused wms
// tile, whose per-tile barriers and scan take most of a block's time) three
// (80 registers): 34 % faster than two, where four spill 56 bytes and took
// 28 % longer than three (tools/k3pb10_variants.py)
template <int kR>
constexpr int min_blocks() {
  return kR <= 4 ? 3 : (kR <= 16 ? 2 : 1);
}

template <int kR>
__global__ void __launch_bounds__(kThreads, min_blocks<kR>())
    tile_reorder_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ keys,
                        const uint32_t* __restrict__ vals, uint32_t* __restrict__ keys_r,
                        uint32_t* __restrict__ vals_r, int* __restrict__ dest, int n_tiles, int T,
                        sm90::Label F, Layout Y, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int wsum[kWarps];
  const int m = F.L.m;
  const bool has_vals = vals != nullptr;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nr = (T + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
  const int r0 = warp * R, r1 = min(r0 + R, nr);
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;

  // the stage's planes: ids, keys, values (if any)
  auto plane = [&](int st, int p) { return smem + st * Y.stage_words + p * Y.pitch; };
  auto stage = [&](int tile, int st) {
    const size_t off = static_cast<size_t>(tile) * T;
    sm90::stage_row<kThreads>(plane(st, 0), ids + off, T, vec);
    sm90::stage_row<kThreads>(plane(st, 1), keys + off, T, vec);
    if (has_vals) sm90::stage_row<kThreads>(plane(st, 2), vals + off, T, vec);
  };

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

    uint32_t* const ip = plane(st, 0);               // ids, then keys_r
    uint32_t* const ks = plane(st, 1);               // keys, then vals_r
    const uint32_t* const vs = plane(st, 2);         // values
    const size_t base = static_cast<size_t>(tile) * T;

    // 1. the warp's rounds of ids in order, (rank, bucket) in registers
    int rb[kR];
    sm90::warp_rank<kR, sm90::kClampedId>(ip, T, F, nullptr, mine, r0, r1, nbits, rb);
    __syncthreads();                                 // every id is read

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
    if (tid < m)
      for (int w = 0; w < kWarps; ++w) cnt[w * m + tid] += first;
    __syncthreads();

    // 3. dest in element order; each key to its slot in the dead ids plane
    const int label_mask = (1 << ms::kLabelBits) - 1;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T) {
        const int d = mine[rb[r] & label_mask] + (rb[r] >> ms::kLabelBits);
        dest[base + i] = d;
        ip[d] = ks[i];
        rb[r] = d;
      }
    }
    __syncthreads();                                 // every key is out of the key plane
    for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;

    // 4. each value to its slot in the key plane
    if (has_vals) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < T) ks[rb[r]] = vs[i];
      }
      __syncthreads();
    }

    // 5. write-out of keys_r and vals_r rows, a plane at a time
    if (vec) {
      const int nv = T >> 2;
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(ip)[v];
      if (has_vals)
        for (int v = tid; v < nv; v += kThreads)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];
    } else {
      for (int j = tid; j < T; j += kThreads) {
        keys_r[base + j] = ip[j];
        if (has_vals) vals_r[base + j] = ks[j];
      }
    }
  }
}

template <int kR>
int launch(const void* ids, const void* keys, const void* vals, void* keys_r, void* vals_r,
           void* dest, int n_tiles, int T, int m, cudaStream_t stream) {
  auto kernel = tile_reorder_kernel<kR>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.planes = 2 + (vals != nullptr);
  Y.stage_words = Y.planes * Y.pitch;
  const size_t stage_bytes = sizeof(uint32_t) * static_cast<size_t>(Y.stage_words);
  const size_t one = stage_bytes + sizeof(int) * static_cast<size_t>(kWarps) * m;
  const size_t two = one + stage_bytes;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = sm90::rows_aligned(T, ids) && sm90::rows_aligned(T, keys) &&
                   sm90::rows_aligned(T, vals) && sm90::rows_aligned(T, keys_r) &&
                   sm90::rows_aligned(T, vals_r) && sm90::rows_aligned(T, dest);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(ids), static_cast<const uint32_t*>(keys),
      static_cast<const uint32_t*>(vals), static_cast<uint32_t*>(keys_r),
      static_cast<uint32_t*>(vals_r), static_cast<int*>(dest), n_tiles, T,
      sm90::make_label(ms::identity_label(m)), Y, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals and vals_r are null for a key-only reorder. Returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a tile the
// kernel does not take (T above 8192, MAX_TILE of multisplit_tile.py) or m
// outside [1, 256].
extern "C" int ms_tile_reorder(const void* ids, const void* keys, const void* vals, void* keys_r,
                               void* vals_r, void* dest, int n_tiles, int T, int m, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || m < 1 || m > ms::kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rounds a warp: at most 4 up to T = 1024, 16 up to 4096, 32 up to kMaxTile
  if (T <= 4 * 32 * kWarps)
    return launch<4>(ids, keys, vals, keys_r, vals_r, dest, n_tiles, T, m, st);
  if (T <= 16 * 32 * kWarps)
    return launch<16>(ids, keys, vals, keys_r, vals_r, dest, n_tiles, T, m, st);
  return launch<32>(ids, keys, vals, keys_r, vals_r, dest, n_tiles, T, m, st);
}
