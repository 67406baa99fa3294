// K3: the DMS postscan with in-kernel labels: global destinations
// G[b] + rank in element order (paper eq. (2)), with no reorder.
//
// Replaces spec_tile_positions_pallas (src/repro/kernels/multisplit_tile.py:396)
// and its BitfieldSpec instance radix_tile_positions_pallas
// (src/repro/kernels/radix_pass.py:46). Launched on a materialised int32
// ids strip as its keys under the identity label (min(max(id, 0), m - 1)),
// it is also tile_positions_pallas (src/repro/kernels/multisplit_tile.py:123).
//
// keys (L, T) 32-bit words, G (L, m) int32 -> pos (L, T) int32. The Pallas
// kernel adds G and the rank in float32, which is wrong from 2^24 on; this
// one is exact for every n < 2^31.
//
// Bound: memory. It reads 4 bytes a key and 4·m bytes of G a tile and
// writes 4 bytes a key: (8·L·T + 4·L·m) bytes / 3.35 TB/s on an H100 SXM.
//
// Design for Hopper, K2's (fused_postscan_reorder.cu) without the reorder.
// * Persistent blocks of 8 warps, as many as fit on the card at once;
//   block k takes tiles k, k + gridDim.x, ... A lane holds up to kR = 16
//   keys' (rank, bucket) (T <= 4096; 32 up to 8192) in registers; the
//   launch bounds ask for four blocks an SM (at most 64 registers) up to
//   T = 4096, two above, one fewer for the general label form.
// * Staged tiles: a tile's keys and its row of G are copied into a stage in
//   shared memory with cp.async, 16 bytes a copy where the keys' and pos's
//   rows are 16-byte aligned (T % 4 == 0, both planes 16-byte aligned), else
//   one word a copy. Two stages (the next tile's copies fly during the
//   current tile's rank and write-out) where they cost no block an SM: at
//   T = 4096 and m = 256 a block takes 2 x 17 KiB of stage and 8 KiB of
//   counters, 43 KiB.
// * Labels in the cheapest form the spec allows (a template flag,
//   multisplit_sm90.cuh): a shift and a mask for BitfieldSpec and DeltaSpec
//   over a power of two, a clamp for ids, ms::bucket_of for the rest.
// * K2's rank (sm90::warp_rank): each warp owns a contiguous run of 32-key
//   rounds of the tile, peers from ballots over the label's bits,
//   warp-private counters in shared memory, each lane's (rank, bucket) in
//   registers. No meta plane and no second walk.
// * One thread a bucket turns the warp counters into G[b] + the warps'
//   exclusive offsets; each lane then writes pos = counter + rank into the
//   stage's key slot it read, and the block writes the row from the stage,
//   16 bytes a store where aligned.
#include "multisplit_sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8192;                       // MAX_TILE of multisplit_tile.py
static_assert(kWarps == ms::kWarps, "ms::rounds of multisplit_common.cuh");

struct Layout {
  int pitch;          // words of the key plane: T rounded up to 16 bytes
  int stage_words;    // pitch + m rounded up to 16 bytes (G's row)
  int stages;         // 1 or 2
};

// blocks an SM the registers must allow: four up to T = 4096, two above;
// one fewer (one above 4096) for the general label, whose bucket_of needs
// more registers than 64 (or 128) and spills there
template <int kR, int kForm>
constexpr int min_blocks() {
  return kR <= 16 ? (kForm == sm90::kAnySpec ? 3 : 4) : (kForm == sm90::kAnySpec ? 1 : 2);
}

template <int kR, int kForm>
__global__ void __launch_bounds__(kThreads, min_blocks<kR, kForm>())
    tile_positions_kernel(const uint32_t* __restrict__ keys, const int* __restrict__ g,
                          int* __restrict__ pos, int n_tiles, int T, sm90::Label F, Layout Y,
                          bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t sp[ms::kMaxBuckets];
  const int m = F.L.m;
  int* const cnt = reinterpret_cast<int*>(smem + Y.stages * Y.stage_words);   // [kWarps][m]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nr = (T + 31) >> 5, R = (nr + kWarps - 1) / kWarps;
  const int r0 = warp * R, r1 = min(r0 + R, nr);
  const int nbits = sm90::label_bits(m);
  int* const mine = cnt + warp * m;

  auto stage = [&](int tile, int s) {
    uint32_t* const ks = smem + s * Y.stage_words;
    sm90::stage_row<kThreads>(ks, keys + static_cast<size_t>(tile) * T, T, vec);
    const int* grow = g + static_cast<size_t>(tile) * m;
    for (int b = tid; b < m; b += kThreads) sm90::copy4(ks + Y.pitch + b, grow + b);
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

    uint32_t* const ks = smem + s * Y.stage_words;
    const int* const gs = reinterpret_cast<const int*>(ks + Y.pitch);

    // 1. the warp's rounds in order, (rank, bucket) of each key in registers
    int meta[kR];
    sm90::warp_rank<kR, kForm>(ks, T, F, sp, mine, r0, r1, nbits, meta);
    __syncthreads();

    // 2. the warp counters become G[b] + the warps' exclusive offsets
    if (tid < m) {
      int run = gs[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w * m + tid];
        cnt[w * m + tid] = run;
        run += c;
      }
    }
    __syncthreads();

    // 3. pos = G[b] + offset + rank, into the key slot each lane read
    const int label_mask = (1 << ms::kLabelBits) - 1;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T)
        ks[i] = static_cast<uint32_t>(mine[meta[r] & label_mask] + (meta[r] >> ms::kLabelBits));
    }
    __syncthreads();                                 // every counter is read

    // 4. the row of pos from the stage; the counters zeroed for the next tile
    for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
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
int launch(const void* keys, const void* g, void* pos, int n_tiles, int T,
           const sm90::Label& F, cudaStream_t stream) {
  auto kernel = tile_positions_kernel<kR, kForm>;
  Layout Y;
  Y.pitch = (T + 3) & ~3;
  Y.stage_words = Y.pitch + ((F.L.m + 3) & ~3);
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
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const uint32_t*>(keys),
                                             static_cast<const int*>(g), static_cast<int*>(pos),
                                             n_tiles, T, F, Y, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kR>
int launch_form(const void* keys, const void* g, void* pos, int n_tiles, int T,
                const sm90::Label& F, cudaStream_t stream) {
  if (F.form == sm90::kShiftMask)
    return launch<kR, sm90::kShiftMask>(keys, g, pos, n_tiles, T, F, stream);
  if (F.form == sm90::kClampedId)
    return launch<kR, sm90::kClampedId>(keys, g, pos, n_tiles, T, F, stream);
  return launch<kR, sm90::kAnySpec>(keys, g, pos, n_tiles, T, F, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py) or m outside [1, 256].
extern "C" int ms_tile_positions(const void* keys, const void* g, void* pos, int n_tiles, int T,
                                 MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > kMaxTile || m < 1 || m > ms::kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // rounds a warp: at most 16 up to T = 4096, 32 up to kMaxTile
  if (T <= 16 * 32 * kWarps) return launch_form<16>(keys, g, pos, n_tiles, T, F, s);
  return launch_form<32>(keys, g, pos, n_tiles, T, F, s);
}
