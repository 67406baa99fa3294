// K1: per-tile bucket histograms with in-kernel labels (the prescan direct
// solve, paper Alg. 2).
//
// Replaces spec_tile_histograms_pallas (src/repro/kernels/multisplit_tile.py:368)
// and its BitfieldSpec instance radix_tile_histograms_pallas
// (src/repro/kernels/radix_pass.py:37). Launched on a materialised int32
// ids strip as its keys under the identity label (min(max(id, 0), m - 1)),
// it is also tile_histograms_pallas (src/repro/kernels/multisplit_tile.py:94).
//
// keys (L, T) 32-bit words -> hist (L, m) int32.
//
// Bound: memory. It reads 4 bytes a key and writes 4·m bytes a tile, so the
// least time is (4·L·T + 4·L·m) bytes / 3.35 TB/s on an H100 SXM; the
// counting happens in registers and shared memory.
//
// Design for Hopper. A histogram is order-free: integer counts added in any
// order give the same bits, so K1 ranks nothing.
// * Persistent blocks of 512 threads, as many as fit on the card at once
//   (four an SM up to T = 4096: 32 registers a thread); block k counts
//   tiles k, k + gridDim.x, ... and writes each tile's row of hist where the
//   contract puts it.
// * Labels in the cheapest form the spec allows (a template flag): a shift
//   and a mask for BitfieldSpec and DeltaSpec over a power of two, a clamp
//   for ids, ms::bucket_of for the rest (multisplit_sm90.cuh). On an H100
//   the general form takes 10-18 % longer on the main shape than the shift
//   form, and three blocks an SM 6-10 % longer than four
//   (tools/k1k2_variants.py).
// * Vector loads: each thread holds its keys of a tile in registers (kVec
//   16-byte vectors, 4·kVec keys) and issues the next tile's loads as soon
//   as its part of the current row is summed; the other blocks of its SM
//   count meanwhile. A second register set, loaded while the current tile
//   counts, took 1-4 % longer at four blocks an SM on an H100. Rows that
//   are not 16-byte aligned (T % 4 != 0, or a plane that starts off a
//   16-byte boundary) take the same path with one 4-byte load a key.
// * Counting: shared-memory atomicAdd into C copies of the m counters, lane
//   l adding into copy l % C (C = 32 at m <= 63, 8 at m = 256: C·(m | 1)
//   words, at most 2056), so a warp's lanes collide only where they share a
//   copy and a bucket; the odd stride m | 1 puts the copies' counters of one
//   bucket in different banks. Every key of a tile in one bucket makes
//   32 / C lanes collide on one counter (4 at m = 256): on an H100 that
//   tile counts within 3 % of uniform keys, and a warp-uniform shortcut
//   (one add of 32 when a round's labels agree, a shuffle and a vote a
//   round) made them 0-5 % slower, so there is none.
// * Two sets of copies, used by turns: the sum of tile i's set into its row
//   (one coalesced store per tile, thread b summing bucket b over the
//   copies and zeroing them) runs while tile i + 1 counts into the other,
//   so one barrier a tile separates the phases.
#include "multisplit_sm90.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCopyWords = 2056;                     // a set of copies: 8 x 257 at m = 256

template <int kVec, int kForm>
__global__ void __launch_bounds__(kThreads, kVec <= 2 ? 4 : 2)
    tile_histograms_kernel(const uint32_t* __restrict__ keys, int* __restrict__ hist,
                           int n_tiles, int T, sm90::Label F, int copies, int stride, bool vec) {
  extern __shared__ int cnt[];                       // [2][copies·stride]
  __shared__ uint32_t sp[ms::kMaxBuckets];
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = F.L.m;
  const int set_words = copies * stride;
  ms::load_splitters(F.L, sp);
  for (int j = tid; j < 2 * set_words; j += kThreads) cnt[j] = 0;
  int* const mine = cnt + (lane & (copies - 1)) * stride;

  uint32_t cur[4 * kVec];
  auto load = [&](uint32_t (&buf)[4 * kVec], int tile) {
    sm90::load_keys<kVec, kThreads>(buf, keys + static_cast<size_t>(tile) * T, T, vec);
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) load(cur, blockIdx.x);
  __syncthreads();                                   // counters zero, splitters loaded

  int set = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, set ^= 1) {
    int* const base = cnt + set * set_words;
    sm90::count_keys<kVec, kThreads, kForm>(
        cur, T, F, sp, [&](int, int b) { atomicAdd(mine + set * set_words + b, 1); });
    __syncthreads();                                 // this tile's counts are whole
    if (tid < m) {
      int s = 0;
      for (int c = 0; c < copies; ++c) {
        s += base[c * stride + tid];
        base[c * stride + tid] = 0;
      }
      hist[static_cast<size_t>(tile) * m + tid] = s;
    }
    const int next = tile + static_cast<int>(gridDim.x);
    if (next < n_tiles) load(cur, next);
  }
}

template <int kVec, int kForm>
int launch(const void* keys, void* hist, int n_tiles, int T, const sm90::Label& F, int copies,
           int stride, bool vec, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(copies) * stride;
  auto kernel = tile_histograms_kernel<kVec, kForm>;
  cudaError_t err = ms::allow_smem(kernel, smem);
  if (err != cudaSuccess) return ms::smem_refused(err);
  if (sm90::report(kernel, kThreads, 1, smem, &err)) return static_cast<int>(err);
  int blocks = 0;
  if (err == cudaSuccess) err = sm90::persistent_grid(kernel, kThreads, smem, n_tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const uint32_t*>(keys),
                                             static_cast<int*>(hist), n_tiles, T, F, copies,
                                             stride, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kVec>
int launch_form(const void* keys, void* hist, int n_tiles, int T, const sm90::Label& F,
                int copies, int stride, bool vec, cudaStream_t stream) {
  if (F.form == sm90::kShiftMask)
    return launch<kVec, sm90::kShiftMask>(keys, hist, n_tiles, T, F, copies, stride, vec, stream);
  if (F.form == sm90::kClampedId)
    return launch<kVec, sm90::kClampedId>(keys, hist, n_tiles, T, F, copies, stride, vec, stream);
  return launch<kVec, sm90::kAnySpec>(keys, hist, n_tiles, T, F, copies, stride, vec, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192,
// MAX_TILE of multisplit_tile.py) or m outside [1, 256].
extern "C" int ms_tile_histograms(const void* keys, void* hist, int n_tiles, int T,
                                  MS_LABEL_PARAMS, void* stream) {
  if (n_tiles == 0) return 0;
  if (T < 1 || T > 4 * 4 * kThreads || m < 1 || m > ms::kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Label F = sm90::make_label(ms::make_label(MS_LABEL_ARGS));
  const int stride = m | 1;
  const int copies = sm90::counter_copies(m, kCopyWords);
  const bool vec = sm90::rows_aligned(T, keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 4 * kThreads) return launch_form<1>(keys, hist, n_tiles, T, F, copies, stride, vec, s);
  if (T <= 8 * kThreads) return launch_form<2>(keys, hist, n_tiles, T, F, copies, stride, vec, s);
  return launch_form<4>(keys, hist, n_tiles, T, F, copies, stride, vec, s);
}
