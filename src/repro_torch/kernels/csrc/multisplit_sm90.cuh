// Shared code of the Hopper designs of K1 (tile_histograms.cu), K2
// (fused_postscan_reorder.cu), K3 (tile_positions.cu), K1s
// (seg_tile_histograms.cu), K2s (seg_fused_postscan_reorder.cu) and K3s
// (seg_tile_positions.cu), of K1p (packed_tile_histograms.cu), K2p
// (packed_fused_postscan_reorder.cu), K3p (packed_tile_positions.cu), K2f
// and K3f (multisplit_fused2.cuh), and of B10 (tile_reorder.cu): labels in
// a few cheap forms beside the general one, the rows' alignment, the
// persistent grid from the occupancy the kernel gets, a tile's keys in
// registers and their order-free count into copies of the counters (K1,
// K1s, K1p), the cp.async staging of rows into shared memory with the
// choice of one or two stages, and the stable warp rank of a staged run, in
// the onehot family's form and in the packed family's.
//
// The labels are ms::bucket_of's (multisplit_common.cuh) bit for bit: a
// DeltaSpec over delta = 2^k computes q = u >> k where bucket_of computes
// q = u / delta, the same integer for every u; a BitfieldSpec's field is at
// most 2^bits - 1 = m - 1, so the clamp leaves it; an id clamps as
// bucket_of clamps it; every other spec calls bucket_of itself.
#pragma once

#include "multisplit_common.cuh"

namespace sm90 {

// The forms a label takes: any spec through ms::bucket_of; a shift and a
// mask of the key word (BitfieldSpec, and DeltaSpec over delta = 2^k on
// integer keys: min((w >> shift) & mask, m - 1)); the identity over int32
// words (an ids strip, IdentitySpec on integer keys: min(max(w, 0), m - 1)).
enum Form { kAnySpec = 0, kShiftMask = 1, kClampedId = 2 };

// A spec's label arguments with its form, and the DeltaSpec shift (-1: no
// shift) that the kAnySpec form takes for float keys.
struct Label {
  ms::Label L;
  int dshift;
  int form;
  unsigned shift, mask;
};

inline Label make_label(const ms::Label& L) {
  Label F;
  F.L = L;
  F.dshift = -1;
  F.form = kAnySpec;
  F.shift = 0u;
  F.mask = 0u;
  if (L.kind == ms::kDelta && L.u0 != 0u && (L.u0 & (L.u0 - 1u)) == 0u) {
    int k = 0;
    while ((1u << k) != L.u0) ++k;
    F.dshift = k;
    if (L.key_kind != ms::kF32) {
      F.form = kShiftMask;
      F.shift = static_cast<unsigned>(k);
      F.mask = 0xffffffffu;
    }
  } else if (L.kind == ms::kBitfield) {
    F.form = kShiftMask;
    F.shift = L.u0;
    F.mask = L.u1;
  } else if (L.kind == ms::kIdentity && L.key_kind != ms::kF32) {
    F.form = kClampedId;
  }
  return F;
}

template <int kForm = kAnySpec>
__device__ __forceinline__ int label_of(uint32_t w, const Label& F, const uint32_t* sp) {
  if (kForm == kShiftMask)
    return static_cast<int>(min((w >> F.shift) & F.mask, static_cast<uint32_t>(F.L.m - 1)));
  if (kForm == kClampedId) return min(max(static_cast<int>(w), 0), F.L.m - 1);
  if (F.dshift >= 0) {
    // (uint32)u saturates for float keys (NaN -> 0), as bucket_of does
    const uint32_t u = F.L.key_kind == ms::kF32 ? __float2uint_rz(__uint_as_float(w)) : w;
    const uint32_t q = u >> F.dshift;
    return q < static_cast<uint32_t>(F.L.m - 1) ? static_cast<int>(q) : F.L.m - 1;
  }
  return ms::bucket_of(w, F.L, sp);
}

// A (L, T) plane of 32-bit words whose rows are all 16-byte aligned (or no
// plane at all): T a multiple of 4 and the plane's start 16-byte aligned.
inline bool rows_aligned(int T, const void* plane) {
  return T % 4 == 0 && (plane == nullptr || reinterpret_cast<uintptr_t>(plane) % 16 == 0);
}

// Persistent grid: the blocks that fit on the card at once (at least one
// an SM), at most one a tile.
template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem, int n_tiles, int* blocks) {
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(fit > 1 ? fit : 1) * sms;
  *blocks = n_tiles < resident ? n_tiles : static_cast<int>(resident);
  return cudaSuccess;
}

// A tile's keys in registers, as K1 and K1s hold them: key j of a thread is
// element key_at<kThreads>(j) of the row, kVec 16-byte vectors of four keys
// (one 4-byte load a key where `vec` is false); slots past T are left as
// they are.
template <int kThreads>
__device__ __forceinline__ int key_at(int j) {
  return ((j >> 2) * kThreads + static_cast<int>(threadIdx.x)) * 4 + (j & 3);
}

template <int kVec, int kThreads>
__device__ __forceinline__ void load_keys(uint32_t (&buf)[4 * kVec],
                                          const uint32_t* __restrict__ row, int T, bool vec) {
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = key_at<kThreads>(4 * v);           // the vector's first key
    if (vec) {
      if (e < T) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + e));
        buf[4 * v] = x.x;
        buf[4 * v + 1] = x.y;
        buf[4 * v + 2] = x.z;
        buf[4 * v + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e + c < T) buf[4 * v + c] = __ldg(row + e + c);
    }
  }
}

// The order-free count of a tile's register-held keys: add(e, b) for each
// key inside the row, e its element and b its label. The caller's add does
// the shared-memory atomicAdd into its copy of the counters.
template <int kVec, int kThreads, int kForm, typename Add>
__device__ __forceinline__ void count_keys(const uint32_t (&buf)[4 * kVec], int T, const Label& F,
                                           const uint32_t* sp, Add add) {
#pragma unroll
  for (int j = 0; j < 4 * kVec; ++j) {
    const int e = key_at<kThreads>(j);
    if (e < T) add(e, label_of<kForm>(buf[j], F, sp));
  }
}

// Copies of `words` counters (a power of two, at most 32) that fit in
// `budget` words at the odd stride words | 1; lane l counts into copy
// l % copies.
__host__ __device__ inline int counter_copies(int words, int budget) {
  int copies = 32;
  while (copies > 1 && copies * (words | 1) > budget) copies >>= 1;
  return copies;
}

// cp.async: 16 bytes (both addresses 16-byte aligned) or 4 bytes, global ->
// shared, completed by copy_wait_all and a barrier.
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One (T) row of 32-bit words into shared memory by a block of kThreads:
// 16-byte copies where `vec` (T % 4 == 0 and both rows 16-byte aligned),
// else one word a copy.
template <int kThreads>
__device__ __forceinline__ void stage_row(uint32_t* dst, const uint32_t* __restrict__ src, int T,
                                          bool vec) {
  if (vec) {
    for (int v = threadIdx.x; v < (T >> 2); v += kThreads) copy16(dst + 4 * v, src + 4 * v);
  } else {
    for (int j = threadIdx.x; j < T; j += kThreads) copy4(dst + j, src + j);
  }
}

// Bits that tell m buckets apart: b < 2^label_bits(m).
__device__ __forceinline__ int label_bits(int m) { return m > 1 ? 32 - __clz(m - 1) : 0; }

// The stable rank of a warp's rounds of a staged run: the run's label words
// are src[0, len), and the warp owns the 32-key rounds [r0, r1) of it, in
// order. A round's lanes of one bucket are found with ballots over the
// label's nbits bits (the peer mask) and ranked by popc(peers &
// lanemask_lt); the warp's private counters `mine` (zeroed before its first
// round) carry the rank from round to round. Round r0 + r leaves (rank
// within the warp's rounds) << ms::kLabelBits | bucket in meta[r], in a
// register.
template <int kR, int kForm>
__device__ __forceinline__ void warp_rank(const uint32_t* src, int len, const Label& F,
                                          const uint32_t* sp, int* mine, int r0, int r1,
                                          int nbits, int (&meta)[kR]) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + r < r1) {
      const int i = ((r0 + r) << 5) + lane;
      const bool valid = i < len;
      const int b = valid ? label_of<kForm>(src[i], F, sp) : 0;
      unsigned peers = __ballot_sync(ms::kFull, valid);
      for (int bit = 0; bit < nbits; ++bit) {
        const bool on = (b >> bit) & 1;
        const unsigned bal = __ballot_sync(ms::kFull, on);
        peers &= on ? bal : ~bal;
      }
      const int before = valid ? mine[b] : 0;        // the same value for all peers
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) mine[b] = before + __popc(peers);
      __syncwarp();
      meta[r] = ((before + __popc(peers & lanemask_lt)) << ms::kLabelBits) | b;
    }
  }
}

// The packed family's stable rank of a warp's rounds of a staged run (paper
// §4.3; the two-level packed rank of the JAX package's packed bodies), in
// the shape of warp_rank: the warp owns the 32-key rounds [r0, r1) of the
// run src[0, len), in order; a round's peers come from __match_any_sync
// (ballots over the label's nbits bits took longer here on an H100,
// tools/k2fk2p_variants.py; nbits serves that variant). The counting
// is two-level:
// * level 1, inside a subtile: the warp's counters are 8-bit lanes, four
//   to a word, ⌈m/4⌉ words at pw; a round's group adds popc(peers) <<
//   8·(b mod 4) to word b / 4 (a shared atomicAdd: two groups can share a
//   word). A subtile is max(1, ⌊sub/32⌋) whole rounds, counted from the
//   run's start: at most sub keys for sub >= 32, one round of 32 below;
// * level 2: after the last round of each subtile, and after the warp's
//   last round, the warp unpacks its words into its int32 carry `mine` (m
//   ints) and zeroes them. No lane can carry into the next: it counts at
//   most max(32, sub) <= 255 keys between two unpacks.
// A key's rank within the warp's rounds is carry + its lane before its
// round + popc(peers & lanemask_lt), whatever the subtile, and round r0 + r
// leaves rank << ms::kLabelBits | bucket in meta[r], in a register. `mine`
// is zeroed by the caller before the first round; pw is zero on entry and
// on exit. kUnrolledUnpack writes the unpack as its two words a lane
// unrolled rather than as a loop: the same work, but ptxas allocates the two
// forms differently (the unrolled one ran faster in K2f's packed stages, the
// loop kept K2p's segmented ids instance from spilling).
template <int kR, int kForm, bool kUnrolledUnpack = true>
__device__ __forceinline__ void packed_warp_rank(const uint32_t* src, int len, const Label& F,
                                                 const uint32_t* sp, int* mine, uint32_t* pw,
                                                 int r0, int r1, int nbits, int sub,
                                                 int (&meta)[kR]) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int m = F.L.m;
  const int rounds = max(1, sub >> 5);               // a subtile's rounds
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + r < r1) {
      const int i = ((r0 + r) << 5) + lane;
      const bool valid = i < len;
      const int b = valid ? label_of<kForm>(src[i], F, sp) : 0;
      const unsigned peers = __match_any_sync(ms::kFull, valid ? b : -1);
      const int q = b >> 2, sh = (b & 3) << 3;
      const int before = valid ? mine[b] + static_cast<int>((pw[q] >> sh) & 0xffu) : 0;
      meta[r] = ((before + __popc(peers & lanemask_lt)) << ms::kLabelBits) | b;
      __syncwarp();                                  // every lane has read its lane
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(pw + q, static_cast<uint32_t>(__popc(peers)) << sh);
      __syncwarp();
      if ((r0 + r + 1) % rounds == 0 || r0 + r + 1 == r1) {   // level 2: unpack into the carry
        auto unpack = [&](int w) {
          const uint32_t x = pw[w];
          pw[w] = 0u;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (4 * w + t < m) mine[4 * w + t] += static_cast<int>((x >> (8 * t)) & 0xffu);
        };
        if (kUnrolledUnpack) {
#pragma unroll
          for (int w0 = 0; w0 < ms::kMaxBuckets / 4; w0 += 32)
            if (w0 + lane < (m + 3) >> 2) unpack(w0 + lane);
        } else {
          for (int w = lane; w < (m + 3) >> 2; w += 32) unpack(w);
        }
        __syncwarp();
      }
    }
  }
}

// One or two stages of staged tiles: two where both fit in the card's
// shared memory beside the kernel's static arrays and cost no block an SM,
// else one. `one` and `two` are the dynamic bytes of each; the kernel is
// opted in to the larger one it may take. Returns the stages and their
// dynamic bytes.
template <typename K>
inline cudaError_t pick_stages(K kernel, int threads, size_t one, size_t two, int* stages,
                               size_t* smem) {
  int dev = 0, optin = 0, per_sm1 = 0, per_sm2 = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const bool two_fit = two + attr.sharedSizeBytes <= static_cast<size_t>(optin);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(two_fit ? two : one));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm1, kernel, threads, one);
  if (err == cudaSuccess && two_fit)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm2, kernel, threads, two);
  if (err != cudaSuccess) return err;
  *stages = two_fit && per_sm2 >= 1 && per_sm2 >= per_sm1 ? 2 : 1;
  *smem = *stages == 2 ? two : one;
  return cudaSuccess;
}

// A launch report in place of a launch: while a thread has set its slot
// (ms_launch_report below), a launcher it calls writes what it would launch
// with -- its stages, its dynamic shared bytes, the blocks an SM the
// occupancy API allows it, the instance's registers and static shared
// bytes, and its threads -- and returns without launching; other threads
// launch as always. The shared-memory model of
// repro_torch/core/pipeline/tiles.py is held against these reports.
inline int*& report_slot() {
  static thread_local int* slot = nullptr;
  return slot;
}

template <typename K>
inline bool report(K kernel, int threads, int stages, size_t smem, cudaError_t* err) {
  int* const out = report_slot();
  if (out == nullptr) return false;
  cudaFuncAttributes attr;
  int fit = 0;
  *err = cudaFuncGetAttributes(&attr, kernel);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem);
  out[0] = stages;
  out[1] = static_cast<int>(smem);
  out[2] = fit;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  out[5] = threads;
  return true;
}

}  // namespace sm90

// Sets (or, with null, clears) the calling thread's report slot of this
// library's launchers.
// Each library is one translation unit, so the definition is made once.
extern "C" void ms_launch_report(int* out) { sm90::report_slot() = out; }
