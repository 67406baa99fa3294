// Shared device code of the multisplit tile kernels (paper §4.5, §5.5).
//
// One block of kThreads threads runs one tile (the paper's subproblem) of T
// 32-bit keys. Bucket ids are computed in-register from a declarative spec
// (repro_torch/core/identifiers.py): they never exist in device memory.
// Here: the spec's label arguments and ms::bucket_of, the label source of a
// tile (label_at), the block scan that turns the warps' counts into a
// tile's bucket starts, and the label arguments every entry point takes.
// The stable rank itself lives in multisplit_sm90.cuh (sm90::warp_rank,
// sm90::packed_warp_rank).
// Everything is int32, so G[b] + rank is exact for every n < 2^31.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ms {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBuckets = 256;     // one thread per bucket in the scans
constexpr int kLabelBits = 9;        // meta word: rank << kLabelBits | bucket
constexpr unsigned kFull = 0xffffffffu;

enum SpecKind { kDelta = 0, kIdentity = 1, kBitfield = 2, kRange = 3, kEven = 4 };
enum KeyKind { kI32 = 0, kU32 = 1, kF32 = 2 };

// A declarative bucket spec, flattened to scalars by the Python wrapper.
struct Label {
  int kind;
  int key_kind;       // KeyKind of the keys
  int m;              // number of buckets, <= kMaxBuckets
  unsigned u0;        // delta: delta; bitfield: shift
  unsigned u1;        // bitfield: mask
  float f0;           // even: lo (float32)
  float f1;           // even: width (float32)
  const uint32_t* splitters;  // range: sorted splitters as compare-plane words
  int n_split;
  int plane;          // range: KeyKind of the compare plane
};

__device__ __forceinline__ float key_as_float(uint32_t w, int key_kind) {
  if (key_kind == kF32) return __uint_as_float(w);
  if (key_kind == kU32) return __uint2float_rn(w);
  return __int2float_rn(static_cast<int>(w));
}

// splitter s <= key u, in the compare plane (NaN keys compare false).
__device__ __forceinline__ bool splitter_le(uint32_t s, uint32_t u, const Label& L) {
  if (L.plane == kU32) return s <= u;
  if (L.plane == kI32) return static_cast<int>(s) <= static_cast<int>(u);
  return __uint_as_float(s) <= key_as_float(u, L.key_kind);
}

// Bucket id of one key word, as identifiers.py defines it. `sp` holds the
// range splitters in shared memory.
__device__ __forceinline__ int bucket_of(uint32_t w, const Label& L, const uint32_t* sp) {
  int b = 0;
  switch (L.kind) {
    case kDelta: {
      // (uint32)u saturates for float keys (NaN -> 0), as XLA's convert does
      const uint32_t u = L.key_kind == kF32 ? __float2uint_rz(__uint_as_float(w)) : w;
      const uint32_t q = u / L.u0;
      b = q < static_cast<uint32_t>(L.m - 1) ? static_cast<int>(q) : L.m - 1;
      break;
    }
    case kIdentity:
      b = L.key_kind == kF32 ? __float2int_rz(__uint_as_float(w)) : static_cast<int>(w);
      break;
    case kBitfield:
      b = static_cast<int>((w >> L.u0) & L.u1);
      break;
    case kRange: {
      // count of splitters <= key: upper bound in the sorted splitters
      int lo = 0, hi = L.n_split;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (splitter_le(sp[mid], w, L)) lo = mid + 1; else hi = mid;
      }
      b = lo;
      break;
    }
    case kEven: {
      // IEEE float32 subtract and divide (no fast math), clip in float, NaN last
      const float x = floorf(__fdiv_rn(__fsub_rn(key_as_float(w, L.key_kind), L.f0), L.f1));
      b = x != x ? L.m - 1 : static_cast<int>(fminf(fmaxf(x, 0.f), static_cast<float>(L.m - 1)));
      break;
    }
  }
  // identity keys must lie in [0, m); the clamp only keeps a key outside
  // that contract from writing out of bounds
  return min(max(b, 0), L.m - 1);
}

__device__ __forceinline__ void load_splitters(const Label& L, uint32_t* sp) {
  if (L.kind == kRange)
    for (int j = threadIdx.x; j < L.n_split; j += blockDim.x) sp[j] = L.splitters[j];
}

// The label source of a tile: with kIds the labels are read from an int32
// ids plane under the identity label (L = identity over int32 words, so the
// label of an id is min(max(id, 0), m - 1), as bucket_of clamps it), and
// the keys plane only supplies the words to move; else each label is
// computed from its key word. The ids plane takes no shared memory.
template <bool kIds>
__device__ __forceinline__ int label_at(const uint32_t* __restrict__ ids, int i, uint32_t w,
                                        const Label& L, const uint32_t* sp) {
  return bucket_of(kIds ? ids[i] : w, L, sp);
}

// Exclusive scan of one int per thread over the block (kThreads threads).
// Every thread of the block must call it; wsum holds kWarps ints.
__device__ __forceinline__ int block_exclusive_scan(int h, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = h;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  return (warp ? wsum[warp - 1] : 0) + x - h;
}

// Opt a kernel in to the dynamic shared memory it needs above 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline Label make_label(int kind, int key_kind, int m, unsigned u0, unsigned u1, float f0,
                        float f1, const void* splitters, int n_split, int plane) {
  Label L;
  L.kind = kind;
  L.key_kind = key_kind;
  L.m = m;
  L.u0 = u0;
  L.u1 = u1;
  L.f0 = f0;
  L.f1 = f1;
  L.splitters = static_cast<const uint32_t*>(splitters);
  L.n_split = n_split;
  L.plane = plane;
  return L;
}

// The label of an ids plane: identity over int32 words, clamped into [0, m).
inline Label identity_label(int m) {
  return make_label(kIdentity, kI32, m, 0u, 0u, 0.f, 0.f, nullptr, 0, 0);
}

}  // namespace ms

// The label arguments every entry point takes after its own, in this order.
#define MS_LABEL_PARAMS                                                                  \
  int kind, int key_kind, int m, unsigned u0, unsigned u1, float f0, float f1,           \
      const void *splitters, int n_split, int plane
#define MS_LABEL_ARGS kind, key_kind, m, u0, u1, f0, f1, splitters, n_split, plane
