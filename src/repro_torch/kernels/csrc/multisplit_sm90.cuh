// Shared code of the Hopper designs of K1 (tile_histograms.cu) and K2
// (fused_postscan_reorder.cu): labels in a few cheap forms beside the
// general one, the rows' alignment, and the persistent grid from the
// occupancy the kernel gets.
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

}  // namespace sm90
