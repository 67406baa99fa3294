// The labels of a declarative spec, written out: keys (L, T) 32-bit words
// -> ids (L, T) int32, each through bucket_of (multisplit_common.cuh), the
// label function K1-K3 evaluate in-register, so the ids are bitwise those
// labels: the same IEEE float32 operations, no fast math, the same clamp.
//
// Replaces spec_bucket_ids_pallas (src/repro/kernels/multisplit_tile.py:421),
// which backs the even_bucket_ids door.
//
// A plain elementwise pass: a grid-stride loop over the L·T words, the
// RangeSpec splitters loaded once a block into shared memory. The grid is
// capped so that a block loads its splitters for many keys.
//
// Bound: memory. It reads 4 bytes a key and writes 4 bytes a label:
// 8·L·T bytes / 3.35 TB/s on an H100 SXM.
#include "multisplit_common.cuh"

namespace {

constexpr size_t kMaxBlocks = 132 * 16;              // 16 blocks on each of 132 SMs

__global__ void __launch_bounds__(ms::kThreads)
    spec_bucket_ids_kernel(const uint32_t* __restrict__ keys, int* __restrict__ ids, size_t n,
                           ms::Label L) {
  __shared__ uint32_t sp[ms::kMaxBuckets];
  ms::load_splitters(L, sp);
  __syncthreads();
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride)
    ids[i] = ms::bucket_of(keys[i], L, sp);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ms_spec_bucket_ids(const void* keys, void* ids, int n_tiles, int T,
                                  MS_LABEL_PARAMS, void* stream) {
  const size_t n = static_cast<size_t>(n_tiles) * T;
  if (n == 0) return 0;
  const ms::Label L = ms::make_label(MS_LABEL_ARGS);
  const size_t want = (n + ms::kThreads - 1) / ms::kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  spec_bucket_ids_kernel<<<blocks, ms::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int*>(ids), n, L);
  return static_cast<int>(cudaGetLastError());
}
