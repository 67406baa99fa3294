// Shared device and host code of B11's two Hopper routes:
// flash_attention_sm90.cu (bfloat16 / float16) and flash_attention_f32_sm90.cu
// (float32 as 3xTF32). Both bring q, K and V in by TMA through 3-D tensor
// maps (hd, S, BH) into 128-byte swizzled shared memory, wait on mbarriers,
// and take their products on wgmma with descriptors of those tiles.
//
// - mbarriers: init, arrive with an expected byte count, wait on a phase.
// - tma_load: one box of a 3-D tensor map into shared memory, reported to
//   an mbarrier as bytes.
// - sw128_desc: the wgmma shared-memory descriptor of a tile of 128-byte
//   rows, 128-byte swizzled, 8-row groups 1024 bytes apart.
// - wgmma_fence / wgmma_commit / wgmma_wait and fence_regs, which keeps the
//   compiler from moving register reads or writes across a wgmma in flight.
// - encode_3d: cuTensorMapEncodeTiled, fetched from the driver at first use
//   (no -lcuda), over a contiguous (BH, S, hd) tensor, boxes of one 128-byte
//   row of columns and `rows` rows of one head, zero fill past each edge.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa90 {

constexpr int kRowBytes = 128;               // one swizzle atom row
constexpr float kMasked = -1e30f;            // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

// ms::kSmemRefused of multisplit_common.cuh: set in a launcher's return when
// the card refused the dynamic shared memory it asked for (a
// cudaErrorInvalidValue from cudaFuncSetAttribute; other codes pass unflagged).
constexpr int kSmemRefused = 1 << 16;

inline int smem_refused(cudaError_t err) {
  return err == cudaErrorInvalidValue ? kSmemRefused | static_cast<int>(err)
                                      : static_cast<int>(err);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 3-D tensor map at (column, row, head) into shared memory,
// reported to the mbarrier as bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma operand reads, TMA writes) of the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma

// Shared-memory matrix descriptor of a tile stored as 128-byte rows, 128-byte
// swizzled, 8-row groups 1024 bytes apart: the start address, the leading and
// the stride byte offsets (both 1024 bytes: the stride of 8-row groups, which
// a K-major operand takes from the stride field and an MN-major one of 64
// columns from either) and the 128-byte swizzle mode.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of the registers across a
// wgmma that is in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// the row max and sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---- tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver at first use (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, S, BH) over a contiguous (BH, S, hd) tensor of `elem_bytes`-byte
// elements; boxes of one 128-byte row of columns and `rows` rows of one head,
// 128-byte swizzled, zero fill past each edge
inline bool encode_3d(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                      int elem_bytes, int BH, int S, int hd, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * elem_bytes,
                                 static_cast<cuuint64_t>(S) * hd * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fa90
