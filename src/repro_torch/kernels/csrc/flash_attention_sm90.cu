// B11, the bfloat16 / float16 route: flash attention, forward only, on the
// Hopper tensor cores (wgmma) with q, K and V brought in by TMA.
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:76)
// for 16-bit inputs; its oracle is
// flash_attention_ref (src/repro/kernels/ref.py:110). float32 inputs take
// flash_attention_f32_sm90.cu; the mbarrier, TMA, descriptor and tensor-map
// helpers both routes share are in flash_attention_sm90.cuh.
//
// q, k, v (BH, S, hd), contiguous, all bfloat16 or all float16, their data
// 16-byte aligned -> o (BH, S, hd) in that dtype:
//   o = softmax(q·kᵀ / sqrt(hd), causal: k_pos <= q_pos) · v
// The Pallas kernel casts q, k and v to float32 and takes both products at
// HIGHEST precision, so p is float32. Here:
// - s = q·kᵀ on wgmma from the unscaled 16-bit tiles with fp32 accumulation.
//   A product of two 16-bit values is exact in fp32, so this is the fp32
//   product up to the order of the sums. The fp32 scores are then scaled by
//   log2(e)/sqrt(hd) (after the product, where the Pallas kernel scales q
//   before it: the two differ by fp32 rounding); masked scores are -1e30.
// - The online softmax runs in the wgmma accumulator layout, in fp32: m_new
//   = max(m, rowmax), p = exp2f(s - m_new), corr = exp2f(m - m_new), l =
//   l·corr + rowsum(p), acc = acc·corr + p·v. exp2f is the accurate one
//   (no --use_fast_math, no fast intrinsic).
// - p·v on wgmma with p split: p_hi = round16(p), p_lo = round16(p - p_hi),
//   both multiplied into the same fp32 accumulator. Rounding p once to 16
//   bits would put the result 10-60 units in the last place off the fp32
//   reference; hi + lo keeps about 16 (bf16) or 22 (fp16) bits of p, well
//   inside one unit. l sums the fp32 p, not the split.
// - o = acc / max(l, 1e-30), rounded once to the dtype.
//
// Design: one block of two consumer warpgroups (256 threads) a (bh, q tile
// of 128 rows), each warpgroup 64 rows, the grid ordered so that the
// longest causal rows (the last q tiles of every head) start first. TMA
// brings the q tile once and K and V in tiles of 64 rows through a ring of
// two shared-memory stages, one mbarrier each; thread 0 refills a stage
// once both warpgroups have finished with it, so the next tile lands while
// this one is computed. The tensor maps are 3-D (hd, S, BH): rows past S
// read as TMA's zero fill, never as the next head's rows. Every tile is
// stored as 64-column chunks of 128-byte rows, 128-byte swizzled (the box
// is 64 columns wide whatever hd is, and columns past hd are zero), so that
// hd = 8, 40, 72, 136 and the like need no padding in device memory. Both
// products are m64n64k16 wgmma: s from q and K in shared memory (both
// K-major, k16 steps up to hd), p·v with p from registers as the A
// operand (the s accumulator repacks into the A fragment in place) and V
// (kv, hd) as the MN-major B operand through the transpose bit, one
// instruction per 64 output columns, per 16 kv rows, for p_hi and p_lo. A
// causal loop stops at the tile that holds the q tile's last row; a
// warpgroup whose rows all lie before a tile skips it; masking runs only on
// the diagonal tile and on the tile that holds row S. hd: any multiple of 8
// up to 256, through templates for 1 to 4 chunks of 64 columns (shared
// memory 48 KB a chunk: two blocks an SM up to hd = 128, one above).
//
// Bound: operations. 4·hd flops a (q, k) pair that the mask keeps
// (BH·S·(S+1)/2 pairs causal, BH·S² not), on the dense bf16 / fp16 tensor
// cores at 989 TFLOP/s (H100 SXM data sheet); the split makes the work
// 6·hd flops a pair. The bytes, q, k and v read once and o written once,
// 8·BH·S·hd over 3.35 TB/s, take about a fifth of that at S = 2048 and hd
// = 64, causal. The exponentials (one exp2f a pair) run on the special
// function units, which this simple kernel does not overlap with the
// products.
#include "flash_attention_sm90.cuh"

namespace {

using namespace fa90;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileQ = 64 * kWarpgroups;     // q rows a block, 64 a warpgroup
constexpr int kTileK = 64;                   // kv rows a tile
constexpr int kAtom = 64;                    // columns of one 128-byte swizzled row
constexpr int kStages = 2;
constexpr uint32_t kQChunk = kTileQ * kRowBytes;     // one 64-column chunk of the q tile
constexpr uint32_t kKVChunk = kTileK * kRowBytes;    // one of a K or V tile

enum Dtype { kBF16 = 1, kF16 = 2 };

#define FA_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_ACC(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
// A and B from shared memory, both K-major; d = a·b (+ d when accumulate)
#define FA_WGMMA_SS(TY)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_D32          \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
               : FA_ACC(d)                                                                 \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
// A from registers, B from shared memory MN-major (transposed); d += a·b
#define FA_WGMMA_RS(TY)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_D32          \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
               : FA_ACC(d)                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <int D>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (D == kBF16) {
    FA_WGMMA_SS("bf16");
  } else {
    FA_WGMMA_SS("f16");
  }
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == kBF16) {
    FA_WGMMA_RS("bf16");
  } else {
    FA_WGMMA_RS("f16");
  }
}

// ---- 16-bit pairs: (lo, hi) -> one register, the lower column in the low half

template <int D>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (D == kBF16) {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  } else {
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  }
  return r;
}

template <int D>
__device__ __forceinline__ void unpack2(uint32_t r, float& lo, float& hi) {
  if constexpr (D == kBF16) {
    lo = __uint_as_float(r << 16);
    hi = __uint_as_float(r & 0xffff0000u);
  } else {
    asm("{\n.reg .b16 a, b;\nmov.b32 {a, b}, %2;\ncvt.f32.f16 %0, a;\ncvt.f32.f16 %1, b;\n}\n"
        : "=f"(lo), "=f"(hi)
        : "r"(r));
  }
}

// Accumulator layout of m64n64 (fp32), thread t of a warpgroup, warp w =
// t / 32, lane l: register 4·c8 + 2·i + j holds row 16w + l/4 + 8i, column
// 8·c8 + 2(l%4) + j. The A fragment of m64nNk16 (16-bit) for k columns
// 16kk..16kk+15 is registers 8kk..8kk+7 of that layout, packed in pairs.
template <int D, int kChunks>
__global__ void __launch_bounds__(kThreads, kChunks <= 2 ? 2 : 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, uint32_t* __restrict__ o, int S,
                      int hd, int BH, int n_qt, int causal, float scale_log2) {
  constexpr uint32_t kStageBytes = 2 * kChunks * kKVChunk;   // K chunks, then V chunks
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];        // K/V stages, then q
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t kv_smem = q_smem + kChunks * kQChunk;
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_bar = bar0 + 8 * kStages;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * kTileQ;
  const int n_kt = (S + kTileK - 1) / kTileK;
  const int kt_end = causal ? min(n_kt, (min(q0 + kTileQ, S) - 1) / kTileK + 1) : n_kt;

  auto load_kv = [&](int kt) {
    const int stage = kt % kStages;
    const uint32_t dst = kv_smem + stage * kStageBytes, bar = bar0 + 8 * stage;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(dst + c * kKVChunk, &tk, bar, c * kAtom, kt * kTileK, bh);
      tma_load(dst + (kChunks + c) * kKVChunk, &tv, bar, c * kAtom, kt * kTileK, bh);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, kChunks * kQChunk);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tma_load(q_smem + c * kQChunk, &tq, q_bar, c * kAtom, q0, bh);
    for (int kt = 0; kt < kStages && kt < kt_end; ++kt) load_kv(kt);
  }

  float acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row = 16 * warp + (lane >> 2);           // this thread's rows: row, row + 8
  const int wg_first = q0 + 64 * wg;                 // the warpgroup's first q position
  const int qp0 = wg_first + row;
  const int col0 = 2 * (lane & 3);
  const int n_ks = (hd + 15) / 16;                   // k16 steps of q·kᵀ
  const uint32_t q_tile = q_smem + wg * 64 * kRowBytes;
  mbar_wait(q_bar, 0);
  __syncwarp();

  for (int kt = 0; kt < kt_end; ++kt) {
    const int stage = kt % kStages;
    const uint32_t k_tile = kv_smem + stage * kStageBytes;
    const uint32_t v_tile = k_tile + kChunks * kKVChunk;
    const int k0 = kt * kTileK;
    mbar_wait(bar0 + 8 * stage, (kt / kStages) & 1);
    __syncwarp();                                    // converged for the .aligned wgmma
    if (!causal || k0 <= wg_first + 63) {            // uniform over the warpgroup
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * kChunks; ++ks) {
        if (ks < n_ks) {
          const uint32_t off = (ks & 3) * 32;      // 16 columns of the chunk's 128-byte rows
          wgmma_ss<D>(s, sw128_desc(q_tile + (ks >> 2) * kQChunk + off),
                      sw128_desc(k_tile + (ks >> 2) * kKVChunk + off), ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      const bool edge = (causal && k0 + kTileK - 1 > wg_first) || k0 + kTileK > S;
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        float t = s[x] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * (x >> 2) + col0 + (x & 1);
          if (kp >= S || (causal && kp > qp0 + 8 * i)) t = kMasked;
        }
        s[x] = t;
        mx[i] = fmaxf(mx[i], t);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        s[x] = exp2f(s[x] - m[i]);
        sum[i] += s[x];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[c][x] *= corr[(x >> 1) & 1];

      // p split into hi + lo, packed as the A fragments of the four k16 steps
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
          float ha, hb;
          p_hi[kk][r] = pack2<D>(a, b);
          unpack2<D>(p_hi[kk][r], ha, hb);
          p_lo[kk][r] = pack2<D>(a - ha, b - hb);
        }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint64_t desc_v = sw128_desc(v_tile + c * kKVChunk + kk * 16 * kRowBytes);
          wgmma_rs<D>(acc[c], p_hi[kk], desc_v);
          wgmma_rs<D>(acc[c], p_lo[kk], desc_v);
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {                 // read by the wgmma until here
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
    }
    __syncthreads();                                 // both warpgroups are done with the stage
    if (tid == 0 && kt + kStages < kt_end) load_kv(kt + kStages);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qp0 + 8 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    uint32_t* og = o + (static_cast<size_t>(bh) * S + qp) * (hd / 2);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int col = c * kAtom + 8 * c8 + col0;
        if (col < hd)
          og[col / 2] = pack2<D>(acc[c][4 * c8 + 2 * i] / denom, acc[c][4 * c8 + 2 * i + 1] / denom);
      }
  }
}

template <int D, int kChunks>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o, int BH,
           int S, int hd, int causal, float scale_log2, cudaStream_t stream) {
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const long long blocks = static_cast<long long>(BH) * n_qt;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kChunks * (kQChunk + kStages * 2 * kKVChunk) + 1024;
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<D, kChunks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_sm90_kernel<D, kChunks><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<uint32_t*>(o), S, hd, BH, n_qt, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                 int BH, int S, int hd, int causal, float scale_log2, cudaStream_t stream) {
  switch ((hd + kAtom - 1) / kAtom) {
    case 1: return launch<D, 1>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, stream);
    case 2: return launch<D, 2>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, stream);
    case 3: return launch<D, 3>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, stream);
    default: return launch<D, 4>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, stream);
  }
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; causal: 0 or 1. hd must be a multiple of 8
// in [8, 256]; q, k, v and o must be 16-byte aligned (TMA's rule; o is
// written in pairs). Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorMisalignedAddress for a pointer that is not 16-byte aligned and
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled or
// refuses a tensor map.
extern "C" int ms_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                       int BH, int S, int hd, int causal, int dtype,
                                       void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (hd < 8 || hd > 256 || hd % 8 != 0 || (dtype != kBF16 && dtype != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fa90::EncodeTiled fn = fa90::encode_tiled();
  const CUtensorMapDataType type =
      dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  if (fn == nullptr || !fa90::encode_3d(fn, &tq, q, type, 2, BH, S, hd, kTileQ) ||
      !fa90::encode_3d(fn, &tk, k, type, 2, BH, S, hd, kTileK) ||
      !fa90::encode_3d(fn, &tv, v, type, 2, BH, S, hd, kTileK))
    return static_cast<int>(cudaErrorNotSupported);
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? launch_width<kBF16>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, st)
                        : launch_width<kF16>(tq, tk, tv, o, BH, S, hd, causal, scale_log2, st);
}
