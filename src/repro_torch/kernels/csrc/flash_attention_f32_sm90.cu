// B11, the float32 route: flash attention, forward only, on the Hopper
// tensor cores as three TF32 products (3xTF32 wgmma), q, K and V brought in
// by TMA. Replaces
// flash_attention_pallas (src/repro/kernels/flash_attention.py:76)
// for float32 inputs; its oracle is
// flash_attention_ref (src/repro/kernels/ref.py:110). bfloat16 and float16
// inputs take flash_attention_sm90.cu; the mbarrier, TMA, descriptor and
// tensor-map helpers both routes share are in flash_attention_sm90.cuh.
//
// q, k, v (BH, S, hd), contiguous float32, their data 16-byte aligned ->
// o (BH, S, hd) float32:
//   o = softmax(q·kᵀ / sqrt(hd), causal: k_pos <= q_pos) · v
// As the Pallas kernel: q is scaled by 1/sqrt(hd) (computed in double,
// applied in float32, never fused into a later operation) before the
// product, masked scores are -1e30, the online softmax runs in fp32 (m_new
// = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new), l = l·corr +
// rowsum(p), acc = acc·corr + p·v) and o = acc / max(l, 1e-30). The
// exponentials are exp2f of the scores times log2(e) (exp2f is the
// accurate one: no --use_fast_math, no fast intrinsic).
//
// The products. The Pallas kernel takes both at HIGHEST precision. A TF32
// product keeps about three decimal digits, so each fp32 operand x is split
// explicitly: hi = x with its low 13 mantissa bits cleared (x & 0xffffe000,
// exactly a TF32 value), lo = x - hi (exact in fp32), and
//   a·b ~ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi,
// three TF32 wgmma products accumulated in fp32; the dropped a_lo·b_lo and
// the TF32 reading of lo are about 2^-21 of |a·b|. Nothing depends on how
// the tensor core treats the low bits of an fp32 word it reads as TF32.
//
// Design: one consumer warpgroup (128 threads) a block, a (bh, q tile of 64
// rows), the grid ordered so that the longest causal rows (the last q tiles
// of every head) start first. One instruction shape serves both products:
// wgmma m64n32k8 .tf32 with A from registers and B from shared memory, both
// of which TF32 wgmma takes K-major only (it has no transpose bit).
// - TMA brings the q tile once and K and V in tiles of 32 rows through 3-D
//   tensor maps (hd, S, BH): rows past S and columns past hd read as zeros.
//   Every tile is stored as 32-column chunks of 128-byte rows (32 fp32, one
//   swizzle atom; a k8 step is 32 bytes of it), 128-byte swizzled.
// - q·kᵀ: q stays as loaded; each k8 step a thread reads its A fragment (4
//   values) from the swizzled tile, scales and splits it in registers. K is
//   split in place (K -> K_hi) with K_lo written over the V tile once V has
//   been consumed; both are K-major B operands as they lie.
// - p·v: V (kv, hd) is MN-major, so the split pass writes it transposed, as
//   Vᵀ_hi and Vᵀ_lo (hd rows of the tile's 32 kv), K-major. p stays in
//   registers: the TF32 A fragment of a k8 step holds columns {c, c + 4}
//   of a row where the fp32 accumulator holds {2c, 2c + 1}, so the k8 step
//   kk takes the accumulator's registers 4kk..4kk+3 as (0, 2, 1, 3) and Vᵀ
//   holds the tile's kv rows of each group of 8 in the order (0, 2, 4, 6,
//   1, 3, 5, 7): the same permutation on both sides of a sum over kv.
// - The tile's steps: wait for K/V; split V into Vᵀ, then K (one barrier
//   between: K_lo lands on V's place); q·kᵀ a 32-column chunk at a time
//   (its q fragments live until that chunk's wgmma group completes); the
//   K/V tile is then free and TMA brings the next one while the softmax
//   and p·v run. A causal loop stops at the tile that holds the q tile's
//   last row; masking runs only on the diagonal tiles and on the tile that
//   holds row S.
// - hd: any multiple of 8 up to 256, through templates for 1 to 8 chunks.
//
// Shared memory a 32-column chunk of hd: the q tile 8 KB, the K tile (then
// K_hi) 4 KB, the V tile (then K_lo) 4 KB, Vᵀ_hi and Vᵀ_lo 4 KB each: 24 KB,
// plus 1 KB to align the swizzle atoms. hd = 64 takes 49 KB (four blocks an
// SM), hd = 80 and 96 73 KB (three), hd = 128 97 KB (two), hd = 256 193 KB
// (one), inside the 227 KB a block may have. A second K/V stage would cost
// 8 KB a chunk and a block an SM at hd = 128; the next tile's TMA overlaps
// the softmax and p·v instead.
//
// Bound: operations. The function needs 4·hd flops a (q, k) pair that the
// mask keeps (BH·S·(S+1)/2 pairs causal, BH·S² not), at 495 TFLOP/s, the
// dense TF32 tensor cores' peak for float32 inputs (H100 SXM data sheet):
// 0.1389 ms at (128, 2048, 64) causal. The three TF32 products do three
// times that work, 12·hd flops a pair (0.4168 ms there), which caps this
// design at a third of the bound. The bytes, q, k and v read once and o
// written once, 16·BH·S·hd over 3.35 TB/s, take 0.0801 ms there. The split,
// the softmax (one exp2f a pair) and the fragment loads run on the CUDA
// cores between the products; this simple kernel does not overlap them.
#include "flash_attention_sm90.cuh"

namespace {

using namespace fa90;

constexpr int kThreads = 128;                         // one warpgroup
constexpr int kTileQ = 64;                            // q rows a block
constexpr int kTileK = 32;                            // kv rows a tile
constexpr int kAtom = 32;                             // fp32 columns of one 128-byte row
constexpr int kMaxChunks = 8;                         // hd <= 256
constexpr uint32_t kQChunk = kTileQ * kRowBytes;      // one 32-column chunk of the q tile
constexpr uint32_t kKVChunk = kTileK * kRowBytes;     // one of a K, V or Vᵀ tile
constexpr uint32_t kChunkBytes = kQChunk + 4 * kKVChunk;
constexpr uint32_t kTf32Mask = 0xffffe000u;           // sign, exponent, 10 mantissa bits
constexpr float kLog2e = 1.4426950408889634f;

// hi = x with its low 13 mantissa bits cleared (a TF32 value), lo = x - hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & kTf32Mask;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// byte offset of column j (< 32) of row r in a 128-byte swizzled tile
__device__ __forceinline__ uint32_t sw128_offset(int r, int j) {
  return r * kRowBytes + ((((j >> 2) ^ (r & 7)) & 7) << 4) + ((j & 3) << 2);
}

// d (+)= a·b, m64n32k8 TF32: A from registers (4 per thread), B from shared
// memory, K-major; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Accumulator layout of m64n32 (fp32), thread t of the warpgroup, warp w =
// t / 32, lane l: register 4·c8 + 2·i + j holds row 16w + l/4 + 8i, column
// 8·c8 + 2(l%4) + j. The A fragment of m64nNk8 (tf32): register 2·h + i
// holds row 16w + l/4 + 8i, column (l%4) + 4h of the k8 step.
template <int kChunks>
__global__ void __launch_bounds__(kThreads, 1)
    flash_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int S,
                          int hd, int BH, int n_qt, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];           // q, then the K/V tile
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023u) & ~1023u;     // swizzle atoms: 1024 B
  const uint32_t k_smem = q_smem + kChunks * kQChunk;   // K, then K_hi
  const uint32_t v_smem = k_smem + kChunks * kKVChunk;  // V, then K_lo
  const uint32_t vth_smem = v_smem + kChunks * kKVChunk;
  const uint32_t vtl_smem = vth_smem + kChunks * kKVChunk;
  uint8_t* const base = smem_raw + (q_smem - raw);      // the same bytes, for loads and stores
  const uint32_t q_bar = smem_u32(bars), kv_bar = q_bar + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * kTileQ;
  const int n_kt = (S + kTileK - 1) / kTileK;
  const int kt_end = causal ? min(n_kt, (min(q0 + kTileQ, S) - 1) / kTileK + 1) : n_kt;

  auto load_kv = [&](int kt) {
    mbar_expect_tx(kv_bar, 2 * kChunks * kKVChunk);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(k_smem + c * kKVChunk, &tk, kv_bar, c * kAtom, kt * kTileK, bh);
      tma_load(v_smem + c * kKVChunk, &tv, kv_bar, c * kAtom, kt * kTileK, bh);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar, 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, kChunks * kQChunk);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) tma_load(q_smem + c * kQChunk, &tq, q_bar, c * kAtom, q0, bh);
    load_kv(0);
  }

  float acc[kChunks][16];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[c][x] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, t4 = lane & 3;
  const int row = 16 * warp + g;                      // this thread's rows: row, row + 8
  const int qp0 = q0 + row;
  const int n_ks = hd / 8;                            // k8 steps of q·kᵀ
  mbar_wait(q_bar, 0);
  __syncwarp();

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTileK;
    mbar_wait(kv_bar, kt & 1);

    // V (kv row r, columns 4u..4u+3 of chunk c) -> Vᵀ_hi / Vᵀ_lo rows 32c +
    // 4u + e, column 8(r / 8) + the place of r % 8 in (0, 2, 4, 6, 1, 3, 5, 7)
    for (int idx = tid; idx < kChunks * 256; idx += kThreads) {
      const int r = idx & 31, u = (idx >> 5) & 7, c = idx >> 8;
      const float4 x = *reinterpret_cast<const float4*>(
          base + (v_smem - q_smem) + c * kKVChunk + sw128_offset(r, 4 * u));
      const int col = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 32 * c + 4 * u + e;
        uint32_t hi, lo;
        split_tf32(xs[e], hi, lo);
        const uint32_t off = (n >> 5) * kKVChunk + sw128_offset(n & 31, col);
        *reinterpret_cast<uint32_t*>(base + (vth_smem - q_smem) + off) = hi;
        *reinterpret_cast<uint32_t*>(base + (vtl_smem - q_smem) + off) = lo;
      }
    }
    __syncthreads();                                  // V is consumed: K_lo may land on it
    for (int idx = tid; idx < kChunks * 256; idx += kThreads) {
      float4* kp = reinterpret_cast<float4*>(base + (k_smem - q_smem) + 16 * idx);
      uint4* lp = reinterpret_cast<uint4*>(base + (v_smem - q_smem) + 16 * idx);
      const float4 x = *kp;
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(kp) = hi;
      *lp = lo;
    }
    fence_proxy_async();                              // the split tiles, before wgmma reads them
    __syncthreads();

    // s = q_hi·K_loᵀ + q_lo·K_hiᵀ + q_hi·K_hiᵀ, one 32-column chunk of hd at a time
    float s[16];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (4 * c < n_ks) {                             // uniform over the block
        uint32_t qh[4][4], ql[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float x = *reinterpret_cast<const float*>(
                  base + c * kQChunk + sw128_offset(row + 8 * i, 8 * kk + t4 + 4 * h));
              split_tf32(__fmul_rn(x, scale), qh[kk][2 * h + i], ql[kk][2 * h + i]);
            }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * c + kk < n_ks) {
            const uint64_t dh = sw128_desc(k_smem + c * kKVChunk + 32 * kk);
            const uint64_t dl = sw128_desc(v_smem + c * kKVChunk + 32 * kk);
            wgmma_tf32(s, qh[kk], dl, c > 0 || kk > 0);
            wgmma_tf32(s, ql[kk], dh, 1);
            wgmma_tf32(s, qh[kk], dh, 1);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {              // read by the wgmma until here
          fence_regs(qh[kk]);
          fence_regs(ql[kk]);
        }
      }
    }
    __syncthreads();                                  // every warp is done with K_hi and K_lo
    if (tid == 0 && kt + 1 < kt_end) load_kv(kt + 1);

    const bool edge = (causal && k0 + kTileK - 1 > q0) || k0 + kTileK > S;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = (x >> 1) & 1;
      float v = s[x] * kLog2e;
      if (edge) {
        const int kp = k0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
        if (kp >= S || (causal && kp > qp0 + 8 * i)) v = kMasked;
      }
      s[x] = v;
      mx[i] = fmaxf(mx[i], v);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int i = (x >> 1) & 1;
      s[x] = exp2f(s[x] - m[i]);
      sum[i] += s[x];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc[c][x] *= corr[(x >> 1) & 1];

    // p split into hi + lo as the A fragments of the four k8 steps: step kk
    // takes accumulator registers 4kk + (0, 2, 1, 3)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(s[4 * kk + ((r & 1) << 1) + (r >> 1)], ph[kk][r], pl[kk][r]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t dh = sw128_desc(vth_smem + c * kKVChunk + 32 * kk);
        const uint64_t dl = sw128_desc(vtl_smem + c * kKVChunk + 32 * kk);
        wgmma_tf32(acc[c], ph[kk], dl, 1);
        wgmma_tf32(acc[c], pl[kk], dh, 1);
        wgmma_tf32(acc[c], ph[kk], dh, 1);
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                  // read by the wgmma until here
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    __syncthreads();                                  // every warp is done with Vᵀ
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qp0 + 8 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* og = o + (static_cast<size_t>(bh) * S + qp) * hd;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int c8 = 0; c8 < 4; ++c8) {
        const int col = c * kAtom + 8 * c8 + 2 * t4;
        if (col < hd)
          *reinterpret_cast<float2*>(og + col) =
              make_float2(acc[c][4 * c8 + 2 * i] / denom, acc[c][4 * c8 + 2 * i + 1] / denom);
      }
  }
}

template <int kChunks>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, float* o, int BH,
           int S, int hd, int causal, float scale, cudaStream_t stream) {
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const long long blocks = static_cast<long long>(BH) * n_qt;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kChunks * kChunkBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_sm90_kernel<kChunks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_f32_sm90_kernel<kChunks><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, o, S, hd, BH, n_qt, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// causal: 0 or 1. hd must be a multiple of 8 in [8, 256]; q, k, v and o
// must be 16-byte aligned (TMA's rule; o is written in pairs). Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for arguments the kernel does not take, cudaErrorMisalignedAddress for a
// pointer that is not 16-byte aligned and cudaErrorNotSupported when the
// driver has no cuTensorMapEncodeTiled or refuses a tensor map.
extern "C" int ms_flash_attention_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                           int BH, int S, int hd, int causal, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (hd < 8 || hd > kAtom * kMaxChunks || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const fa90::EncodeTiled fn = fa90::encode_tiled();
  const CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (fn == nullptr || !fa90::encode_3d(fn, &tq, q, type, 4, BH, S, hd, kTileQ) ||
      !fa90::encode_3d(fn, &tk, k, type, 4, BH, S, hd, kTileK) ||
      !fa90::encode_3d(fn, &tv, v, type, 4, BH, S, hd, kTileK))
    return static_cast<int>(cudaErrorNotSupported);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  switch ((hd + kAtom - 1) / kAtom) {
    case 1: return launch<1>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 2: return launch<2>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 3: return launch<3>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 4: return launch<4>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 5: return launch<5>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 6: return launch<6>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    case 7: return launch<7>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
    default: return launch<8>(tq, tk, tv, out, BH, S, hd, causal, scale, st);
  }
}
