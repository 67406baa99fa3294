// B11, the float32 route: flash attention, forward only, on the CUDA cores.
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:76)
// for float32 inputs; its oracle is
// flash_attention_ref (src/repro/kernels/ref.py:110). bfloat16 and float16
// inputs take flash_attention_sm90.cu (wgmma and TMA).
//
// q, k, v (BH, S, hd), contiguous float32 -> o (BH, S, hd) float32:
//   o = softmax(q·kᵀ / sqrt(hd), causal: k_pos <= q_pos) · v
// q is scaled by 1/sqrt(hd) (computed in double, applied in float32) before
// the product, as the Pallas kernel scales it. Scores are fp32 FMA on the
// CUDA cores (no TF32: the Pallas kernel's HIGHEST precision); masked scores
// are -1e30; the online softmax runs over kv tiles, m_new = max(m, rowmax),
// p = expf(s - m_new), corr = expf(m - m_new), l = l·corr + rowsum(p), acc =
// acc·corr + p·v, all in fp32; o = acc / max(l, 1e-30).
//
// Design: one block of 128 threads a (bh, q tile of 64 rows); blocks of
// one head run the longest causal rows first. The q tile, scaled, stays in
// shared memory. K and V pass through shared memory in tiles of 64 rows; a
// causal loop stops at the tile that holds the q tile's last row. Thread
// (ty, tx) = (t / 8, t % 8) owns the q rows ty + 16i (i < 4): it computes
// their scores at the kv columns tx + 8j (j < 8) of a tile, a 4x8 register
// tile read from shared memory as float4 along hd; the row max and sum are
// reduced over the row's 8 lanes with shuffles; p goes through shared
// memory, over the K tile once the scores are taken; p·V accumulates into
// the rows' output columns tx·4 + 32c (c < HD / 32), in registers. Shared
// rows of q and K are padded to hd + 4 floats, so the lanes of a warp read
// distinct banks; at hd = 128 a block takes 100 KB of shared memory, so two
// fit on an SM. The 64 x 64 tile is the kernel's own: S need not be a
// multiple of it (q rows past S are not stored, kv rows past S are masked),
// and the JAX door's block_q and block_k, which the wrapper checks, change
// only the order of rounding. hd: any multiple of 8 up to 256, through
// templates for hd up to 64, 128 and 256.
//
// Bound: operations. 4·hd flops a (q, k) pair that the mask keeps
// (BH·S·(S+1)/2 pairs causal, BH·S² not), on the fp32 CUDA cores at 67
// TFLOP/s (H100 SXM data sheet). The bytes, q, k and v read once and o
// written once, 16·BH·S·hd over 3.35 TB/s, take about a thirteenth of that
// at S = 2048 and hd = 64, causal. The tensor cores' float32 route (3xTF32
// products) is the target of a redesign; this kernel does not use them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kRows = 4;                 // q rows a thread owns: ty + 16 i
constexpr int kCols = 8;                 // kv columns a thread scores: tx + 8 j
constexpr int kPStride = kTileK + 4;
constexpr float kMasked = -1e30f;        // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 2));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 1));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int hd, int n_qt,
                 int causal, float scale) {
  constexpr int kChunks = HD / 32;       // float4 output chunks a thread owns
  extern __shared__ float4 smem4[];
  const int ld = hd + 4;
  float* qs = reinterpret_cast<float*>(smem4);    // [kTileQ][ld]
  float* ks = qs + kTileQ * ld;                   // [kTileK][ld]
  float* ps = ks;                                 // [kTileQ][kPStride], over K
  float* vs = ks + max(kTileK * ld, kTileQ * kPStride);   // [kTileK][hd]

  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int q0 = qt * kTileQ;
  const int q_rows = min(kTileQ, S - q0);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const size_t head = static_cast<size_t>(bh) * S * hd;

  const float* qg = q + head + static_cast<size_t>(q0) * hd;
  for (int e = tid; e < kTileQ * hd; e += kThreads) {
    const int r = e / hd;
    qs[r * ld + e - r * hd] = r < q_rows ? qg[e] * scale : 0.f;
  }

  float acc[kRows][kChunks][4];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][c][x] = 0.f;
  }

  const int n_kt = (S + kTileK - 1) / kTileK;
  const int kt_end = causal ? (q0 + q_rows - 1) / kTileK + 1 : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTileK;
    const int k_rows = min(kTileK, S - k0);
    const size_t off = head + static_cast<size_t>(k0) * hd;
    __syncthreads();                     // the last tile's K, V and p are read
    for (int e = tid; e < kTileK * hd; e += kThreads) {
      const int r = e / hd;
      const bool in = r < k_rows;
      ks[r * ld + e - r * hd] = in ? k[off + e] : 0.f;
      vs[e] = in ? v[off + e] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * ld + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    __syncthreads();                     // every score is taken: p may overwrite K

    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        if (kp >= S || (causal && kp > qp)) s[i][j] = kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        ps[(ty + 16 * i) * kPStride + tx + 8 * j] = s[i][j];
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][c][x] *= corr[i];
    // kv rows past S and masked scores carry p = 0 (and V rows past S are 0)
    for (int j = 0; j < kTileK; j += 4) {
      float p[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + j);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * hd;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = tx * 4 + 32 * c;
          if (col < hd) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + col);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              acc[i][c][0] = fmaf(p[i][jj], vv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(p[i][jj], vv.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(p[i][jj], vv.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(p[i][jj], vv.w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* og = o + head + static_cast<size_t>(q0 + r) * hd;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = tx * 4 + 32 * c;
      if (col < hd) {
#pragma unroll
        for (int x = 0; x < 4; ++x) og[col + x] = acc[i][c][x] / denom;
      }
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int BH, int S, int hd,
           int causal, float scale, cudaStream_t stream) {
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const long long blocks = static_cast<long long>(BH) * n_qt;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = kTileK * (hd + 4) > kTileQ * kPStride ? kTileK * (hd + 4) : kTileQ * kPStride;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileQ) * (hd + 4) + kp +
                                       static_cast<size_t>(kTileK) * hd);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, S, hd, n_qt, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 q, k, v and o; causal: 0 or 1. hd must be a multiple of 8 in [8,
// 256]. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ms_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                  int S, int hd, int causal, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (hd < 8 || hd > 256 || hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (hd <= 64) return launch<64>(qf, kf, vf, of, BH, S, hd, causal, scale, st);
  if (hd <= 128) return launch<128>(qf, kf, vf, of, BH, S, hd, causal, scale, st);
  return launch<256>(qf, kf, vf, of, BH, S, hd, causal, scale, st);
}
