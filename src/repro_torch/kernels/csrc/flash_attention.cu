// Forward flash attention: online-softmax GQA attention with the causal
// mask at a decode offset, a sliding window and tanh soft-capping.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (the TPU kernel runs a (B*Hq, Sq/bq, Skv/bk) grid with
// the KV axis sequential ("arbitrary") and carries the running max m, the
// denominator l and the accumulator acc in VMEM scratch across it).
//
// Bound: operations at the LM's prefill shapes (4*D multiply-adds per
// unmasked (query, key) pair against 2*D bytes a key row; hundreds of
// pairs a key at S = 512), bytes for short or single-token queries.
//
// Design: one block of 256 threads per (b*Hq + h, 64-query tile).  The
// sequential KV grid axis becomes a loop over 64-key tiles inside the
// block, with m, l and acc in registers in float32.  The loop runs only
// over the tiles that the causal mask and the window leave partly open
// (the TPU kernel's `needed` skip, as loop bounds).  Q, K and V tiles are
// converted to float32 in shared memory (Q and K rows padded by one word,
// so the strided row reads hit distinct banks).  A 16x16 thread grid owns
// rows ty + 16i and key columns tx + 16j (i, j < 4) of the 64x64 logit
// tile — a 4x4 register tile — and, for the output, the same rows and
// dims tx + 16k.  Row max and sum reduce over the 16 lanes of a half-warp
// with shuffles.  A masked entry gets p = 0 and no share of the max, so a
// row that is fully masked in one tile adds nothing (the TPU kernel adds
// exp(0) junk there that a later tile's correction wipes out), and a row
// masked everywhere comes out 0, as the TPU kernel's l = 0 guard gives.
// The KV head of query head h is h / (Hq / Hkv), as the TPU index map.
// wgmma, TMA and tensor cores are left for a later redesign.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kMaskedMax = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hq,
                     int Hkv, int Sq, int Skv, int causal, int window,
                     float scale, float softcap) {
  constexpr int DK = D / 16;           // output dims a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int off = Skv - Sq;            // queries sit at the end of the KV
  const T* qb = q + (static_cast<size_t>(bh) * Sq) * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + kvh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + kvh) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = q0 + r < Sq
        ? to_f32(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }

  // the key tiles some row of this query tile can see
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, Sq) - 1 + off;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q_first - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  float m[4], l[4], acc[4][DK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskedMax;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) acc[i][kk] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                   // the last tile's Ks/Vs/Ps are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < Skv;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + off;   // absolute query position
      bool ok[4];
      float mx = kMaskedMax;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[j] = kp < Skv && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        s[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) acc[i][kk] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float vv = Vs[c * D + tx + 16 * kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][kk] = fmaf(pa[i], vv, acc[i][kk]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + (static_cast<size_t>(bh) * Sq + r) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) from_f32(acc[i][kk] * inv, &orow[tx + 16 * kk]);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                         int causal, int window, float scale, float softcap,
                         cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_flash<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, softcap, st);
    case 32:
      return launch_flash<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, softcap, st);
    case 64:
      return launch_flash<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, softcap, st);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                  window, scale, softcap, st);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                  window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_STRERROR

// q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (float32 when bf16 == 0, bfloat16
// otherwise), all contiguous -> o [B, Hq, Sq, D] in the same type.
// window <= 0: no window; softcap <= 0: no soft-capping.
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int Hq,
                                       int Hkv, int Sq, int Skv, int D,
                                       int causal, int window, int bf16,
                                       float scale, float softcap,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                       causal, window, scale, softcap, st)
           : dispatch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                               window, scale, softcap, st);
  return static_cast<int>(err);
}
