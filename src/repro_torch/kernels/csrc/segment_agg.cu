// Per-group (count, sum, sum of squares) over group ids (-1 = masked).
//
// Replaces: src/repro/kernels/segment_agg.py, _seg_kernel / segment_agg
// (the TPU kernel builds a one-hot [rows, groups] tile and reduces it on
// the MXU, accumulating float32 across the "arbitrary" row-block axis).
//
// Bound: bytes.  Each row's int32 group id is read once, the float32 value
// of a selected row (gid >= 0) once, and the 3*G outputs are written
// once; a masked row's value is never loaded.  The one-hot formulation is
// O(N*G) work; the Q1 traffic query has ~1e4-1e5 offset-coded groups per
// wave, where that is out of the question on any device.
//
// Design: a grid-stride loop over rows; each row with 0 <= gid < G does
// O(1) atomics: an int32 atomicAdd for the count (exact) and double
// atomicAdd (native since sm_60) of the float32 value and its square.
// Accumulating in float64 keeps the float32-staged values' sum within
// float64 rounding of any summation order, so the only difference from a
// float64 reference over the same float32 values is summation order
// (relative ~N * 2^-53).  When the group space is small (G <= 2048, 40 KB),
// same-address global atomics would serialize, so each block accumulates
// into shared-memory partials first and flushes one global atomic per
// group it touched.  Outputs are zeroed with cudaMemsetAsync first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxGroups = 2048;   // 2048 * (8 + 8 + 4) B = 40 KB
constexpr int kGlobalMaxBlocks = 132 * 16;
constexpr int kSharedMaxBlocks = 132 * 2;

__global__ void seg_global_kernel(const int32_t* __restrict__ gid,
                                  const float* __restrict__ val, int N,
                                  int G, int32_t* __restrict__ cnt,
                                  double* __restrict__ sum,
                                  double* __restrict__ ssq) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(N); i += stride) {
    const int g = gid[i];
    if (g < 0 || g >= G) continue;
    const double v = val[i];
    atomicAdd(&cnt[g], 1);
    atomicAdd(&sum[g], v);
    atomicAdd(&ssq[g], v * v);
  }
}

__global__ void seg_shared_kernel(const int32_t* __restrict__ gid,
                                  const float* __restrict__ val, int N,
                                  int G, int32_t* __restrict__ cnt,
                                  double* __restrict__ sum,
                                  double* __restrict__ ssq) {
  extern __shared__ double smem[];
  double* s_sum = smem;
  double* s_ssq = smem + G;
  int* s_cnt = reinterpret_cast<int*>(smem + 2 * G);
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    s_sum[j] = 0.0;
    s_ssq[j] = 0.0;
    s_cnt[j] = 0;
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(N); i += stride) {
    const int g = gid[i];
    if (g < 0 || g >= G) continue;
    const double v = val[i];
    atomicAdd(&s_cnt[g], 1);
    atomicAdd(&s_sum[g], v);
    atomicAdd(&s_ssq[g], v * v);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    if (s_cnt[j]) {
      atomicAdd(&cnt[j], s_cnt[j]);
      atomicAdd(&sum[j], s_sum[j]);
      atomicAdd(&ssq[j], s_ssq[j]);
    }
  }
}

}  // namespace

REPRO_STRERROR

// gid [N] int32, val [N] float32 -> cnt [G] int32, sum/ssq [G] float64.
REPRO_EXPORT int repro_segment_agg(const void* gid, const void* val, int N,
                                   int G, void* cnt, void* sum, void* ssq,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = repro_memset(cnt, 0, sizeof(int32_t) * G, st);
  if (err == cudaSuccess)
    err = repro_memset(sum, 0, sizeof(double) * G, st);
  if (err == cudaSuccess)
    err = repro_memset(ssq, 0, sizeof(double) * G, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0 && G > 0) {
    int blocks = (N + kThreads - 1) / kThreads;
    const auto* g = static_cast<const int32_t*>(gid);
    const auto* v = static_cast<const float*>(val);
    auto* c = static_cast<int32_t*>(cnt);
    auto* s = static_cast<double*>(sum);
    auto* q = static_cast<double*>(ssq);
    if (G <= kSharedMaxGroups) {
      blocks = blocks < kSharedMaxBlocks ? blocks : kSharedMaxBlocks;
      const size_t smem = static_cast<size_t>(G) * (2 * sizeof(double) +
                                                    sizeof(int));
      seg_shared_kernel<<<blocks, kThreads, smem, st>>>(g, v, N, G, c, s, q);
    } else {
      blocks = blocks < kGlobalMaxBlocks ? blocks : kGlobalMaxBlocks;
      seg_global_kernel<<<blocks, kThreads, 0, st>>>(g, v, N, G, c, s, q);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
