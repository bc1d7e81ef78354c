// Diagonal linear recurrence h_t = a_t * h_{t-1} + bx_t over time.
//
// Replaces: src/repro/kernels/ssm_scan.py, _scan_kernel / ssm_scan (the
// TPU kernel solves each time chunk with an associative scan and carries
// the state across the sequential ("arbitrary") chunk axis in VMEM; its
// wrapper pads D to the 128-lane boundary).
//
// Bound: bytes.  Each a and bx element is read once and each h element
// written once (12 bytes a step and channel) against one multiply-add, so
// the card's memory rate sets the time; the Mamba layer hands it
// [B, <=256, dI*N] chunks of 8192*16 channels.
//
// Design: one thread per (batch, channel), walking time in order — the
// sequential chunk axis and the scan inside a chunk become one loop in
// one thread.  The state starts from h0 (or zero), each step's h is
// stored, and the state after the last step is written to hT.  Neighbour
// threads take neighbour channels, so every step's loads and stores are
// coalesced; loads run kUnroll steps ahead of the dependent multiply-adds
// to keep enough bytes in flight.  There is no lane padding: a channel
// count that is not a multiple of 128 only leaves a ragged last block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ a,
                    const float* __restrict__ bx,
                    const float* __restrict__ h0, float* __restrict__ h,
                    float* __restrict__ hT, int B, int L, long long D) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * D) return;
  const long long b = idx / D;
  const long long d = idx - b * D;
  const size_t base = static_cast<size_t>(b) * L * D + d;
  float s = h0 ? h0[idx] : 0.f;
  int t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t g = base + static_cast<size_t>(t + u) * D;
      av[u] = a[g];
      bv[u] = bx[g];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s = av[u] * s + bv[u];
      h[base + static_cast<size_t>(t + u) * D] = s;
    }
  }
  for (; t < L; ++t) {
    const size_t g = base + static_cast<size_t>(t) * D;
    s = a[g] * s + bx[g];
    h[g] = s;
  }
  hT[idx] = s;
}

}  // namespace

REPRO_STRERROR

// a, bx [B, L, D] float32, h0 [B, D] float32 or null (zeros), contiguous
// -> h [B, L, D], hT [B, D] (the state after step L-1; h0 when L == 0).
REPRO_EXPORT int repro_ssm_scan(const void* a, const void* bx, const void* h0,
                                void* h, void* hT, int B, int L, long long D,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * D;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  ssm_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(bx),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(hT), B, L, D);
  return static_cast<int>(cudaGetLastError());
}
