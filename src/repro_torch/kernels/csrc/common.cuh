// Shared helpers for the port's hand-written Hopper kernels.
//
// Every library exports plain C entry points (loaded with ctypes by
// kernels/_build.py).  Pointers arrive as void*, the stream as the
// cudaStream_t PyTorch launches on.  Entry points allocate nothing, never
// synchronise, and return cudaGetLastError() after their launches.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

#define REPRO_STRERROR                                              \
  REPRO_EXPORT const char* repro_strerror(int err) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(err));       \
  }

// cudaMemsetAsync that skips empty buffers (an empty tensor's pointer may
// be null).
inline cudaError_t repro_memset(void* ptr, int value, size_t bytes,
                                cudaStream_t st) {
  return bytes ? cudaMemsetAsync(ptr, value, bytes, st) : cudaSuccess;
}

// A (hi, lo) pair of uint32 words as one uint64 — exact 64-bit
// lexicographic order, the compare the TPU kernels spell out word by word.
__device__ __forceinline__ unsigned long long repro_u64(uint32_t hi,
                                                        uint32_t lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Sum of `v` over the block (blockDim.x a multiple of 32, at most 1024);
// the result is valid in thread 0.  `scratch` holds 32 ints.
__device__ __forceinline__ int repro_block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  v = 0;
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? scratch[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}
