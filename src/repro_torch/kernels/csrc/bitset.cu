// Wave-stacked bitmap AND-reduce with per-shard popcounts.
//
// Replaces: src/repro/kernels/bitset.py, _intersect_batched_kernel /
// bitmap_intersect_batched (the TPU Pallas kernel over (8, 512)-word VMEM
// tiles with a SWAR popcount).
//
// Bound: bytes.  Each of the S*K*W stack words is read once and each of the
// S*W result words written once; the work is K-1 ANDs and one popcount per
// output word, far below the card's integer rate.
//
// Design: one thread per (shard, word).  Consecutive threads read
// consecutive words of each probe row, so every load is coalesced; the K
// probes are AND-ed in a register.  __popc replaces the SWAR popcount, a
// warp-shuffle + shared-memory block reduce sums the block's bits, and one
// integer atomicAdd per block lands them in the shard's count (integer
// adds commute, so the count is exact).  The counts are zeroed with
// cudaMemsetAsync on the same stream before the launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void intersect_batched_kernel(const uint32_t* __restrict__ stack,
                                         uint32_t* __restrict__ out,
                                         int32_t* __restrict__ counts,
                                         int K, int W) {
  __shared__ int scratch[32];
  const int s = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  int bits = 0;
  if (w < W) {
    const uint32_t* base = stack + static_cast<size_t>(s) * K * W + w;
    uint32_t acc = 0xFFFFFFFFu;            // AND identity (K == 0)
    for (int k = 0; k < K; ++k) acc &= base[static_cast<size_t>(k) * W];
    out[static_cast<size_t>(s) * W + w] = acc;
    bits = __popc(acc);
  }
  const int total = repro_block_sum(bits, scratch);
  if (threadIdx.x == 0 && total) atomicAdd(&counts[s], total);
}

}  // namespace

REPRO_STRERROR

// stack [S, K, W] uint32 -> out [S, W] uint32, counts [S] int32.
REPRO_EXPORT int repro_bitmap_intersect_batched(const void* stack, void* out,
                                                void* counts, int S, int K,
                                                int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = repro_memset(counts, 0, sizeof(int32_t) * S, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 0 && W > 0) {
    dim3 grid((W + kThreads - 1) / kThreads, S);
    intersect_batched_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(stack), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(counts), K, W);
  }
  return static_cast<int>(cudaGetLastError());
}
