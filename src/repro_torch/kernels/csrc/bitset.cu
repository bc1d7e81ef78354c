// Bitmap kernels: the wave-stacked AND-reduce with per-shard popcounts,
// the single-shard AND-reduce with its total popcount, and word-wise
// bitmap algebra (and / or / andnot).
//
// Replaces, in src/repro/kernels/bitset.py (TPU Pallas kernels over
// (8, 512)-word VMEM tiles with a SWAR popcount):
//   * _intersect_batched_kernel / bitmap_intersect_batched
//     -> intersect_batched_kernel;
//   * _intersect_kernel / bitmap_intersect -> intersect_kernel;
//   * _binary_kernel / bitset_binary -> binary_kernel.
//
// Bound: bytes, for all three; the work per output word (K-1 ANDs and a
// popcount, or one op) is far below the card's integer rate.
//
// Batched ([S, K, W] -> [S, W] + [S]): each of the S*K*W stack words is
// read once and each of the S*W result words written once.  Design: one
// thread per (shard, word).  Consecutive threads read
// consecutive words of each probe row, so every load is coalesced; the K
// probes are AND-ed in a register.  __popc replaces the SWAR popcount, a
// warp-shuffle + shared-memory block reduce sums the block's bits, and one
// integer atomicAdd per block lands them in the shard's count (integer
// adds commute, so the count is exact).  The counts are zeroed with
// cudaMemsetAsync on the same stream before the launch.
//
// Single shard ([K, W] -> [W] + total): the same per-word design in a
// grid-stride loop over a grid sized to fill the card, so a block reduces
// many words' bits before its one atomicAdd into the total.  Each of the
// K*W words is read once and the W result words written once.
//
// Binary (two [W] -> [W]): each of the 2*W input words is read once and
// the W output words written once.  One thread per 4 words, moved as
// 16-byte vectors when all three buffers are 16-byte aligned (scalar
// loads otherwise and for the ragged tail); the op is a runtime argument
// (0 and, 1 or, 2 andnot), so one program serves all three.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks that fill the card (132 SMs x 8 resident blocks of 256 threads)
constexpr int kFillBlocks = 132 * 8;

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

__global__ void intersect_kernel(const uint32_t* __restrict__ stack,
                                 uint32_t* __restrict__ out,
                                 int32_t* __restrict__ count, int K, int W) {
  __shared__ int scratch[32];
  int bits = 0;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W;
       w += gridDim.x * blockDim.x) {
    uint32_t acc = stack[w];
    for (int k = 1; k < K; ++k) acc &= stack[static_cast<size_t>(k) * W + w];
    out[w] = acc;
    bits += __popc(acc);
  }
  const int total = repro_block_sum(bits, scratch);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

__device__ __forceinline__ uint32_t binary_op(uint32_t a, uint32_t b,
                                              int op) {
  return op == 0 ? (a & b) : (op == 1 ? (a | b) : (a & ~b));
}

template <bool VEC>
__global__ void binary_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, int W, int op) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;   // word quad
  const int w = 4 * q;
  if (w >= W) return;
  if (VEC && w + 4 <= W) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[q];
    const uint4 y = reinterpret_cast<const uint4*>(b)[q];
    uint4 z;
    z.x = binary_op(x.x, y.x, op);
    z.y = binary_op(x.y, y.y, op);
    z.z = binary_op(x.z, y.z, op);
    z.w = binary_op(x.w, y.w, op);
    reinterpret_cast<uint4*>(out)[q] = z;
    return;
  }
  for (int i = w; i < W && i < w + 4; ++i) out[i] = binary_op(a[i], b[i], op);
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

// stack [K, W] uint32 -> out [W] uint32, count [1] int32 (total popcount).
REPRO_EXPORT int repro_bitmap_intersect(const void* stack, void* out,
                                        void* count, int K, int W,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = repro_memset(count, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K > 0 && W > 0) {
    int blocks = (W + kThreads - 1) / kThreads;
    blocks = blocks < kFillBlocks ? blocks : kFillBlocks;
    intersect_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(stack), static_cast<uint32_t*>(out),
        static_cast<int32_t*>(count), K, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, b [W] uint32 -> out [W] uint32; op 0 and, 1 or, 2 andnot (a & ~b).
REPRO_EXPORT int repro_bitset_binary(const void* a, const void* b, void* out,
                                     int W, int op, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W > 0) {
    const int blocks = ((W + 3) / 4 + kThreads - 1) / kThreads;
    const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const auto* pa = static_cast<const uint32_t*>(a);
    const auto* pb = static_cast<const uint32_t*>(b);
    auto* po = static_cast<uint32_t*>(out);
    if (vec)
      binary_kernel<true><<<blocks, kThreads, 0, st>>>(pa, pb, po, W, op);
    else
      binary_kernel<false><<<blocks, kThreads, 0, st>>>(pa, pb, po, W, op);
  }
  return static_cast<int>(cudaGetLastError());
}
