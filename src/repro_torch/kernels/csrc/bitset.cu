// Bitmap kernels: the AND-reduce of a stack of bitmaps with per-shard
// popcounts (one shard or a wave of them), and word-wise bitmap algebra
// (and / or / andnot).
//
// Replaces, in src/repro/kernels/bitset.py (TPU Pallas kernels over
// (8, 512)-word VMEM tiles with a SWAR popcount):
//   * _intersect_batched_kernel / bitmap_intersect_batched and
//     _intersect_kernel / bitmap_intersect -> intersect_kernel (the
//     single bitmap stack is one shard);
//   * _binary_kernel / bitset_binary -> binary_kernel.
//
// Bound: bytes, for both; the work per output word (K-1 ANDs and a
// popcount, or one op) is far below the card's integer rate.
//
// Intersect ([S, K, W] -> [S, W] + [S]): each of the S*K*W stack words is
// read once and each of the S*W result words written once.  At the
// engines' shapes the work is tens of nanoseconds, so the cost is the
// device operations a call: this is one launch, with no memset before it.
// Design: a block takes up to kBlockWords words of one shard — 4 a lane,
// one 16-byte load a probe row when every row of the shard is 16-byte
// aligned, else 4 strided scalar loads — and issues the loads of up to
// kProbeBatch probe rows before it ANDs them, so K probes cost one memory
// round trip, not K.  __popc replaces the SWAR popcount and a
// warp-shuffle block reduce gives the block's bits.  A shard that fits
// one block (the engines' waves, W <= 1024) stores its count: no atomic.
// A wider shard takes several such blocks, which close on one 64-bit word
// a shard: each block adds (1 << 32 | its bits) with one atomicAdd, and
// the block that brings the arrivals to the shard's block count holds
// the shard's sum, stores it and resets the word to 0.  The words, zero-filled once when the wrapper allocates
// them, are so 0 at every launch; integer adds make the counts exact and
// the same every call.  (A thread-block cluster a shard, its blocks'
// sums added over distributed shared memory with no atomic, was slower on
// the H100 at every engine shape: tools/select_ab.py.)
//
// Binary (two [W] -> [W]): each of the 2*W input words is read once and
// the W output words written once.  One thread per 4 words, moved as
// 16-byte vectors when all three buffers are 16-byte aligned (scalar
// loads otherwise and for the ragged tail); the op is a runtime argument
// (0 and, 1 or, 2 andnot), so one program serves all three.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLaneWords = 4;        // stack words a lane takes
constexpr int kBlockWords = kThreads * kLaneWords;
constexpr int kProbeBatch = 8;       // probe rows whose loads go together

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// The AND over K probe rows (`row`, W words apart) of words w0 + j *
// step, j < LANE, for those below `end`: the loads of kProbeBatch rows
// are issued before any AND.  Stores the words to `o`, returns their bits.
template <int LANE>
__device__ __forceinline__ int and_words(const uint32_t* __restrict__ row,
                                         uint32_t* __restrict__ o, int K,
                                         int W, int w0, int step, int end) {
  uint32_t acc[LANE];
#pragma unroll
  for (int j = 0; j < LANE; ++j) acc[j] = ~0u;
  for (int k0 = 0; k0 < K; k0 += kProbeBatch) {
    uint32_t v[kProbeBatch][LANE];
#pragma unroll
    for (int kk = 0; kk < kProbeBatch; ++kk)
#pragma unroll
      for (int j = 0; j < LANE; ++j) {
        const int w = w0 + j * step;
        v[kk][j] = k0 + kk < K && w < end
                       ? row[static_cast<size_t>(k0 + kk) * W + w]
                       : ~0u;
      }
#pragma unroll
    for (int kk = 0; kk < kProbeBatch; ++kk)
#pragma unroll
      for (int j = 0; j < LANE; ++j) acc[j] &= v[kk][j];
  }
  int bits = 0;
#pragma unroll
  for (int j = 0; j < LANE; ++j) {
    const int w = w0 + j * step;
    if (w < end) {
      o[w] = acc[j];
      bits += __popc(acc[j]);
    }
  }
  return bits;
}

// grid: S * bps blocks, bps = ceil(W / kBlockWords) a shard.  With bps >
// 1, `arrivals` [S] holds each shard's (blocks arrived << 32 | bits so
// far), 0 at launch and left at 0.
__global__ void __launch_bounds__(kThreads)
intersect_kernel(const uint32_t* __restrict__ stack,
                 uint32_t* __restrict__ out, int32_t* __restrict__ counts,
                 int K, int W, int bps,
                 unsigned long long* __restrict__ arrivals) {
  __shared__ int scratch[32];
  const int s = blockIdx.x / bps;
  const int b = blockIdx.x - s * bps;
  const uint32_t* row = stack + static_cast<size_t>(s) * K * W;
  uint32_t* o = out + static_cast<size_t>(s) * W;
  const int begin = b * kBlockWords;
  const int end = min(W, begin + kBlockWords);
  int bits = 0;
  if ((K == 1 || (W & 3) == 0) &&
      ((reinterpret_cast<uintptr_t>(row) |
        reinterpret_cast<uintptr_t>(o)) & 15) == 0) {
    const int q = (begin >> 2) + threadIdx.x;     // this lane's quad
    const int quads = W >> 2;
    if (q < quads) {
      const uint4* rows = reinterpret_cast<const uint4*>(row);
      const size_t quad_stride = static_cast<size_t>(W) >> 2;
      uint4 acc = make_uint4(~0u, ~0u, ~0u, ~0u);
      for (int k0 = 0; k0 < K; k0 += kProbeBatch) {
        uint4 v[kProbeBatch];
#pragma unroll
        for (int kk = 0; kk < kProbeBatch; ++kk)
          v[kk] = k0 + kk < K ? rows[(k0 + kk) * quad_stride + q]
                              : make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
        for (int kk = 0; kk < kProbeBatch; ++kk) acc = and4(acc, v[kk]);
      }
      reinterpret_cast<uint4*>(o)[q] = acc;
      bits = __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
    }
    // the last block's words past the last whole quad
    const int tail = max(begin, quads << 2) + static_cast<int>(threadIdx.x);
    if (tail < end) bits += and_words<1>(row, o, K, W, tail, kThreads, end);
  } else {
    bits = and_words<kLaneWords>(row, o, K, W, begin + threadIdx.x,
                                 kThreads, end);
  }
  const int total = repro_block_sum(bits, scratch);
  if (threadIdx.x != 0) return;
  if (bps == 1) {
    counts[s] = total;
    return;
  }
  // one atomic both counts the block in and adds its bits; the last
  // block in holds the shard's sum and leaves the word at 0
  const unsigned long long was =
      atomicAdd(&arrivals[s], (1ULL << 32) | static_cast<unsigned>(total));
  if (static_cast<int>(was >> 32) == bps - 1) {
    counts[s] = static_cast<int32_t>(static_cast<unsigned>(was) + total);
    arrivals[s] = 0;
  }
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

// stack [S, K, W] uint32 -> out [S, W] uint32, counts [S] int32 (each
// shard's popcount); S, K >= 1, 1 <= W < 2^26 (the count fits int32).  For
// W > 1024, `state` holds S uint64 words, 0 between calls (zero-filled
// once); it is not touched otherwise.
REPRO_EXPORT int repro_bitmap_intersect(const void* stack, void* out,
                                        void* counts, int S, int K, int W,
                                        void* state, void* stream) {
  if (S < 1 || K < 1 || W < 1 || W >= (1 << 26))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bps = (W + kBlockWords - 1) / kBlockWords;
  const long long grid = static_cast<long long>(S) * bps;
  if ((bps > 1 && state == nullptr) || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  intersect_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(stack), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(counts), K, W, bps,
      static_cast<unsigned long long*>(state));
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
