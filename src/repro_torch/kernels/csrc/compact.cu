// Stream compaction: ascending ids of set mask entries, -1 padded, plus
// counts — wave-stacked (one mask per shard) and single-mask; and the
// single mask's exclusive prefix sum.
//
// Replaces, in src/repro/kernels/compact.py (the TPU kernels walk
// row-blocks in order and carry the running count in SMEM across the
// "arbitrary" grid axis; XLA finishes compaction with a drop-mode
// scatter):
//   * _scan_batched_kernel / mask_prefix_sum_batched + compact_batched
//     -> compact_batched_kernel;
//   * _scan_kernel / mask_prefix_sum + compact -> tile_count_kernel,
//     tile_scan_kernel, tile_write_kernel.
//
// Bound: bytes.  Batched: each shard's N mask bytes are read once and its
// N int32 ids (selected or -1) written once.  Single mask: N bytes read,
// N int32 positions (prefix sum) or ids written, plus the count.
//
// Batched design: Hopper blocks run in no fixed order, so the carried axis becomes
// a loop inside one block: one block per shard walks its mask in tiles of
// blockDim elements and keeps the running count in a register (every
// thread derives the same value).  Inside a tile, __ballot_sync + __popc
// give each set element its rank among the set lanes before it in its warp;
// the warp totals go through shared memory and warp 0 scans them, giving
// each warp its offset.  Each set element then writes its row id straight
// to its final slot (no separate scatter), and after the last tile the
// block writes -1 into [count, N).  The output is the ascending id list the
// TPU kernel produces, byte for byte.  One block per shard leaves most SMs
// idle at small waves; a decoupled look-back scan over many blocks per
// shard is the known way to fill the card.
//
// Single-mask design: a multi-block scan in three launches on one stream,
// so a long mask fills the card.  A tile is 4096 rows: 256 threads, each
// owning 16 consecutive mask bytes (one 16-byte load when aligned).
//   1. tile_count_kernel: each block counts its tile's set rows (__popc of
//      the thread's 16 flags, block reduce) into tile_counts[b].
//   2. tile_scan_kernel, one block: the exclusive scan of the tile counts
//      (warp-shuffle scans with a carried total) into tile_offsets, and
//      the total into count.
//   3. tile_write_kernel: each block re-reads its tile, ranks each thread
//      by an exclusive block scan of the per-thread counts, and writes
//      either every row's exclusive position (mask_prefix_sum) or each set
//      row's id at its final slot, with -1 in slots >= count (compact).
// Counts are integer adds, so both outputs are exact and equal to the TPU
// kernel's byte for byte.  The wrapper allocates the 2 * tiles scratch
// words.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void compact_batched_kernel(const uint8_t* __restrict__ mask,
                                       int32_t* __restrict__ idx,
                                       int32_t* __restrict__ counts, int N) {
  __shared__ int warp_incl[32];
  const int s = blockIdx.x;
  const uint8_t* m = mask + static_cast<size_t>(s) * N;
  int32_t* out = idx + static_cast<size_t>(s) * N;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool set = i < N && m[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, set);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_incl[wid] = __popc(ballot);
    __syncthreads();
    if (wid == 0) {
      int v = lane < nw ? warp_incl[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      warp_incl[lane] = v;                 // inclusive warp-total scan
    }
    __syncthreads();
    if (set) out[carry + (wid ? warp_incl[wid - 1] : 0) + rank] = i;
    carry += warp_incl[nw - 1];
    __syncthreads();                       // warp_incl is reused next tile
  }
  for (int i = carry + threadIdx.x; i < N; i += blockDim.x) out[i] = -1;
  if (threadIdx.x == 0) counts[s] = carry;
}

constexpr int kScanThreads = 256;
constexpr int kItems = 16;                      // mask bytes per thread
constexpr int kTile = kScanThreads * kItems;    // mask rows per block

// Flags (bit k = row base + k is set) of the 16 rows from `base`.
__device__ __forceinline__ uint32_t row_flags(const uint8_t* __restrict__ m,
                                              long long base, long long N,
                                              bool aligned) {
  uint32_t f = 0;
  if (aligned && base + kItems <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(m + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[j] >> (8 * b)) & 0xFFu) f |= 1u << (4 * j + b);
    return f;
  }
  for (int k = 0; k < kItems; ++k)
    if (base + k < N && m[base + k]) f |= 1u << k;
  return f;
}

__global__ void tile_count_kernel(const uint8_t* __restrict__ mask,
                                  long long N, bool aligned,
                                  int32_t* __restrict__ tile_counts) {
  __shared__ int scratch[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const int n = __popc(row_flags(mask, base, N, aligned));
  const int total = repro_block_sum(n, scratch);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// Inclusive scan of v over the warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  `warp_incl` holds 32 ints.
__device__ __forceinline__ int block_exclusive(int v, int* warp_incl,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_scan(v, lane);
  if (lane == 31) warp_incl[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int w = warp_scan(lane < nw ? warp_incl[lane] : 0, lane);
    warp_incl[lane] = w;
  }
  __syncthreads();
  const int excl = incl - v + (wid ? warp_incl[wid - 1] : 0);
  *total = warp_incl[nw - 1];
  __syncthreads();                           // warp_incl is reused next
  return excl;
}

__global__ void tile_scan_kernel(const int32_t* __restrict__ tile_counts,
                                 int32_t* __restrict__ tile_offsets,
                                 int tiles, int32_t* __restrict__ count) {
  __shared__ int warp_incl[32];
  int carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tile_counts[i] : 0;
    int total;
    const int excl = block_exclusive(v, warp_incl, &total);
    if (i < tiles) tile_offsets[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry;
}

template <bool IDS>
__global__ void tile_write_kernel(const uint8_t* __restrict__ mask,
                                  long long N, bool aligned,
                                  const int32_t* __restrict__ tile_offsets,
                                  const int32_t* __restrict__ count,
                                  int32_t* __restrict__ out) {
  __shared__ int warp_incl[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const uint32_t f = row_flags(mask, base, N, aligned);
  int total;
  int pos = tile_offsets[blockIdx.x] +
            block_exclusive(__popc(f), warp_incl, &total);
  if (IDS) {
    const long long c = *count;
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k;
      if (i >= N) break;
      if ((f >> k) & 1u) out[pos++] = static_cast<int32_t>(i);
      if (i >= c) out[i] = -1;               // slots past the count
    }
  } else {
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + k;
      if (i >= N) break;
      out[i] = pos;
      pos += (f >> k) & 1u;
    }
  }
}

}  // namespace

REPRO_STRERROR

// mask [S, N] bool (one byte each) -> idx [S, N] int32, counts [S] int32.
REPRO_EXPORT int repro_compact_batched(const void* mask, void* idx,
                                       void* counts, int S, int N,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > 0) {
    compact_batched_kernel<<<S, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(mask), static_cast<int32_t*>(idx),
        static_cast<int32_t*>(counts), N);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask [N] bool (one byte each) -> out [N] int32: with ids = 0 the
// exclusive prefix sum, with ids = 1 the ascending ids of set rows, -1
// padded; count [1] int32.  scratch holds 2 * ceil(N / 4096) int32.
REPRO_EXPORT int repro_mask_scan(const void* mask, void* out, void* count,
                                 void* scratch, int N, int ids,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0)
    return static_cast<int>(repro_memset(count, 0, sizeof(int32_t), st));
  const int tiles = (N + kTile - 1) / kTile;
  const auto* m = static_cast<const uint8_t*>(mask);
  const bool aligned = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  auto* tile_counts = static_cast<int32_t*>(scratch);
  int32_t* tile_offsets = tile_counts + tiles;
  auto* c = static_cast<int32_t*>(count);
  auto* o = static_cast<int32_t*>(out);
  tile_count_kernel<<<tiles, kScanThreads, 0, st>>>(m, N, aligned,
                                                     tile_counts);
  tile_scan_kernel<<<1, 1024, 0, st>>>(tile_counts, tile_offsets, tiles, c);
  if (ids)
    tile_write_kernel<true><<<tiles, kScanThreads, 0, st>>>(
        m, N, aligned, tile_offsets, c, o);
  else
    tile_write_kernel<false><<<tiles, kScanThreads, 0, st>>>(
        m, N, aligned, tile_offsets, c, o);
  return static_cast<int>(cudaGetLastError());
}
