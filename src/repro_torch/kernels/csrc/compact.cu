// Stream compaction: ascending ids of set mask entries, -1 padded, plus
// counts — wave-stacked (one mask per shard) and single-mask; and the
// single mask's exclusive prefix sum.
//
// Replaces, in src/repro/kernels/compact.py (the TPU kernels walk
// row-blocks in order and carry the running count in SMEM across the
// "arbitrary" grid axis; XLA finishes compaction with a drop-mode
// scatter):
//   * _scan_batched_kernel / mask_prefix_sum_batched + compact_batched
//     and _scan_kernel / mask_prefix_sum + compact, both ->
//     tile_count_kernel, tile_scan_kernel, tile_write_kernel.
//
// Bound: bytes.  Each shard's N mask bytes are read once and its N int32
// ids (selected or -1) or positions written once, plus the counts.
//
// Design: Hopper blocks run in no fixed order, so the carried axis
// becomes a multi-block scan in three launches on one stream, with a
// shard axis (gridDim.y = S; the single mask is S = 1), so a long mask
// or a wide wave fills the card.  A tile is 4096 rows of one shard: 256
// threads, each owning 16 consecutive mask bytes (one 16-byte load when
// the shard's row is 16-byte aligned).
//   1. tile_count_kernel: each block counts its tile's set rows (__popc of
//      the thread's 16 flags, block reduce) into tile_counts[s][t].
//   2. tile_scan_kernel, one block a shard: the exclusive scan of the
//      shard's tile counts (warp-shuffle scans with a carried total) into
//      tile_offsets[s][t], and the shard's total into count[s].
//   3. tile_write_kernel: each block re-reads its tile, ranks each thread
//      by an exclusive block scan of the per-thread counts, stages in
//      shared memory either every row's exclusive position
//      (mask_prefix_sum) or the set rows' ids in rank order (compact), and
//      writes them out coalesced: the ids to their final slots, then -1 in
//      its own rows at or past the shard's count, so the tiles covering a
//      shard's -1 tail write it.
// Counts are integer adds, so every output is exact and equal to the TPU
// kernels' byte for byte.  The wrapper allocates the 2 * S * tiles
// scratch words.
#include "common.cuh"

namespace {

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

// The shard's mask row, and whether it is 16-byte aligned.
__device__ __forceinline__ const uint8_t* shard_row(const uint8_t* mask,
                                                   long long N,
                                                   bool* aligned) {
  const uint8_t* m = mask + static_cast<long long>(blockIdx.y) * N;
  *aligned = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  return m;
}

// grid (tiles, S): tile_counts[s * tiles + t] = set rows of the tile.
__global__ void tile_count_kernel(const uint8_t* __restrict__ mask,
                                  long long N,
                                  int32_t* __restrict__ tile_counts) {
  __shared__ int scratch[32];
  bool aligned;
  const uint8_t* m = shard_row(mask, N, &aligned);
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const int n = __popc(row_flags(m, base, N, aligned));
  const int total = repro_block_sum(n, scratch);
  if (threadIdx.x == 0)
    tile_counts[static_cast<long long>(blockIdx.y) * gridDim.x +
                blockIdx.x] = total;
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

// One block a shard: the exclusive scan of its `tiles` tile counts.
__global__ void tile_scan_kernel(const int32_t* __restrict__ tile_counts,
                                 int32_t* __restrict__ tile_offsets,
                                 int tiles, int32_t* __restrict__ count) {
  __shared__ int warp_incl[32];
  const long long row = static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tile_counts[row + i] : 0;
    int total;
    const int excl = block_exclusive(v, warp_incl, &total);
    if (i < tiles) tile_offsets[row + i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = carry;
}

// grid (tiles, S): the tile's outputs in the shard's row of `out`.  A
// thread's 16 rows are ranked in registers, then staged in shared memory
// and written out by consecutive threads to consecutive slots (a thread
// writing its own 16 rows would scatter each warp's stores 64 bytes apart).
template <bool IDS>
__global__ void tile_write_kernel(const uint8_t* __restrict__ mask,
                                  long long N,
                                  const int32_t* __restrict__ tile_offsets,
                                  const int32_t* __restrict__ count,
                                  int32_t* __restrict__ out) {
  __shared__ int warp_incl[32];
  // IDS: the tile's ids in rank order; else row r's position at
  // (r / 16) * 17 + r % 16 (one pad word a thread: no bank conflicts)
  __shared__ int stage[kScanThreads * (kItems + 1)];
  bool aligned;
  const uint8_t* m = shard_row(mask, N, &aligned);
  int32_t* o = out + static_cast<long long>(blockIdx.y) * N;
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const long long base = start + threadIdx.x * kItems;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                        N - start));
  const uint32_t f = row_flags(m, base, N, aligned);
  int total;
  int rank = block_exclusive(__popc(f), warp_incl, &total);
  const int offset = tile_offsets[static_cast<long long>(blockIdx.y) *
                                      gridDim.x + blockIdx.x];
  if (IDS) {
    for (int k = 0; k < kItems; ++k)
      if ((f >> k) & 1u) stage[rank++] = static_cast<int32_t>(base + k);
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kScanThreads)
      o[offset + j] = stage[j];
    const long long c = count[blockIdx.y];  // slots past it get -1
    for (int j = threadIdx.x; j < rows; j += kScanThreads)
      if (start + j >= c) o[start + j] = -1;
  } else {
    int pos = offset + rank;
    for (int k = 0; k < kItems; ++k) {
      stage[threadIdx.x * (kItems + 1) + k] = pos;
      pos += (f >> k) & 1u;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += kScanThreads)
      o[start + j] = stage[(j / kItems) * (kItems + 1) + j % kItems];
  }
}

// The three launches over S masks of N rows each.
cudaError_t mask_scan(const void* mask, void* out, void* count,
                      void* scratch, int S, int N, bool ids,
                      cudaStream_t st) {
  const int tiles = (N + kTile - 1) / kTile;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* tile_counts = static_cast<int32_t*>(scratch);
  int32_t* tile_offsets = tile_counts + static_cast<long long>(S) * tiles;
  auto* c = static_cast<int32_t*>(count);
  auto* o = static_cast<int32_t*>(out);
  const dim3 grid(tiles, S);
  tile_count_kernel<<<grid, kScanThreads, 0, st>>>(m, N, tile_counts);
  tile_scan_kernel<<<S, 1024, 0, st>>>(tile_counts, tile_offsets, tiles, c);
  if (ids)
    tile_write_kernel<true><<<grid, kScanThreads, 0, st>>>(
        m, N, tile_offsets, c, o);
  else
    tile_write_kernel<false><<<grid, kScanThreads, 0, st>>>(
        m, N, tile_offsets, c, o);
  return cudaGetLastError();
}

}  // namespace

REPRO_STRERROR

// mask [S, N] bool (one byte each) -> idx [S, N] int32 (ascending ids of
// set rows, -1 padded), counts [S] int32.  scratch holds
// 2 * S * ceil(N / 4096) int32.
REPRO_EXPORT int repro_compact_batched(const void* mask, void* idx,
                                       void* counts, void* scratch, int S,
                                       int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0)
    return static_cast<int>(
        repro_memset(counts, 0, sizeof(int32_t) * S, st));
  return static_cast<int>(mask_scan(mask, idx, counts, scratch, S, N, true,
                                    st));
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
  return static_cast<int>(mask_scan(mask, out, count, scratch, 1, N,
                                    ids != 0, st));
}
