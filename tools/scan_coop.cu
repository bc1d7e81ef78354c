// The mask scan as one cooperative launch: the design that
// src/repro_torch/kernels/csrc/compact.cu's decoupled look-back was
// measured against (tools/select_ab.py builds this file and times both on
// the card).  It is not part of the port.
//
// Each block takes up to kRegTiles tiles (block b: tiles b, b + grid,
// ...), reads each tile's flags once into registers and publishes the
// tile's count; after one grid.sync() it adds the counts of its shard's
// earlier tiles (a block reduce) and writes the tile's ids or positions
// and its share of the -1 tail exactly as the look-back kernel does.  The
// grid is no larger than fits resident, so a shape with more than
// kRegTiles tiles a resident block is refused.
#include <cooperative_groups.h>

#include "compact.cu"

namespace cg = cooperative_groups;

namespace {

constexpr int kRegTiles = 4;

template <bool IDS>
__global__ void __launch_bounds__(kScanThreads)
coop_scan_kernel(const uint8_t* __restrict__ mask, long long N, int tiles,
                 long long all_tiles, int32_t* __restrict__ out,
                 int32_t* __restrict__ count,
                 int32_t* __restrict__ tile_counts) {
  __shared__ int warp_incl[32];
  __shared__ int scratch[32];
  __shared__ int stage[kScanThreads * (kItems + 1)];
  __shared__ int tile_offset;
  uint32_t f[kRegTiles];
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    const long long v = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    f[j] = 0;
    if (v < all_tiles) {
      const long long s = v / tiles;
      const long long t = v - s * tiles;
      const uint8_t* m = mask + s * N;
      const bool aligned = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
      f[j] = row_flags(m, t * kTile + threadIdx.x * kItems, N, aligned);
      const int c = repro_block_sum(__popc(f[j]), scratch);
      if (threadIdx.x == 0) tile_counts[v] = c;
      __syncthreads();                     // scratch is reused next
    }
  }
  cg::this_grid().sync();
#pragma unroll
  for (int j = 0; j < kRegTiles; ++j) {
    const long long v = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    if (v >= all_tiles) break;
    const long long s = v / tiles;
    const long long t = v - s * tiles;
    int32_t* o = out + s * N;
    const long long start = t * kTile;
    const long long row = start + threadIdx.x * kItems;
    const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                          N - start));
    int part = 0;
    for (long long i = threadIdx.x; i < t; i += kScanThreads)
      part += tile_counts[s * tiles + i];
    const int before = repro_block_sum(part, scratch);
    if (threadIdx.x == 0) tile_offset = before;
    int total;
    int rank = block_exclusive(__popc(f[j]), warp_incl, &total);
    const int offset = tile_offset;
    if (threadIdx.x == 0 && t == tiles - 1) count[s] = offset + total;
    if (IDS) {
      for (int k = 0; k < kItems; ++k)
        if ((f[j] >> k) & 1u) stage[rank++] = static_cast<int32_t>(row + k);
    } else {
      int pos = rank;
      for (int k = 0; k < kItems; ++k) {
        stage[threadIdx.x * (kItems + 1) + k] = pos;
        pos += (f[j] >> k) & 1u;
      }
    }
    __syncthreads();
    if (IDS) {
      for (int i = threadIdx.x; i < total; i += kScanThreads)
        o[offset + i] = stage[i];
      const long long unset_before = start - offset;
      const int unset = rows - total;
      int32_t* tail = o + (N - unset_before - unset);
      for (int i = threadIdx.x; i < unset; i += kScanThreads) tail[i] = -1;
    } else {
      for (int i = threadIdx.x; i < rows; i += kScanThreads)
        o[start + i] =
            offset + stage[(i / kItems) * (kItems + 1) + i % kItems];
    }
    __syncthreads();                       // stage is reused next
  }
}

}  // namespace

// mask [S, N] bool -> out [S, N] int32 (ids = 1: ascending ids, -1
// padded; ids = 0: exclusive positions), count [S] int32; tile_counts
// holds S * ceil(N / 4096) int32.
REPRO_EXPORT int ab_coop_scan(const void* mask, void* out, void* count,
                              void* tile_counts, int S, int N, int ids,
                              void* stream) {
  if (S < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + kTile - 1) / kTile;
  long long all_tiles = static_cast<long long>(S) * tiles;
  const void* kernel =
      ids ? reinterpret_cast<const void*>(coop_scan_kernel<true>)
          : reinterpret_cast<const void*>(coop_scan_kernel<false>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kScanThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long grid = all_tiles < resident ? all_tiles : resident;
  if (grid * kRegTiles < all_tiles)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* m = static_cast<const uint8_t*>(mask);
  long long n = N;
  auto* o = static_cast<int32_t*>(out);
  auto* c = static_cast<int32_t*>(count);
  auto* tc = static_cast<int32_t*>(tile_counts);
  int t = tiles;
  void* args[] = {&m, &n, &t, &all_tiles, &o, &c, &tc};
  err = cudaLaunchCooperativeKernel(kernel, static_cast<unsigned>(grid),
                                    kScanThreads, args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
