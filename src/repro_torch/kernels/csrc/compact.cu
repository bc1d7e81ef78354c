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
//     mask_scan_kernel (the single mask is one shard).
//
// Bound: bytes.  Each shard's N mask bytes are read once and its N int32
// ids (selected or -1) or positions written once, plus the counts.  At
// the engines' shapes that is tens of nanoseconds, so the cost is the
// device operations a call: this is one launch.
//
// Design: a single-pass scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).  Hopper blocks run in no fixed order, so the TPU's carried count
// becomes a chain of published tile counts.  A tile is 4096 rows of one
// shard: 256 threads, each reading its 16 mask bytes once (one 16-byte
// load when the shard's row is 16-byte aligned).  A block takes its
// (shard, tile) from an atomic ticket, so every tile before it in its
// shard is already running or done and the look-back never waits on a
// block that is not resident.  The block ranks its threads by an
// exclusive block scan, publishes its tile's count (an aggregate), and
// its warp 0 walks back over the shard's earlier tiles, 32 at a time,
// adding aggregates until it meets an inclusive prefix; it then publishes
// its own inclusive prefix.  Meanwhile the other warps stage the tile's
// ids (in rank order) or positions in shared memory; then all write them
// out coalesced.  Compaction's -1 tail needs no total: tile t knows the
// unset rows before it, U = start - offset, and its own, u, and writes -1
// to slots [N - U - u, N - U), which over all tiles are exactly
// [count, N).  The shard's last tile stores its count.
//
// State: `state` is a buffer the wrapper owns per (device, stream) and
// only this kernel writes: word 0 the ticket (a 64-bit counter never
// reset; the wrapper passes the value it reached, `base`), then one
// status word a tile, epoch << 32 | prefix flag << 31 | count.  A word of
// an earlier call carries another epoch and reads as not ready, so
// nothing is zeroed between calls; the wrapper zero-fills the buffer once,
// at allocation and when the 32-bit epoch wraps.  Counts are integer adds,
// so every output is exact and equal to the TPU kernels' byte for byte.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kItems = 16;                      // mask bytes per thread
constexpr int kTile = kScanThreads * kItems;    // mask rows per block
constexpr unsigned long long kPrefix = 1ULL << 31;
constexpr unsigned long long kCount = kPrefix - 1;

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

// Status words: loads and stores the whole card sees, never cached in L1.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(__cvta_generic_to_global(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
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

// Warp 0 of tile t (t >= 1) of a shard whose status words start at
// `status`: publish the tile's count, walk back to the nearest inclusive
// prefix, publish the tile's own; returns the set rows before the tile
// (valid in every lane).
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         long long t, int total,
                                         unsigned long long tag) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) store_status(status + t, tag | total);
  int offset = 0;
  for (long long j = t - 1;; j -= 32) {
    const long long i = j - lane;
    unsigned long long w = tag | kPrefix;   // before tile 0: a prefix of 0
    if (i >= 0) {
      do {
        w = load_status(status + i);
      } while ((w >> 32) != (tag >> 32));
    }
    // the lowest lane holding a prefix is the nearest one
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, (w & kPrefix) != 0);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    int v = lane <= stop ? static_cast<int>(w & kCount) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    offset += v;
    if (prefixes) break;
  }
  if (lane == 0) store_status(status + t, tag | kPrefix | (offset + total));
  return offset;
}

// grid: S * tiles blocks, one a tile, in ticket order.  The tile's outputs
// go to its shard's row of `out`: IDS the ascending ids of set rows, -1
// padded, else every row's exclusive position.  A thread's 16 rows are
// ranked in registers, then staged in shared memory and written out by
// consecutive threads to consecutive slots (a thread writing its own 16
// rows would scatter each warp's stores 64 bytes apart).  Eight blocks
// an SM (32 registers a thread) keep more tiles writing while others wait
// in the look-back.
template <bool IDS>
__global__ void __launch_bounds__(kScanThreads, 8)
mask_scan_kernel(const uint8_t* __restrict__ mask, long long N, int tiles,
                 int32_t* __restrict__ out, int32_t* __restrict__ count,
                 unsigned long long* __restrict__ state,
                 unsigned long long base, unsigned long long epoch) {
  __shared__ int warp_incl[32];
  // IDS: the tile's ids in rank order; else row r's position at
  // (r / 16) * 17 + r % 16 (one pad word a thread: no bank conflicts)
  __shared__ int stage[kScanThreads * (kItems + 1)];
  __shared__ long long ticket;
  __shared__ int tile_offset;
  if (threadIdx.x == 0)
    ticket = static_cast<long long>(atomicAdd(state, 1ULL) - base);
  __syncthreads();
  const long long s = ticket / tiles;
  const long long t = ticket - s * tiles;
  const uint8_t* m = mask + s * N;
  int32_t* o = out + s * N;
  const bool aligned = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  const long long start = t * kTile;
  const long long row = start + threadIdx.x * kItems;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                        N - start));
  const uint32_t f = row_flags(m, row, N, aligned);
  int total;
  int rank = block_exclusive(__popc(f), warp_incl, &total);
  const unsigned long long tag = epoch << 32;
  unsigned long long* status = state + 1 + s * tiles;
  if (threadIdx.x < 32) {
    int offset = 0;
    if (t == 0) {
      if (threadIdx.x == 0) store_status(status, tag | kPrefix | total);
    } else {
      offset = look_back(status, t, total, tag);
    }
    if (threadIdx.x == 0) {
      tile_offset = offset;
      if (t == tiles - 1) count[s] = offset + total;
    }
  }
  if (IDS) {
    for (int k = 0; k < kItems; ++k)
      if ((f >> k) & 1u) stage[rank++] = static_cast<int32_t>(row + k);
  } else {
    int pos = rank;
    for (int k = 0; k < kItems; ++k) {
      stage[threadIdx.x * (kItems + 1) + k] = pos;
      pos += (f >> k) & 1u;
    }
  }
  __syncthreads();
  const int offset = tile_offset;
  if (IDS) {
    for (int j = threadIdx.x; j < total; j += kScanThreads)
      o[offset + j] = stage[j];
    // this tile's share of the -1 tail [count, N), in 16-byte stores
    // after the ints that reach a 16-byte boundary
    const long long unset_before = start - offset;
    const int unset = rows - total;
    int32_t* tail = o + (N - unset_before - unset);
    const int head = min(unset, static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(tail) & 15)) & 15) / 4));
    if (static_cast<int>(threadIdx.x) < head) tail[threadIdx.x] = -1;
    int4* quads = reinterpret_cast<int4*>(tail + head);
    const int n4 = (unset - head) / 4;
    for (int j = threadIdx.x; j < n4; j += kScanThreads)
      quads[j] = make_int4(-1, -1, -1, -1);
    for (int j = head + 4 * n4 + threadIdx.x; j < unset; j += kScanThreads)
      tail[j] = -1;
  } else {
    for (int j = threadIdx.x; j < rows; j += kScanThreads)
      o[start + j] = offset + stage[(j / kItems) * (kItems + 1) + j % kItems];
  }
}

// One launch over S masks of N rows each.
cudaError_t mask_scan(const void* mask, void* out, void* count, void* state,
                      int S, int N, bool ids, long long base,
                      long long epoch, cudaStream_t st) {
  const int tiles = (N + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(S) * tiles;
  if (blocks > 0x7fffffffLL || epoch < 1 || epoch > 0xffffffffLL)
    return cudaErrorInvalidValue;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* c = static_cast<int32_t*>(count);
  auto* o = static_cast<int32_t*>(out);
  auto* w = static_cast<unsigned long long*>(state);
  const auto b = static_cast<unsigned long long>(base);
  const auto e = static_cast<unsigned long long>(epoch);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (ids)
    mask_scan_kernel<true><<<grid, kScanThreads, 0, st>>>(m, N, tiles, o, c,
                                                          w, b, e);
  else
    mask_scan_kernel<false><<<grid, kScanThreads, 0, st>>>(m, N, tiles, o,
                                                           c, w, b, e);
  return cudaGetLastError();
}

}  // namespace

REPRO_STRERROR

// mask [S, N] bool (one byte each) -> idx [S, N] int32 (ascending ids of
// set rows, -1 padded), counts [S] int32.  `state` holds the ticket and
// at least S * ceil(N / 4096) status words (uint64); `base` is the ticket
// this call starts at, `epoch` in [1, 2^32) differs from the previous
// call's on this buffer.
REPRO_EXPORT int repro_compact_batched(const void* mask, void* idx,
                                       void* counts, void* state, int S,
                                       int N, long long base,
                                       long long epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (N <= 0)
    return static_cast<int>(
        repro_memset(counts, 0, sizeof(int32_t) * S, st));
  return static_cast<int>(mask_scan(mask, idx, counts, state, S, N, true,
                                    base, epoch, st));
}

// mask [N] bool (one byte each) -> out [N] int32: with ids = 0 the
// exclusive prefix sum, with ids = 1 the ascending ids of set rows, -1
// padded; count [1] int32.  `state`, `base` and `epoch` as above, for
// S = 1.
REPRO_EXPORT int repro_mask_scan(const void* mask, void* out, void* count,
                                 void* state, int N, int ids, long long base,
                                 long long epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0)
    return static_cast<int>(repro_memset(count, 0, sizeof(int32_t), st));
  return static_cast<int>(mask_scan(mask, out, count, state, 1, N,
                                    ids != 0, base, epoch, st));
}
