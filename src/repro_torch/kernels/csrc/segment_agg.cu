// Per-group (count, sum, sum of squares) over group ids; rows whose id is
// < 0 or >= G are dropped.
//
// Replaces: src/repro/kernels/segment_agg.py, _seg_kernel / segment_agg
// (the TPU kernel builds a one-hot [rows, groups] tile and reduces it on
// the MXU, accumulating float32 across the "arbitrary" row-block axis).
//
// Output: one buffer that the wrapper allocates, its first slab of
// slab_doubles(G) doubles the outputs — sum [G] f64, sum of squares [G]
// f64, then count [G] int32 — which a call writes whole (shared branch)
// or zero-fills once (global branch); the shared branch's scratch is the
// `blocks` slabs after it.
//
// Bound: bytes.  Each row's int32 group id is read once, the float32
// value of a selected row once, the 20*G output bytes written once.  The
// one-hot formulation is O(N*G) work; Q1's waves have ~1e5 groups.
//
// Shared branch (G <= kSharedMaxGroups): two launches, no memset, no
// global atomics, and the same bits from every call.
//   Pass 1 (seg_partials_kernel): block b takes a contiguous range of
//   rows; its warps take 128-row steps of it in turn, each lane 4 rows
//   (one 16-byte load of ids), loading a value only for a selected row.
//   Shared-memory atomics would add a group's values in whatever order
//   the warps reach them, so each warp owns a slab of partials in shared
//   memory instead: for each of its 4 rows, the lanes holding the same
//   group (__match_any_sync) are added in lane order by the lowest of
//   them, which alone updates the slab.  The block adds its warps' slabs
//   in warp order and writes its own [3, G] slab to scratch (the slabs
//   after the outputs' in the same buffer).
//   Pass 2 (seg_combine_kernel): one warp a group; lane l adds the slabs
//   of blocks l, l + 32, ... in order, a fixed shuffle tree adds the
//   lanes, and lane 0 writes the three outputs — every group's, so
//   nothing is zeroed first.
// Global branch (G > kSharedMaxGroups, seg_global_kernel): one
//   cooperative launch, no larger than fits resident, zero-fills the
//   outputs with grid-stride stores, waits at grid.sync(), then makes one
//   pass over the rows: 16-byte id loads, 4 rows a thread, a value loaded
//   only for a selected row, and `red.global.add` of the count and of the
//   value and its square in float64.  (A cudaMemsetAsync before a plain
//   launch is one device operation more, and slower on the H100 at both
//   the wave's and a 45x larger shape.)  The float64 atomics add in no
//   fixed order, so a sum differs from a row-order sum of the same float32
//   values by float64 rounding only.
#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSharedMaxGroups = 2048;
constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
// shared memory for pass 1's warp slabs: 8 warps up to G = 1280, 5 at
// G = 2048 (a slab is 20 * G bytes)
constexpr size_t kSlabSmemBudget = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// doubles in one [3, G] slab: sum, sum of squares, then G int32 counts
__host__ __device__ __forceinline__ size_t slab_doubles(int G) {
  return 2 * static_cast<size_t>(G) + (G + 1) / 2;
}

__device__ __forceinline__ bool selected(int g, int G) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(G);
}

// The ids of rows [i, i + 4), -1 at and past `end`; one 16-byte load when
// all four lie before `end` (i is a multiple of 4, gid 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ int4 load_ids(const int32_t* __restrict__ gid,
                                         size_t i, size_t end) {
  if (VEC && i + 4 <= end) return *reinterpret_cast<const int4*>(gid + i);
  int4 g;
  g.x = i < end ? gid[i] : -1;
  g.y = i + 1 < end ? gid[i + 1] : -1;
  g.z = i + 2 < end ? gid[i + 2] : -1;
  g.w = i + 3 < end ? gid[i + 3] : -1;
  return g;
}

__device__ __forceinline__ void red_add(double* p, double v) {
  asm volatile("red.global.add.f64 [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "d"(v) : "memory");
}

__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;"
               :: "l"(__cvta_generic_to_global(p)), "r"(v) : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
seg_partials_kernel(const int32_t* __restrict__ gid,
                    const float* __restrict__ val, int N, int G, int chunk,
                    double* __restrict__ scratch) {
  extern __shared__ double smem[];
  const size_t slab = slab_doubles(G);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (size_t j = threadIdx.x; j < warps * slab; j += blockDim.x)
    smem[j] = 0.0;
  __syncthreads();
  double* w_sum = smem + warp * slab;
  double* w_ssq = w_sum + G;
  int* w_cnt = reinterpret_cast<int*>(w_ssq + G);
  const size_t begin = static_cast<size_t>(blockIdx.x) * chunk;
  const size_t end = min(static_cast<size_t>(N), begin + chunk);
  for (size_t base = begin + 128 * warp; base < end; base += 128 * warps) {
    const size_t i = base + 4 * lane;
    const int4 g4 = load_ids<VEC>(gid, i, end);
    const int gs[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = gs[k];
      const bool ok = selected(g, G);
      const unsigned valid = __ballot_sync(kFull, ok);
      if (!valid) continue;                       // the whole warp
      const float v = ok ? val[i + k] : 0.f;
      const unsigned peers = __match_any_sync(kFull, ok ? g : -1);
      const bool leader = ok && __ffs(peers) - 1 == lane;
      double s = 0.0, q = 0.0;
      for (unsigned m = valid; m; m &= m - 1) {   // selected lanes, in order
        const int src = __ffs(m) - 1;
        const double x = __shfl_sync(kFull, v, src);
        if (leader && ((peers >> src) & 1u)) {
          s += x;
          q += x * x;
        }
      }
      if (leader) {
        w_sum[g] += s;
        w_ssq[g] += q;
        w_cnt[g] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  double* out = scratch + blockIdx.x * slab;
  int* out_cnt = reinterpret_cast<int*>(out + 2 * G);
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    double s = 0.0, q = 0.0;
    int c = 0;
    for (int w = 0; w < warps; ++w) {
      const double* ws = smem + w * slab;
      s += ws[j];
      q += ws[G + j];
      c += reinterpret_cast<const int*>(ws + 2 * G)[j];
    }
    out[j] = s;
    out[G + j] = q;
    out_cnt[j] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_combine_kernel(const double* __restrict__ scratch, int blocks, int G,
                   double* __restrict__ out) {
  const int g = blockIdx.x * kMaxWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= G) return;                             // the whole warp
  const size_t slab = slab_doubles(G);
  double s = 0.0, q = 0.0;
  int c = 0;
  for (int b = lane; b < blocks; b += 32) {
    const double* p = scratch + b * slab;
    s += p[g];
    q += p[G + g];
    c += reinterpret_cast<const int*>(p + 2 * G)[g];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(kFull, s, off);
    q += __shfl_down_sync(kFull, q, off);
    c += __shfl_down_sync(kFull, c, off);
  }
  if (lane == 0) {
    out[g] = s;
    out[G + g] = q;
    reinterpret_cast<int*>(out + 2 * G)[g] = c;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
seg_global_kernel(const int32_t* __restrict__ gid,
                  const float* __restrict__ val, int N, int G,
                  double* __restrict__ out) {
  const size_t words = slab_doubles(G);
  const size_t threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  for (size_t j = t; j < words; j += threads) out[j] = 0.0;
  cg::this_grid().sync();
  double* sum = out;
  double* ssq = out + G;
  int* cnt = reinterpret_cast<int*>(out + 2 * G);
  const size_t n = static_cast<size_t>(N);
  for (size_t i = 4 * t; i < n; i += 4 * threads) {
    const int4 g4 = load_ids<VEC>(gid, i, n);
    const int gs[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = gs[k];
      if (!selected(g, G)) continue;
      const double v = val[i + k];
      red_add(&cnt[g], 1);
      red_add(&sum[g], v);
      red_add(&ssq[g], v * v);
    }
  }
}

// Bit d set once pass 1 may take kSlabSmemBudget bytes on device d.
std::atomic<unsigned> g_smem_ready{0};
static_assert(kMaxDevices <= 32, "one bit a device");
// Blocks of seg_global_kernel<VEC> resident at once on device d (0 = not
// yet asked).
std::atomic<int> g_resident[2][kMaxDevices];

}  // namespace

REPRO_STRERROR

// gid [N] int32, val [N] float32 -> out (sum [G] f64, ssq [G] f64, cnt [G]
// int32) for 1 <= G <= kSharedMaxGroups; `out` holds 1 + blocks slabs,
// pass 1's partials in the last `blocks`.
REPRO_EXPORT int repro_segment_agg_shared(const void* gid, const void* val,
                                          int N, int G, void* out,
                                          int blocks, void* stream) {
  if (N < 1 || G < 1 || G > kSharedMaxGroups || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t dev_err = repro_device(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (!((g_smem_ready.load() >> dev) & 1u)) {
    cudaError_t err = cudaFuncSetAttribute(
        seg_partials_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabSmemBudget);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          seg_partials_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_ready.fetch_or(1u << dev);
  }
  const size_t slab_bytes = slab_doubles(G) * sizeof(double);
  int warps = static_cast<int>(kSlabSmemBudget / slab_bytes);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  // a block's rows: whole 128-row warp steps, so each lane's 4 ids start
  // on a 16-byte boundary of an aligned gid
  const int chunk = static_cast<int>(
      128 * ((N + 128LL * blocks - 1) / (128LL * blocks)));
  const auto* g = static_cast<const int32_t*>(gid);
  const auto* v = static_cast<const float*>(val);
  auto* o = static_cast<double*>(out);
  double* s = o + slab_doubles(G);
  const size_t smem = warps * slab_bytes;
  if ((reinterpret_cast<uintptr_t>(gid) & 15) == 0)
    seg_partials_kernel<true><<<blocks, 32 * warps, smem, st>>>(g, v, N, G,
                                                                chunk, s);
  else
    seg_partials_kernel<false><<<blocks, 32 * warps, smem, st>>>(g, v, N, G,
                                                                 chunk, s);
  seg_combine_kernel<<<(G + kMaxWarps - 1) / kMaxWarps, kThreads, 0, st>>>(
      s, blocks, G, o);
  return static_cast<int>(cudaGetLastError());
}

// gid [N] int32, val [N] float32 -> out (sum [G] f64, ssq [G] f64, cnt [G]
// int32) with float64 atomics, for any G >= 1: one cooperative launch.
REPRO_EXPORT int repro_segment_agg_global(const void* gid, const void* val,
                                          int N, int G, void* out,
                                          void* stream) {
  if (N < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int32_t*>(gid);
  const auto* v = static_cast<const float*>(val);
  auto* o = static_cast<double*>(out);
  const bool vec = (reinterpret_cast<uintptr_t>(gid) & 15) == 0;
  const void* kernel = vec
      ? reinterpret_cast<const void*>(seg_global_kernel<true>)
      : reinterpret_cast<const void*>(seg_global_kernel<false>);
  int dev = 0;
  cudaError_t dev_err = repro_device(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  int resident = g_resident[vec][dev].load();
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = per_sm * sms;
    g_resident[vec][dev].store(resident);
  }
  // a block for each 1024 rows or 2048 output doubles (8 zero stores a
  // thread), as far as fit resident
  long long blocks = ((N + 3LL) / 4 + kThreads - 1) / kThreads;
  const long long fill = static_cast<long long>(
      (slab_doubles(G) + 8 * kThreads - 1) / (8 * kThreads));
  blocks = blocks > fill ? blocks : fill;
  blocks = blocks < resident ? blocks : resident;
  void* args[] = {&g, &v, &N, &G, &o};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, static_cast<unsigned>(blocks), kThreads, args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
