// The bitmap intersect as one thread-block cluster a shard, with no
// atomic: the design that src/repro_torch/kernels/csrc/bitset.cu's
// blocks closing on an arrival word were measured against
// (tools/select_ab.py builds this file and times both on the card).  It
// is not part of the port.
//
// The cluster's blocks (1 to 8, sized from W) split the shard's words;
// each lane ANDs 4 words over K in registers, the loads of up to 8 probe
// rows issued together; a block reduce gives each block's bits, and rank
// 0 adds the blocks' sums in rank order over distributed shared memory
// (cluster.map_shared_rank) and stores the shard's count.  One block a
// shard is launched without a cluster.
#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxThreads = 1024;
constexpr int kLaneWords = 4;        // stack words a lane takes a pass
constexpr int kProbeBatch = 8;       // probe rows whose loads go together

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// grid: S clusters of cluster.num_blocks() blocks, one cluster a shard.
// A lane issues the loads of up to kProbeBatch probe rows before it ANDs
// them, so K probes cost one memory round trip, not K.
__global__ void intersect_kernel(const uint32_t* __restrict__ stack,
                                 uint32_t* __restrict__ out,
                                 int32_t* __restrict__ counts, int K,
                                 int W) {
  __shared__ int scratch[32];
  __shared__ int block_bits;
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / blocks;
  const uint32_t* row = stack + static_cast<size_t>(s) * K * W;
  uint32_t* o = out + static_cast<size_t>(s) * W;
  const int lane = rank * blockDim.x + threadIdx.x;
  const int stride = blocks * blockDim.x;
  int bits = 0;
  int done = 0;                        // words the vector loop covered
  if ((K == 1 || (W & 3) == 0) &&
      ((reinterpret_cast<uintptr_t>(row) |
        reinterpret_cast<uintptr_t>(o)) & 15) == 0) {
    const int quads = W >> 2;
    const uint4* rows = reinterpret_cast<const uint4*>(row);
    const size_t quad_stride = static_cast<size_t>(W) >> 2;
    for (int q = lane; q < quads; q += stride) {
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
      bits += __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
    }
    done = quads << 2;
  }
  for (int w0 = done + lane; w0 < W; w0 += kLaneWords * stride) {
    uint32_t acc[kLaneWords];
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) acc[j] = ~0u;
    for (int k0 = 0; k0 < K; k0 += kProbeBatch) {
      uint32_t v[kProbeBatch][kLaneWords];
#pragma unroll
      for (int kk = 0; kk < kProbeBatch; ++kk)
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) {
          const int w = w0 + j * stride;
          v[kk][j] = k0 + kk < K && w < W
                         ? row[static_cast<size_t>(k0 + kk) * W + w]
                         : ~0u;
        }
#pragma unroll
      for (int kk = 0; kk < kProbeBatch; ++kk)
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) acc[j] &= v[kk][j];
    }
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const int w = w0 + j * stride;
      if (w < W) {
        o[w] = acc[j];
        bits += __popc(acc[j]);
      }
    }
  }
  const int total = repro_block_sum(bits, scratch);
  if (blocks == 1) {
    if (threadIdx.x == 0) counts[s] = total;
    return;
  }
  if (threadIdx.x == 0) block_bits = total;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int sum = 0;
    for (int r = 0; r < blocks; ++r)
      sum += *cluster.map_shared_rank(&block_bits, r);
    counts[s] = sum;
  }
  cluster.sync();            // each block's sum stays until rank 0 read it
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// Blocks of 1024 threads resident at once on device d (0 = not yet
// asked), and whether clusters of 2^i blocks of 32 * (j + 1) threads fit
// it (bit j of g_fits[d][i]; g_asked marks the bits already asked).
std::atomic<int> g_resident[32];
std::atomic<unsigned> g_fits[32][4];
std::atomic<unsigned> g_asked[32][4];

// The launch of intersect_kernel for S shards of W words: the cluster
// grows (up to kMaxCluster) while a shard's lanes need more blocks of
// kMaxThreads and S clusters of twice the size still fit resident; the
// threads a block are the shard's lanes over the cluster.
cudaError_t intersect_launch(const uint32_t* stack, uint32_t* out,
                             int32_t* counts, int S, int K, int W,
                             cudaStream_t st) {
  const int dev = current_device();
  if (dev < 0 || dev >= 32) return cudaErrorInvalidDevice;
  int resident = g_resident[dev].load();
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, intersect_kernel, kMaxThreads, 0);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
    g_resident[dev].store(resident);
  }
  const long long lanes = (static_cast<long long>(W) + kLaneWords - 1) /
                          kLaneWords;
  int cluster = 1, log2c = 0;
  while (cluster < kMaxCluster &&
         static_cast<long long>(cluster) * kMaxThreads < lanes &&
         2LL * cluster * S <= resident) {
    cluster *= 2;
    ++log2c;
  }
  long long threads = (lanes + cluster - 1) / cluster;
  threads = (threads + 31) / 32 * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  const long long grid = static_cast<long long>(S) * cluster;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster shape the card cannot hold raises here, once asked
  const unsigned bit = 1u << (threads / 32 - 1);
  if (!(g_asked[dev][log2c].load() & bit)) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, intersect_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters > 0) g_fits[dev][log2c].fetch_or(bit);
    g_asked[dev][log2c].fetch_or(bit);
  }
  if (!(g_fits[dev][log2c].load() & bit))
    return cudaErrorInvalidConfiguration;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // one block a shard: a plain launch
  return cudaLaunchKernelEx(&cfg, intersect_kernel, stack, out, counts, K,
                            W);
}

}  // namespace

// stack [S, K, W] uint32 -> out [S, W] uint32, counts [S] int32.
REPRO_EXPORT int ab_cluster_intersect(const void* stack, void* out,
                                      void* counts, int S, int K, int W,
                                      void* stream) {
  if (S < 1 || K < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = intersect_launch(
      static_cast<const uint32_t*>(stack), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(counts), S, K, W,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
