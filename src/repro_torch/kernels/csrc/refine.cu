// Exact Tesseract refine over a wave of shards' packed ragged tracks, for
// one query or for Q coalesced queries sharing the wave.
//
// Replaces, in src/repro/kernels/refine.py (the TPU kernels walk a
// (shard, doc-block, point-block) grid, the multi kernel with a leading
// query axis; they evaluate every point against every cover range on the
// VPU and reduce hits to docs through a one-hot rows == doc_iota
// [points, docs] compare, accumulating across the "arbitrary" point axis):
//   * _refine_kernel / refine_tracks_batched (and refine_tracks, its S=1
//     case) -> refine_kernel with Q = 1;
//   * _refine_kernel_multi / refine_tracks_multi -> refine_kernel.
//
// Inputs: pts [S, 4, P] uint32 (key_hi, key_lo, t_hi, t_lo), rows [S, P]
// int32 (doc id per point, -1 = padding), cov [Q, C, 8, R] uint32 (per
// query and constraint: range lo (hi, lo), range hi (hi, lo), window w0
// (hi, lo), window w1 (hi, lo)).  The cover ranges of a constraint are
// sorted and disjoint (a normalized AreaTree); pad slots are [2^64-1, 0)
// and sort last.  A multi-query table is padded to a common C and R
// (exec/refine.py pack_constraints_multi): pad constraints are slot 0 =
// [0, 2^64-1) with the window [0, 2^64-1] in every slot, then pad slots —
// still sorted, so the binary search below finds slot 0 for every key.
// Outputs, plane q for query q: bits [Q, S, D] int32, the per-doc
// constraint bitset; in mode 1 also first [Q, S, C, D] uint64 (min packed
// timestamp among the doc's hits, all-ones when none); in mode 2 also
// last [Q, S, C, D] uint64 (max, 0 when none) and count [Q, S, C, D]
// int32.
//
// Bound: bytes.  Each point's 16 bytes of words and 4-byte row id are read
// once (once for all Q queries: the tracks are shared); the tables are
// written once.  The one-hot idiom costs O(P * D) compares per shard;
// here a point costs O(Q * C * log R).
//
// Design: one thread per (query, shard, point), in a grid-stride loop
// over the points of a grid sized to fill the card; blockIdx.z is the
// query, blockIdx.y the shard.  Each block stages its query's range words
// once in shared memory when C * R * 16 bytes fit (the Q7 table, 2 x 896
// ranges, is 28 KB); otherwise they are read from global memory.  Per
// constraint a thread tests the time window first and then binary-searches
// the last range whose lo <= key.  A hit ORs bit c into the doc's bitset
// word; in the table modes it also applies 64-bit atomicMin / atomicMax to
// (t_hi << 32) | t_lo and an atomicAdd to the count.  Integer atomics
// commute, so every output is exact and does not depend on scheduling.
// The outputs are initialised with cudaMemsetAsync (0, or 0xFF bytes for
// the first-hit sentinel) on the same stream.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;   // 227 KB opt-in per block
constexpr int kBlocksPerSm = 8;
constexpr int kNumSms = 132;

template <int MODE>
__global__ void refine_kernel(const uint32_t* __restrict__ pts,
                              const int32_t* __restrict__ rows,
                              const uint32_t* __restrict__ cov, int P, int C,
                              int R, int D, int use_smem,
                              int32_t* __restrict__ bits,
                              unsigned long long* __restrict__ first,
                              unsigned long long* __restrict__ last,
                              int32_t* __restrict__ count) {
  extern __shared__ uint32_t sm[];          // [C, 4, R] range words
  const int q = blockIdx.z;
  const int S = gridDim.y;
  cov += static_cast<size_t>(q) * C * 8 * R;
  const uint32_t* rng = cov;
  int rstride = 8 * R;
  if (use_smem) {
    const int per_c = 4 * R;
    for (int i = threadIdx.x; i < C * per_c; i += blockDim.x) {
      const int c = i / per_c;
      sm[i] = cov[static_cast<size_t>(c) * 8 * R + (i - c * per_c)];
    }
    __syncthreads();
    rng = sm;
    rstride = per_c;
  }
  const int s = blockIdx.y;
  const uint32_t* ps = pts + static_cast<size_t>(s) * 4 * P;
  const int32_t* rs = rows + static_cast<size_t>(s) * P;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const int row = rs[p];
    if (row < 0 || row >= D) continue;
    const unsigned long long key = repro_u64(ps[p], ps[P + p]);
    const unsigned long long t = repro_u64(ps[2 * P + p], ps[3 * P + p]);
    int acc = 0;
    for (int c = 0; c < C; ++c) {
      const uint32_t* win = cov + static_cast<size_t>(c) * 8 * R;
      if (t < repro_u64(win[4 * R], win[5 * R]) ||
          t > repro_u64(win[6 * R], win[7 * R]))
        continue;
      const uint32_t* cr = rng + static_cast<size_t>(c) * rstride;
      int lo = 0, hi = R;                   // first slot with lo > key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (repro_u64(cr[mid], cr[R + mid]) <= key)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int r = lo - 1;
      if (r < 0 || key >= repro_u64(cr[2 * R + r], cr[3 * R + r])) continue;
      acc |= 1 << c;
      if (MODE >= 1) {
        const size_t o =
            ((static_cast<size_t>(q) * S + s) * C + c) * D + row;
        atomicMin(&first[o], t);
        if (MODE == 2) {
          atomicMax(&last[o], t);
          atomicAdd(&count[o], 1);
        }
      }
    }
    if (acc)
      atomicOr(&bits[(static_cast<size_t>(q) * S + s) * D + row], acc);
  }
}

template <int MODE>
cudaError_t launch(const uint32_t* pts, const int32_t* rows,
                   const uint32_t* cov, int Q, int S, int P, int C, int R,
                   int D, int32_t* bits, unsigned long long* first,
                   unsigned long long* last, int32_t* count,
                   cudaStream_t st) {
  const size_t want = static_cast<size_t>(C) * 4 * R * sizeof(uint32_t);
  const int use_smem = want <= static_cast<size_t>(kMaxSharedBytes);
  const size_t smem = use_smem ? want : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        refine_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_shard = (kNumSms * kBlocksPerSm + S * Q - 1) / (S * Q);
  const int need = (P + kThreads - 1) / kThreads;
  per_shard = per_shard < need ? per_shard : need;
  dim3 grid(per_shard, S, Q);
  refine_kernel<MODE><<<grid, kThreads, smem, st>>>(
      pts, rows, cov, P, C, R, D, use_smem, bits, first, last, count);
  return cudaGetLastError();
}

// cov [Q, C, 8, R]; mode 0: bits only; 1: + first-hit table; 2: + last-hit
// and count tables.
int refine(const void* pts, const void* rows, const void* cov, int Q, int S,
           int P, int C, int R, int D, int mode, void* bits, void* first,
           void* last, void* count, cudaStream_t st) {
  const size_t table = static_cast<size_t>(Q) * S * C * D;
  cudaError_t err = repro_memset(
      bits, 0, sizeof(int32_t) * Q * S * static_cast<size_t>(D), st);
  if (err == cudaSuccess && mode >= 1)
    err = repro_memset(first, 0xFF, sizeof(unsigned long long) * table, st);
  if (err == cudaSuccess && mode == 2)
    err = repro_memset(last, 0, sizeof(unsigned long long) * table, st);
  if (err == cudaSuccess && mode == 2)
    err = repro_memset(count, 0, sizeof(int32_t) * table, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q > 0 && S > 0 && P > 0 && D > 0) {
    const auto* p = static_cast<const uint32_t*>(pts);
    const auto* r = static_cast<const int32_t*>(rows);
    const auto* c = static_cast<const uint32_t*>(cov);
    auto* b = static_cast<int32_t*>(bits);
    auto* f = static_cast<unsigned long long*>(first);
    auto* l = static_cast<unsigned long long*>(last);
    auto* n = static_cast<int32_t*>(count);
    if (mode == 0)
      err = launch<0>(p, r, c, Q, S, P, C, R, D, b, f, l, n, st);
    else if (mode == 1)
      err = launch<1>(p, r, c, Q, S, P, C, R, D, b, f, l, n, st);
    else
      err = launch<2>(p, r, c, Q, S, P, C, R, D, b, f, l, n, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_STRERROR

// One query: cov [C, 8, R] -> bits [S, D] (+ tables [S, C, D]).
REPRO_EXPORT int repro_refine_tracks_batched(
    const void* pts, const void* rows, const void* cov, int S, int P, int C,
    int R, int D, int mode, void* bits, void* first, void* last, void* count,
    void* stream) {
  return refine(pts, rows, cov, 1, S, P, C, R, D, mode, bits, first, last,
                count, static_cast<cudaStream_t>(stream));
}

// Q queries: cov [Q, C, 8, R] -> bits [Q, S, D] (+ tables [Q, S, C, D]).
REPRO_EXPORT int repro_refine_tracks_multi(
    const void* pts, const void* rows, const void* cov, int Q, int S, int P,
    int C, int R, int D, int mode, void* bits, void* first, void* last,
    void* count, void* stream) {
  return refine(pts, rows, cov, Q, S, P, C, R, D, mode, bits, first, last,
                count, static_cast<cudaStream_t>(stream));
}
