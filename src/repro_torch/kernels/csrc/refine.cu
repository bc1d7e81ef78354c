// Exact Tesseract refine over a wave of shards' packed ragged tracks.
//
// Replaces: src/repro/kernels/refine.py, _refine_kernel /
// refine_tracks_batched (the TPU kernel walks a (shard, doc-block,
// point-block) grid, evaluates every point against every cover range on
// the VPU and reduces hits to docs through a one-hot rows == doc_iota
// [points, docs] compare, accumulating across the "arbitrary" point axis).
//
// Inputs: pts [S, 4, P] uint32 (key_hi, key_lo, t_hi, t_lo), rows [S, P]
// int32 (doc id per point, -1 = padding), cov [C, 8, R] uint32 (per
// constraint: range lo (hi, lo), range hi (hi, lo), window w0 (hi, lo),
// window w1 (hi, lo)).  The cover ranges of a constraint are sorted and
// disjoint (a normalized AreaTree); pad slots are [2^64-1, 0) and sort
// last.  Outputs: bits [S, D] int32, the per-doc constraint bitset; in
// mode 1 also first [S, C, D] uint64 (min packed timestamp among the doc's
// hits, all-ones when none); in mode 2 also last [S, C, D] uint64 (max,
// 0 when none) and count [S, C, D] int32.
//
// Bound: bytes.  Each point's 16 bytes of words and 4-byte row id are read
// once; the tables are written once.  The one-hot idiom costs O(P * D)
// compares per shard; here a point costs O(C * log R).
//
// Design: one thread per (shard, point), in a grid-stride loop over a
// grid sized to fill the card, so each block stages the constraint table
// once.  The range words sit in shared memory when C * R * 16 bytes fit
// (the Q7 table, 2 x 896 ranges, is 28 KB); otherwise they are read from
// global memory.  Per constraint a thread tests the time window first and
// then binary-searches the last range whose lo <= key.  A hit ORs bit c
// into the doc's bitset word; in the table modes it also applies 64-bit
// atomicMin / atomicMax to (t_hi << 32) | t_lo and an atomicAdd to the
// count.  Integer atomics commute, so every output is exact and does not
// depend on scheduling.  The outputs are initialised with cudaMemsetAsync
// (0, or 0xFF bytes for the first-hit sentinel) on the same stream.
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
        const size_t o = (static_cast<size_t>(s) * C + c) * D + row;
        atomicMin(&first[o], t);
        if (MODE == 2) {
          atomicMax(&last[o], t);
          atomicAdd(&count[o], 1);
        }
      }
    }
    if (acc) atomicOr(&bits[static_cast<size_t>(s) * D + row], acc);
  }
}

template <int MODE>
cudaError_t launch(const uint32_t* pts, const int32_t* rows,
                   const uint32_t* cov, int S, int P, int C, int R, int D,
                   int32_t* bits, unsigned long long* first,
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
  int per_shard = (kNumSms * kBlocksPerSm + S - 1) / S;
  const int need = (P + kThreads - 1) / kThreads;
  per_shard = per_shard < need ? per_shard : need;
  dim3 grid(per_shard, S);
  refine_kernel<MODE><<<grid, kThreads, smem, st>>>(
      pts, rows, cov, P, C, R, D, use_smem, bits, first, last, count);
  return cudaGetLastError();
}

}  // namespace

REPRO_STRERROR

// mode 0: bits only; 1: + first-hit table; 2: + last-hit and count tables.
REPRO_EXPORT int repro_refine_tracks_batched(
    const void* pts, const void* rows, const void* cov, int S, int P, int C,
    int R, int D, int mode, void* bits, void* first, void* last, void* count,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t table = static_cast<size_t>(S) * C * D;
  cudaError_t err = repro_memset(
      bits, 0, sizeof(int32_t) * S * static_cast<size_t>(D), st);
  if (err == cudaSuccess && mode >= 1)
    err = repro_memset(first, 0xFF, sizeof(unsigned long long) * table, st);
  if (err == cudaSuccess && mode == 2)
    err = repro_memset(last, 0, sizeof(unsigned long long) * table, st);
  if (err == cudaSuccess && mode == 2)
    err = repro_memset(count, 0, sizeof(int32_t) * table, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 0 && P > 0 && D > 0) {
    const auto* p = static_cast<const uint32_t*>(pts);
    const auto* r = static_cast<const int32_t*>(rows);
    const auto* c = static_cast<const uint32_t*>(cov);
    auto* b = static_cast<int32_t*>(bits);
    auto* f = static_cast<unsigned long long*>(first);
    auto* l = static_cast<unsigned long long*>(last);
    auto* n = static_cast<int32_t*>(count);
    if (mode == 0)
      err = launch<0>(p, r, c, S, P, C, R, D, b, f, l, n, st);
    else if (mode == 1)
      err = launch<1>(p, r, c, S, P, C, R, D, b, f, l, n, st);
    else
      err = launch<2>(p, r, c, S, P, C, R, D, b, f, l, n, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
