// Exact Tesseract refine over a wave of shards' packed ragged tracks, for
// one query or for Q coalesced queries sharing the wave.
//
// Replaces, in src/repro/kernels/refine.py (the TPU kernels walk a
// (shard, doc-block, point-block) grid, the multi kernel with a leading
// query axis; they evaluate every point against every cover range on the
// VPU and reduce hits to docs through a one-hot rows == doc_iota
// [points, docs] compare, accumulating across the "arbitrary" point axis):
//   * :243 _refine_kernel / refine_tracks_batched and :431 refine_tracks
//     (its S=1 case) -> refine_kernel with Q = 1;
//   * :402 _refine_kernel_multi / refine_tracks_multi -> refine_kernel.
//
// Inputs: pts [S, 4, P] uint32 (key_hi, key_lo, t_hi, t_lo), rows [S, P]
// int32 (doc id per point, -1 = padding), cov [Q, C, 8, R] uint32 (per
// query and constraint: range lo (hi, lo), range hi (hi, lo), window w0
// (hi, lo), window w1 (hi, lo); the window is read from slot 0).  The
// cover ranges of a constraint are sorted (a normalized AreaTree); pad
// slots are [2^64-1, 0) and sort last.  A multi-query table is padded to a
// common C and R (exec/refine.py pack_constraints_multi): pad constraints
// are slot 0 = [0, 2^64-1) with the window [0, 2^64-1], then pad slots.
// A key's slot is the last range whose lo <= key (none: -1), and the key
// is in the cover iff it is below that range's hi; that needs the lo
// words sorted and nothing else.
// Outputs, plane q for query q: mask [Q, S, D] bool (every constraint hit
// by some point of the doc); in mode 1 also the first-hit (hi, lo) word
// planes [Q, S, C, D] int32 (min packed timestamp among the doc's hits,
// all-ones when none); in mode 2 also the last-hit planes (max, 0 when
// none) and count [Q, S, C, D] int32.  The wrapper allocates one buffer
// (kernels/refine.py alloc_outputs): the laid-out tables and the
// accumulators are scratch in it, the outputs are views of it.
//
// Bound: bytes.  Each point's 16 bytes of words and 4-byte row id are read
// once, once for all Q queries; each table once; each output written once.
// A point costs O(Q * C * log R) compares, against O(P * D) for the
// one-hot idiom.
//
// Design: one cooperative launch of a grid sized from the device (the SM
// count and the occupancy that registers and shared memory leave), in
// three phases separated by grid.sync(), so the wrapper launches nothing
// else (no memset before it, no PyTorch op after it):
//   A. The block's first point tile is loaded into registers, then, in
//      grid-stride loops that the loads overlap: the accumulators are
//      zeroed (one slice: the complemented first hit and the last hit as
//      uint64 for 64-bit atomicMax, the bitsets, the count, a work
//      counter; one pass, no memset: a memset before the launch measured
//      slower at every shape and mode), and each query's
//      table is laid out as it is searched: a record of C windows
//      (w0, w1), C fence arrays (the lo of every 32nd range) and C arrays
//      of (lo, hi) pairs, so a probe is one 8- or 16-byte load.
//   B. Refine.  A work item is (shard, 2048-point tile); a block's first
//      item is its own, later ones come from the work counter.  Each warp
//      holds 256 consecutive points of the item in registers (lane l:
//      points 32 k + l, so every load is coalesced) and walks all Q
//      queries against them: the tracks are read once for all Q.  The
//      block stages a query's record into shared memory with one bulk
//      asynchronous copy (cp.async.bulk, completion on an mbarrier).  With
//      Q <= 2 each of two buffers holds its query for the block's whole
//      run, copied once.  With Q > 2 the copies are double-buffered (the
//      table after next is copied as soon as a buffer is free, under the
//      search), and each block starts at its own query (blockIdx mod Q),
//      so the blocks' copies spread over the Q tables instead of all
//      reading one.  A warp takes its constraints two at a time: it tests
//      every point's window (a 6-12 h window passes ~5-10% of a wave's
//      points), queues the points inside one in shared memory, and its
//      lanes search the queue four entries at a time, interleaved, so no
//      lane idles through another's search and four load chains overlap.
//      A search is a binary search over the <= 32 fences (R <= 1024), then
//      over the <= 32 slots under the fence, then the hi: 11 dependent
//      loads at R = 896, against ~2 log2 R word loads before.  A doc's
//      points are contiguous, so the lanes of one step that hit one doc
//      are neighbours: they combine (__match_any_sync on the address,
//      __reduce_*_sync) and one lane issues the atomicOr / atomicMax /
//      atomicAdd for the doc.  Integer atomics commute, so every output is
//      exact and the same from call to call.  A record too large for the
//      buffers is searched in global memory instead (the same layout,
//      loads through L2).
//   C. Grid-stride: the mask (bitset == all C bits) and the (hi, lo) word
//      planes from the 64-bit accumulators.
#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 8;
constexpr int kWarpPoints = 32 * kPointsPerThread;
constexpr int kTile = kThreads * kPointsPerThread;
// 227 KB opt-in per block, less the warps' queues (static shared memory)
constexpr int kQueueBytes = 41 * 1024;
constexpr int kMaxSharedBytes = 232448 - kQueueBytes - 1024;
constexpr unsigned kFull = 0xffffffffu;

// 64-bit words of one query's record: C windows (2 words each), C fence
// arrays of fence_words(R), C arrays of R (lo, hi) pairs.  The wrapper
// sizes the scratch with the same formula (kernels/refine.py
// _record_words) and passes its size, which the launcher checks.
__host__ __device__ __forceinline__ int fence_words(int R) {
  return 2 * ((R + 63) / 64);             // ceil(R / 32), rounded to even
}

__host__ __device__ __forceinline__ size_t record_words(int C, int R) {
  return static_cast<size_t>(C) * (2 + fence_words(R) + 2 * R);
}

struct Args {
  const uint32_t* pts;
  const int32_t* rows;
  const uint32_t* cov;
  int Q, S, P, C, R, D;
  int tiles;                              // point tiles per shard
  int nbuf;                               // shared-memory record buffers
  u64* tab;                               // Q records
  u64* acc;                               // words that start at 0
  size_t acc_words;
  u64* first;                             // [Q, S, C, D] ~min, modes 1, 2
  u64* last;                              // [Q, S, C, D], mode 2
  int32_t* bits;                          // [Q, S, D]
  int32_t* count;                         // [Q, S, C, D], mode 2
  int32_t* fh_hi;
  int32_t* fh_lo;
  int32_t* lh_hi;
  int32_t* lh_lo;
  bool* mask;                             // [Q, S, D]
};

// One query's record, in shared or global memory.
struct Record {
  ulonglong2* win;                        // [C] (w0, w1)
  u64* fence;                             // [C, fence_words(R)]
  ulonglong2* pair;                       // [C, R] (lo, hi)
};

__device__ __forceinline__ Record record_at(u64* base, int C, int R) {
  Record r;
  r.win = reinterpret_cast<ulonglong2*>(base);
  r.fence = base + 2 * C;
  r.pair = reinterpret_cast<ulonglong2*>(
      r.fence + static_cast<size_t>(C) * fence_words(R));
  return r;
}

// Loads of a record: plain (shared memory) or through L2 (global memory,
// written by this launch's phase A on other SMs).
template <bool GLOBAL>
__device__ __forceinline__ ulonglong2 ld_pair(const ulonglong2* p) {
  if (GLOBAL) return __ldcg(p);
  return *p;
}

template <bool GLOBAL>
__device__ __forceinline__ u64 ld_word(const u64* p) {
  if (GLOBAL) return __ldcg(p);
  return *p;
}

// Warp-aggregated writes: the active lanes writing one address combine,
// and the lowest of them issues the atomic.
__device__ __forceinline__ void or_doc(int32_t* p, unsigned v) {
  const unsigned grp = __match_any_sync(__activemask(),
                                        reinterpret_cast<u64>(p));
  const unsigned all = __reduce_or_sync(grp, v);
  if ((threadIdx.x & 31) == __ffs(grp) - 1)
    atomicOr(p, static_cast<int32_t>(all));
}

template <int MODE>
__device__ __forceinline__ void table_doc(const Args& a, size_t o, u64 tmin,
                                          u64 tmax, unsigned cnt) {
  const unsigned grp = __match_any_sync(__activemask(), o);
  const unsigned mh = __reduce_min_sync(grp, static_cast<unsigned>(tmin >> 32));
  const unsigned ml = __reduce_min_sync(
      grp, static_cast<unsigned>(tmin >> 32) == mh
               ? static_cast<unsigned>(tmin) : kFull);
  const bool lead = (threadIdx.x & 31) == __ffs(grp) - 1;
  if (MODE == 2) {
    const unsigned xh = __reduce_max_sync(grp,
                                          static_cast<unsigned>(tmax >> 32));
    const unsigned xl = __reduce_max_sync(
        grp, static_cast<unsigned>(tmax >> 32) == xh
                 ? static_cast<unsigned>(tmax) : 0u);
    const unsigned n = __reduce_add_sync(grp, cnt);
    if (lead) {
      atomicMax(&a.last[o], repro_u64(xh, xl));
      atomicAdd(&a.count[o], static_cast<int32_t>(n));
    }
  }
  if (lead) atomicMax(&a.first[o], ~repro_u64(mh, ml));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the barrier's phase `parity`; a copy that never lands traps
// (a launch error the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) asm volatile("trap;\n");
  }
}

// Thread 0: copy `bytes` (a multiple of 16) from global `src` to shared
// `dst` as bulk asynchronous copies completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  constexpr uint32_t kChunk = 32768;
  for (uint32_t off = 0; off < bytes; off += kChunk) {
    const uint32_t n = bytes - off < kChunk ? bytes - off : kChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(static_cast<char*>(dst) +
                                                 off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

// Phase A: fill the accumulators and lay out every query's record.
__device__ void prepare(const Args& a, size_t t, size_t threads) {
  for (size_t i = t; i < a.acc_words; i += threads) a.acc[i] = 0;
  const int C = a.C, R = a.R;
  const size_t slots = static_cast<size_t>(a.Q) * C * R;
  for (size_t i = t; i < slots; i += threads) {
    const int r = static_cast<int>(i % R);
    const size_t qc = i / R;
    const int c = static_cast<int>(qc % C);
    const size_t q = qc / C;
    const uint32_t* w = a.cov + qc * 8 * R;
    const Record rec = record_at(a.tab + q * record_words(C, R), C, R);
    const u64 lo = repro_u64(w[r], w[R + r]);
    rec.pair[static_cast<size_t>(c) * R + r] =
        make_ulonglong2(lo, repro_u64(w[2 * R + r], w[3 * R + r]));
    u64* fence = rec.fence + static_cast<size_t>(c) * fence_words(R);
    if ((r & 31) == 0) fence[r >> 5] = lo;
    if (r == R - 1 && ((R + 31) >> 5) < fence_words(R))
      fence[fence_words(R) - 1] = ~0ull;  // the even pad, never read
    if (r == 0)
      rec.win[c] = make_ulonglong2(
          repro_u64(w[4 * R], w[5 * R]), repro_u64(w[6 * R], w[7 * R]));
  }
  // phase B reads the records with bulk copies (the async proxy)
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Constraints a warp queues together: their searches share one round.
constexpr int kQueueConstraints = 2;
constexpr int kQueueSlots = kQueueConstraints * kWarpPoints;

// Per warp: the points of up to kQueueConstraints constraints that lie in
// their windows, queued so that every lane searches (a window passes
// ~5-10% of a wave's points), and the hits, one word of lanes for each
// (constraint, point of a lane).
struct WarpQueue {
  u64 key[kQueueSlots];
  uint16_t slot[kQueueSlots];             // (cl * K + k) * 32 + lane
  unsigned hit[kQueueConstraints * kPointsPerThread];
};
static_assert(sizeof(WarpQueue) * (kThreads / 32) <= kQueueBytes,
              "the queues fit the shared memory kMaxSharedBytes leaves");

// kSearchWays searches in lockstep, interleaved so their loads overlap:
// slot[m] is the last slot of pair[m] [R] whose lo <= key[m], or -1.
// Fences narrow it to a 32-slot run (fence j is pair[32 j].lo); slots at
// and past R read as lo = +inf.
constexpr int kSearchWays = 4;

template <bool GLOBAL>
__device__ __forceinline__ void find_slots(
    const u64* const (&fence)[kSearchWays],
    const ulonglong2* const (&pair)[kSearchWays], int R,
    const u64 (&key)[kSearchWays], int (&slot)[kSearchWays]) {
  int j[kSearchWays];
  bool neg[kSearchWays];
#pragma unroll
  for (int m = 0; m < kSearchWays; ++m) {
    j[m] = 0;
    neg[m] = ld_word<GLOBAL>(fence[m]) > key[m];
  }
  for (int n = (R + 31) >> 5; n > 1;) {
    const int h = n >> 1;
#pragma unroll
    for (int m = 0; m < kSearchWays; ++m)
      if (ld_word<GLOBAL>(fence[m] + j[m] + h) <= key[m]) j[m] += h;
    n -= h;
  }
#pragma unroll
  for (int m = 0; m < kSearchWays; ++m) j[m] <<= 5;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
#pragma unroll
    for (int m = 0; m < kSearchWays; ++m) {
      const int idx = j[m] + h;
      if (idx < R && ld_pair<GLOBAL>(pair[m] + idx).x <= key[m]) j[m] = idx;
    }
  }
#pragma unroll
  for (int m = 0; m < kSearchWays; ++m) slot[m] = neg[m] ? -1 : j[m];
}

// Phase B for one query's record against a warp's points: lane l holds
// points k * 32 + l of the warp's 256 (k < kPointsPerThread).
template <int MODE, bool GLOBAL>
__device__ __forceinline__ void refine_points(
    const Args& a, const Record& rec, int q, int s, WarpQueue& wq,
    const u64 (&key)[kPointsPerThread], const u64 (&tt)[kPointsPerThread],
    const int (&row)[kPointsPerThread]) {
  const int C = a.C, R = a.R;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  unsigned acc[kPointsPerThread];
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) acc[k] = 0;
  const size_t qs = static_cast<size_t>(q) * a.S + s;
  for (int c0 = 0; c0 < C; c0 += kQueueConstraints) {
    const int nc = min(kQueueConstraints, C - c0);
    if (lane < kQueueConstraints * kPointsPerThread) wq.hit[lane] = 0;
    int total = 0;                        // the warp's queued points
#pragma unroll
    for (int cl = 0; cl < kQueueConstraints; ++cl) {
      if (cl >= nc) break;
      const ulonglong2 w = ld_pair<GLOBAL>(rec.win + c0 + cl);
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const bool in = row[k] >= 0 && tt[k] >= w.x && tt[k] <= w.y;
        const unsigned m = __ballot_sync(kFull, in);
        if (in) {
          const int at = total + __popc(m & below);
          wq.key[at] = key[k];
          wq.slot[at] = static_cast<uint16_t>(
              (cl * kPointsPerThread + k) * 32 + lane);
        }
        total += __popc(m);
      }
    }
    __syncwarp();
    // kSearchWays queued points a lane at a time (the last repeated where
    // the queue runs out)
    for (int i = lane; i < total; i += 32 * kSearchWays) {
      int at[kSearchWays], sl[kSearchWays], r[kSearchWays];
      u64 kk[kSearchWays];
      const u64* fence[kSearchWays];
      const ulonglong2* pair[kSearchWays];
#pragma unroll
      for (int m = 0; m < kSearchWays; ++m) {
        at[m] = i + 32 * m < total ? i + 32 * m : i;
        sl[m] = wq.slot[at[m]];
        kk[m] = wq.key[at[m]];
        const int c = c0 + sl[m] / (32 * kPointsPerThread);
        fence[m] = rec.fence + static_cast<size_t>(c) * fence_words(R);
        pair[m] = rec.pair + static_cast<size_t>(c) * R;
      }
      find_slots<GLOBAL>(fence, pair, R, kk, r);
#pragma unroll
      for (int m = 0; m < kSearchWays; ++m)
        if ((m == 0 || at[m] != i) && r[m] >= 0 &&
            kk[m] < ld_pair<GLOBAL>(pair[m] + r[m]).y)
          atomicOr(&wq.hit[sl[m] >> 5], 1u << (sl[m] & 31));
    }
    __syncwarp();
    for (int cl = 0; cl < nc; ++cl) {
      const int c = c0 + cl;
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const unsigned hit =
            (wq.hit[cl * kPointsPerThread + k] >> lane) & 1u;
        acc[k] |= hit << c;
        if (MODE >= 1 && hit)
          table_doc<MODE>(a, (qs * C + c) * a.D + row[k], tt[k], tt[k], 1u);
      }
    }
    __syncwarp();                         // the queue is free
  }
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k)
    if (acc[k]) or_doc(&a.bits[qs * a.D + row[k]], acc[k]);
}

// A warp's 256 points of work item `item` (shard, tile): lane l takes
// points 32 k + l, so every load is coalesced; rows outside [0, D) and
// points past P read as padding (-1).
__device__ __forceinline__ void load_tile(const Args& a, int item,
                                          u64 (&key)[kPointsPerThread],
                                          u64 (&tt)[kPointsPerThread],
                                          int (&row)[kPointsPerThread]) {
  const int s = item / a.tiles;
  const int p0 = (item - s * a.tiles) * kTile +
                 (threadIdx.x >> 5) * kWarpPoints + (threadIdx.x & 31);
  const uint32_t* ps = a.pts + static_cast<size_t>(s) * 4 * a.P;
  const int32_t* rs = a.rows + static_cast<size_t>(s) * a.P;
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int p = p0 + 32 * k;
    int r = -1;
    key[k] = tt[k] = 0;
    if (p < a.P) {
      r = __ldg(rs + p);
      key[k] = repro_u64(__ldg(ps + p), __ldg(ps + a.P + p));
      tt[k] = repro_u64(__ldg(ps + 2 * a.P + p), __ldg(ps + 3 * a.P + p));
    }
    row[k] = r >= 0 && r < a.D ? r : -1;
  }
}

template <int MODE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
refine_kernel(Args a) {
  extern __shared__ __align__(16) u64 sm[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ WarpQueue queues[kThreads / 32];
  __shared__ int next_item;
  WarpQueue& wq = queues[threadIdx.x >> 5];
  const size_t threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int Q = a.Q;
  const int items = a.S * a.tiles;
  // the block's first item is its own; its points load under phase A and
  // the grid barrier, which they do not depend on
  int item = blockIdx.x;
  u64 key[kPointsPerThread], tt[kPointsPerThread];
  int row[kPointsPerThread];
  if (item < items) load_tile(a, item, key, tt, row);
  prepare(a, tid, threads);
  cg::this_grid().sync();

  // ---------------------------------------------------------- phase B
  const size_t rec_words = record_words(a.C, a.R);
  const uint32_t rec_bytes = static_cast<uint32_t>(rec_words * 8);
  // with Q > 2 a block walks the queries from its own first one, so the
  // blocks' copies spread over the tables
  const int q0 = Q > 2 ? static_cast<int>(blockIdx.x % Q) : 0;
  const bool dbuf = Q > a.nbuf;
  if (!GLOBAL && threadIdx.x == 0 && item < items) {
    for (int b = 0; b < a.nbuf; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&bar[b])), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int b = 0; b < a.nbuf; ++b)
      bulk_copy(sm + b * rec_words, a.tab + ((q0 + b) % Q) * rec_words,
                rec_bytes, &bar[b]);
  }
  __syncthreads();
  uint32_t phase = 0;                     // a bit for each buffer
  bool first = true;
  while (item < items) {
    const int s = item / a.tiles;
    for (int i = 0; i < Q; ++i) {
      const int q = (q0 + i) % Q;
      if (GLOBAL) {
        refine_points<MODE, true>(a, record_at(a.tab + q * rec_words, a.C,
                                               a.R), q, s, wq, key, tt, row);
        continue;
      }
      // with Q <= 2 buffer q holds query q for the whole run
      const int b = dbuf ? (i & 1) : i;
      if (dbuf || first) {
        mbar_wait(&bar[b], (phase >> b) & 1u);
        phase ^= 1u << b;
      }
      refine_points<MODE, false>(a, record_at(sm + b * rec_words, a.C, a.R),
                                 q, s, wq, key, tt, row);
      if (dbuf) {
        __syncthreads();                  // buffer b is free
        if (threadIdx.x == 0 && i + 2 < Q)
          bulk_copy(sm + b * rec_words,
                    a.tab + ((q0 + i + 2) % Q) * rec_words, rec_bytes,
                    &bar[b]);
      }
    }
    first = false;
    // the next item from the grid's counter (the last accumulator word)
    if (threadIdx.x == 0)
      next_item = static_cast<int>(gridDim.x) +
                  static_cast<int>(atomicAdd(a.acc + a.acc_words - 1, 1ull));
    __syncthreads();
    item = next_item;
    __syncthreads();
    if (item < items) {
      if (!GLOBAL && dbuf && threadIdx.x == 0)
        for (int b = 0; b < 2; ++b)
          bulk_copy(sm + b * rec_words, a.tab + ((q0 + b) % Q) * rec_words,
                    rec_bytes, &bar[b]);
      load_tile(a, item, key, tt, row);
    }
  }
  cg::this_grid().sync();

  // ---------------------------------------------------------- phase C
  const size_t nd = static_cast<size_t>(Q) * a.S * a.D;
  const int32_t all = static_cast<int32_t>((1u << a.C) - 1u);
  for (size_t i = tid; i < nd; i += threads) a.mask[i] = a.bits[i] == all;
  if (MODE >= 1) {
    const size_t tn = nd * a.C;
    for (size_t i = tid; i < tn; i += threads) {
      const u64 f = ~a.first[i];
      a.fh_hi[i] = static_cast<int32_t>(f >> 32);
      a.fh_lo[i] = static_cast<int32_t>(f);
      if (MODE == 2) {
        const u64 l = a.last[i];
        a.lh_hi[i] = static_cast<int32_t>(l >> 32);
        a.lh_lo[i] = static_cast<int32_t>(l);
      }
    }
  }
}

template <int MODE, bool GLOBAL>
cudaError_t launch(Args& a, size_t smem, cudaStream_t st) {
  const void* kernel = reinterpret_cast<const void*>(
      refine_kernel<MODE, GLOBAL>);
  // the cap on dynamic shared memory, raised once a device (bit `dev`,
  // for the device the calling thread launches on): above 48 KB less the
  // queues only with it
  static std::atomic<unsigned> raised{0};
  static_assert(kMaxDevices <= 32, "one bit a device");
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = repro_device(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && !((raised.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err == cudaSuccess) raised.fetch_or(1u << dev);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a block an item, or one for each 8 * kThreads words phases A and C
  // fill, as far as fit resident
  const long long items = static_cast<long long>(a.S) * a.tiles;
  const long long words = static_cast<long long>(a.acc_words) * 2 +
                          static_cast<long long>(a.Q) * a.S * a.D *
                              (1 + a.C * (MODE == 0 ? 0 : MODE == 1 ? 2 : 4));
  const long long fill = (words + 8LL * kThreads - 1) / (8LL * kThreads);
  long long blocks = items > fill ? items : fill;
  const long long resident = static_cast<long long>(per_sm) * sms;
  blocks = blocks < resident ? blocks : resident;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(kernel, static_cast<unsigned>(blocks),
                                     kThreads, args, smem, st);
}

}  // namespace

REPRO_STRERROR

// Q queries: cov [Q, C, 8, R] -> mask [Q, S, D] (+ word planes [Q, S, C,
// D]); mode 0: the mask only; 1: + first-hit planes; 2: + last-hit planes
// and count.  `tab` is scratch of `tab_words` >= Q * record_words(C, R)
// 64-bit words.  `acc` is `acc_words` 64-bit words holding the
// accumulators that start at 0: `first` (the complement of the first hit,
// max-reduced) and `last` [Q, S, C, D], `bits` [Q, S, D] and `count`
// [Q, S, C, D], and in its last word the work-item counter; the kernel
// zeroes it.
// Pointers a mode does not use may be null.  Q, S, P, C, R and D are >= 1,
// C <= 30.
REPRO_EXPORT int repro_refine_tracks(
    const void* pts, const void* rows, const void* cov, int Q, int S, int P,
    int C, int R, int D, int mode, void* tab, long long tab_words,
    void* acc, long long acc_words, void* first, void* last,
    void* bits, void* count, void* fh_hi, void* fh_lo, void* lh_hi,
    void* lh_lo, void* mask, void* stream) {
  if (Q < 1 || S < 1 || P < 1 || C < 1 || C > 30 || R < 1 || D < 1 ||
      mode < 0 || mode > 2 || acc_words < 1 ||
      tab_words < 0 ||
      static_cast<size_t>(tab_words) < static_cast<size_t>(Q) *
                                           record_words(C, R))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pts = static_cast<const uint32_t*>(pts);
  a.rows = static_cast<const int32_t*>(rows);
  a.cov = static_cast<const uint32_t*>(cov);
  a.Q = Q;
  a.S = S;
  a.P = P;
  a.C = C;
  a.R = R;
  a.D = D;
  a.tiles = (P + kTile - 1) / kTile;
  a.tab = static_cast<u64*>(tab);
  a.acc = static_cast<u64*>(acc);
  a.acc_words = static_cast<size_t>(acc_words);
  a.first = static_cast<u64*>(first);
  a.last = static_cast<u64*>(last);
  a.bits = static_cast<int32_t*>(bits);
  a.count = static_cast<int32_t*>(count);
  a.fh_hi = static_cast<int32_t*>(fh_hi);
  a.fh_lo = static_cast<int32_t*>(fh_lo);
  a.lh_hi = static_cast<int32_t*>(lh_hi);
  a.lh_lo = static_cast<int32_t*>(lh_lo);
  a.mask = static_cast<bool*>(mask);
  // one shared buffer for each query up to two, double-buffered beyond
  a.nbuf = Q < 2 ? Q : 2;
  const size_t rec_bytes = record_words(C, R) * sizeof(u64);
  const bool use_smem =
      a.nbuf * rec_bytes <= static_cast<size_t>(kMaxSharedBytes);
  const size_t smem = use_smem ? a.nbuf * rec_bytes : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_smem) {
    err = mode == 0 ? launch<0, false>(a, smem, st)
        : mode == 1 ? launch<1, false>(a, smem, st)
                    : launch<2, false>(a, smem, st);
  } else {
    err = mode == 0 ? launch<0, true>(a, smem, st)
        : mode == 1 ? launch<1, true>(a, smem, st)
                    : launch<2, true>(a, smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
