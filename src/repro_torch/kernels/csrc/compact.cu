// Wave-stacked stream compaction: per-shard ascending ids of set mask
// entries, -1 padded, plus counts.
//
// Replaces: src/repro/kernels/compact.py, _scan_batched_kernel /
// mask_prefix_sum_batched + compact_batched (the TPU kernel walks a
// (shard, row-block) grid in order and carries the running count in SMEM
// across the "arbitrary" axis; XLA finishes with a drop-mode scatter).
//
// Bound: bytes.  Each shard's N mask bytes are read once and its N int32
// ids (selected or -1) written once.
//
// Design: Hopper blocks run in no fixed order, so the carried axis becomes
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
