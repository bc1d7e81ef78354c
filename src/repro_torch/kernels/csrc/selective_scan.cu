// Selective scan of one Mamba layer: discretisation, diagonal recurrence
// and read-out in one pass over the sequence,
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = sum_n h_t C_t,
//
// per channel d of dI with N states each.
//
// Replaces: no TPU kernel of its own.  src/repro/ml/mamba.py computes
// exp(dt*A), (dt*x)*B and y = sum_n h*C as plain jnp passes around the
// Pallas ssm_scan (src/repro/kernels/ssm_scan.py, _scan_kernel), a chunk
// at a time; ssm_scan.cu is that kernel's port.  This kernel takes the
// passes and the scan into one launch, so the float32 [B, L, dI*N] arrays
// they hand each other (dA, bx, h) never reach device memory.
//
// Bound: operations.  A state element costs one exp and four float32
// multiplies or multiply-adds a step; the bytes are dt and x (2 bytes
// each in bf16), y (4) a channel and step, and B, C a step (shared by
// every channel).  At N = 16 that is 16 exps against 8 bytes a channel
// and step, far above the card's ratio of exps (SFU) to bytes.
//
// Design: each thread owns one (batch, channel) and keeps its N states
// (with N/LANES states each, a group of LANES neighbouring lanes shares
// one channel, reducing y with shuffles) and its row of A in registers,
// walking time in order.  Neighbour threads take neighbour channels, so
// the loads of dt and x and the stores of y are coalesced; each step's
// dt and x are loaded one step ahead.  B_t and C_t are the same for every
// channel of a batch row: the block copies them for a tile of steps with
// cp.async into shared memory while it computes the previous tile, widens
// them to float32 once, and every thread reads them as broadcasts.  The
// association order is the unfused chain's: dt*A into an accurate expf,
// (dt*x) first and then *B, a*h + bx as one fused multiply-add, y as a
// sum over the thread's states and then over the lanes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// B (and C) values a tile: kTileElems / N steps
constexpr int kTileElems = 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Copy n elements (n * sizeof(T) a multiple of 4, src 4-byte aligned) into
// shared memory as 4-byte cp.async copies spread over the block.
template <typename T>
__device__ __forceinline__ void stage(uint32_t* dst, const T* src, int n) {
  const int words = n * static_cast<int>(sizeof(T)) / 4;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const unsigned addr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + w));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
                 "l"(s + w));
  }
}

template <typename T, int N, int LANES>
__global__ void __launch_bounds__(kThreads, 4)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT,
                          int L, int D) {
  constexpr int kStates = N / LANES;       // states a thread keeps
  constexpr int kTile = kTileElems / N;    // steps a tile
  constexpr int kChannels = kThreads / LANES;
  __shared__ __align__(16) uint32_t raw[2][kTileElems];
  __shared__ __align__(16) float sb[kTileElems];
  __shared__ __align__(16) float sc[kTileElems];

  const int per_row = (D + kChannels - 1) / kChannels;
  const int b = blockIdx.x / per_row;
  const int chan = (blockIdx.x - b * per_row) * kChannels +
                   static_cast<int>(threadIdx.x) / LANES;
  const int q = static_cast<int>(threadIdx.x) % LANES;
  // a ragged last block's spare lanes run on the last channel and store
  // nothing, so that every lane of a warp takes part in the shuffles
  const bool live = chan < D;
  const int d = live ? chan : D - 1;
  const int n0 = q * kStates;

  float a[kStates], h[kStates];
  const size_t state = (static_cast<size_t>(b) * D + d) * N + n0;
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a[i] = A[static_cast<size_t>(d) * N + n0 + i];
    h[i] = h0 ? h0[state + i] : 0.f;
  }
  const T* brow = bm + static_cast<size_t>(b) * L * N;
  const T* crow = cm + static_cast<size_t>(b) * L * N;
  stage(raw[0], brow, min(kTile, L) * N);
  stage(raw[1], crow, min(kTile, L) * N);
  asm volatile("cp.async.commit_group;\n" ::);

  size_t g = static_cast<size_t>(b) * L * D + d;   // (b, t, d) at t = 0
  float dn = widen(dt[g]), xn = widen(x[g]);
  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int steps = min(kTile, L - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the tile has landed; the last one is read out
    const T* rb = reinterpret_cast<const T*>(raw[0]);
    const T* rc = reinterpret_cast<const T*>(raw[1]);
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sb[i] = widen(rb[i]);
      sc[i] = widen(rc[i]);
    }
    __syncthreads();   // sb, sc hold the tile; raw is free
    if (t0 + kTile < L) {
      const int next = min(kTile, L - t0 - kTile) * N;
      stage(raw[0], brow + static_cast<size_t>(t0 + kTile) * N, next);
      stage(raw[1], crow + static_cast<size_t>(t0 + kTile) * N, next);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int s = 0; s < steps; ++s) {
      const float dv = dn, xv = xn;
      if (t0 + s + 1 < L) {
        dn = widen(dt[g + D]);
        xn = widen(x[g + D]);
      }
      const float dx = dv * xv;
      const float* bt = sb + s * N + n0;
      const float* ct = sc + s * N + n0;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        h[i] = fmaf(expf(dv * a[i]), h[i], dx * bt[i]);
        acc = fmaf(h[i], ct[i], acc);
      }
#pragma unroll
      for (int m = LANES / 2; m > 0; m >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (live && q == 0) y[g] = acc;
      g += D;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kStates; ++i) hT[state + i] = h[i];
  }
}

struct Args {
  const void *dt, *x, *bm, *cm, *A, *h0;
  void *y, *hT;
  int B, L, D;
};

template <typename T, int N, int LANES>
void run(const Args& p, cudaStream_t st) {
  const int channels = kThreads / LANES;
  const long long blocks =
      static_cast<long long>(p.B) * ((p.D + channels - 1) / channels);
  selective_scan_kernel<T, N, LANES>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<const T*>(p.dt), static_cast<const T*>(p.x),
          static_cast<const T*>(p.bm), static_cast<const T*>(p.cm),
          static_cast<const float*>(p.A), static_cast<const float*>(p.h0),
          static_cast<float*>(p.y), static_cast<float*>(p.hT), p.L, p.D);
}

template <typename T, int N>
bool run_lanes(const Args& p, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1: run<T, N, 1>(p, st); return true;
    case 2: run<T, N, 2>(p, st); return true;
    case 4: run<T, N, 4>(p, st); return true;
    default: return false;
  }
}

template <typename T>
bool run_states(const Args& p, int N, int lanes, cudaStream_t st) {
  switch (N) {
    case 4: return run_lanes<T, 4>(p, lanes, st);
    case 16: return run_lanes<T, 16>(p, lanes, st);
    default: return false;
  }
}

}  // namespace

REPRO_STRERROR

// dt, x [B, L, D] and bm, cm [B, L, N] of one type (bf16 when bf16 != 0,
// else float32), A [D, N] and h0 [B, D, N] (or null: zeros) float32, all
// contiguous, bm and cm 4-byte aligned; N 4 or 16 (the reduced and the
// published Mamba state), lanes 1, 2 or 4, B, L, D > 0 -> y [B, L, D], hT [B, D, N] float32 (hT the state
// after step L-1).
REPRO_EXPORT int repro_selective_scan(const void* dt, const void* x,
                                      const void* bm, const void* cm,
                                      const void* A, const void* h0, void* y,
                                      void* hT, int B, int L, int D, int N,
                                      int lanes, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || D <= 0 || lanes > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{dt, x, bm, cm, A, h0, y, hT, B, L, D};
  const bool ok = bf16 ? run_states<__nv_bfloat16>(p, N, lanes, st)
                       : run_states<float>(p, N, lanes, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
