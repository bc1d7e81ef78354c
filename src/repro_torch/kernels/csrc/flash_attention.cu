// Forward flash attention: online-softmax GQA attention with the causal
// mask at a decode offset, a sliding window and tanh soft-capping.  Three
// kernels; the wrapper (kernels/flash_attention.py, `kernel_for`) picks
// the tensor cores or SIMT from the dtype and the head dim alone, and the
// tensor-core entry picks its kernel from the head dim.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention (the TPU kernel runs a (B*Hq, Sq/bq, Skv/bk) grid with
// the KV axis sequential ("arbitrary") and carries the running max m, the
// denominator l and the accumulator acc in VMEM scratch across it).
//
// Bound: operations at the LM's prefill shapes (4*D flops per unmasked
// (query, key) pair against 2*D bytes a key row; hundreds of pairs a key
// at S = 512), bytes for short or single-token queries.
//
// Every kernel: one block per (b*Hq + h, query tile).  The sequential
// KV grid axis becomes a loop over 64-key tiles inside the block, with m,
// l and the output accumulator in registers in float32.  The loop runs
// only over the tiles that the causal mask and the window leave partly
// open (the TPU kernel's `needed` skip, as loop bounds).  A masked entry
// gets p = 0 and no share of the max, so a row that is fully masked in
// one tile adds nothing (the TPU kernel adds exp(0) junk there that a
// later tile's correction wipes out), and a row masked everywhere comes
// out 0, as the TPU kernel's l = 0 guard gives.  The KV head of query
// head h is h / (Hq / Hkv), as the TPU index map.
//
// flash_tc_kernel (bfloat16, head dims 64 and 128): Hopper's tensor cores,
// 64-query tiles.
//   * One consumer warpgroup (128 threads) owns the 64 query rows; warp w
//     holds rows 16w..16w+15 of every accumulator fragment.
//   * Copies: TMA.  Q, K and V are 3-D tensor maps ([B*H, S, D], box 64
//     rows x 64 bf16 = 128 bytes, SWIZZLE_128B, so hd 128 takes two boxes
//     a tile); rows past S arrive as zeros.  Q stays in shared memory for
//     the whole loop; K and V tiles arrive in a ring of 2 stages, each
//     with an mbarrier, and thread 0 issues tile t+1's copies before the
//     block waits for tile t, so the copy overlaps tile t's products.
//   * S = Q K^T: wgmma.m64n64k16 bf16 -> fp32, both operands K-major
//     from shared memory through 128B-swizzle descriptors (D/16 steps;
//     a step inside a 128-byte box moves the start address 32 bytes).
//   * Softmax on the fp32 accumulator fragments: scale (and tanh softcap,
//     before the mask) with log2(e) folded in, exp2; each thread holds 2
//     rows, whose max and sum go over the row's quad of 4 threads.  The
//     mask is evaluated only on tiles that cross a boundary (Skv, the
//     causal diagonal, the window's start).
//   * O += P V: P is rounded to bf16 in registers, where the S fragment
//     already has the layout of wgmma's register A operand; V [keys, D]
//     is B, MN-major (transposed) through its descriptor, one m64n64k16
//     a 16-key step and 64-dim box.  O stays fp32 in registers; the
//     epilogue scales by 1/l (0 where l = 0) and writes bf16.
//
// flash_wide_kernel (bfloat16, head dim 256): the same products and
// softmax in 128-row blocks.  At hd 256 one warpgroup holds a 64 x 256
// fp32 accumulator (128 registers a thread) and a 64-row block 160 KB of
// tiles, one block an SM with nothing to hide its softmax behind (the
// SIMT kernel ran 42x its operations bound there); so:
//   * A block owns 128 query rows: two warpgroups of 64 rows each share
//     every K/V tile (half the K/V reads a query of 64-row blocks), and
//     while one runs its softmax the other's products use the tensor
//     cores.
//   * Shared memory: Q 128 x 256 bf16 (64 KB) for the whole loop; K and V
//     64 x 256 each (64 KB a stage) in a ring of two stages, each with a
//     full barrier (the copies' bytes) and an empty one (one arrival a
//     warp); 193 KB in all.  Thread 0 issues tile t+1's copies into the
//     stage tile t-1 held once every warp has released it, then waits for
//     tile t, so one tile of slack lies between the warpgroups.
//   * Both warpgroups take every key tile of the block's bounds (the
//     causal and window skip at tile granularity, as flash_tc_kernel);
//     the mask on a tile that crosses a boundary of their own rows.
//   * Grid (B*Hq, ceil(Sq/128)) with the query tile reversed along y, so
//     that under the causal mask the longest tiles of every head start
//     first.
//   * 256 threads leave ptxas 255 registers a thread (it takes ~200).
//     Measured against it (tools/flash_ab.py, PERF.md): a producer warp
//     with setmaxnreg 24/240 (a launch budget of 168 registers: ptxas
//     then waits after every wgmma, C7512, and spills), a warpgroup
//     skipping the tiles none of its rows sees (the products serialised
//     again), one m64n256k16 a 16-key step for P V, and an S-product
//     ping-pong over named barriers: each slower.
//
// flash_simt_kernel (float32 at every head dim, and bf16 at head dims 16
// and 32): SIMT fp32 products.  256 threads; Q, K and V tiles are
// converted to float32 in shared memory (Q and K rows padded by one word,
// so the strided row reads hit distinct banks).  A 16x16 thread grid owns
// rows ty + 16i and key columns tx + 16j (i, j < 4) of the 64x64 logit
// tile — a 4x4 register tile — and, for the output, the same rows and
// dims tx + 16k.  Row max and sum reduce over the 16 lanes of a half-warp
// with shuffles.  It keeps float32 inputs in float32 (TF32 tensor cores
// would round the products to 10 mantissa bits).
#include <cuda.h>      // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <dlfcn.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kMaskedMax = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int Hq,
                      int Hkv, int Sq, int Skv, int causal, int window,
                      float scale, float softcap) {
  constexpr int DK = D / 16;           // output dims a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kvh = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int off = Skv - Sq;            // queries sit at the end of the KV
  const T* qb = q + (static_cast<size_t>(bh) * Sq) * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + kvh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + kvh) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = q0 + r < Sq
        ? to_f32(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }

  // the key tiles some row of this query tile can see
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, Sq) - 1 + off;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q_first - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  float m[4], l[4], acc[4][DK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskedMax;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) acc[i][kk] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                   // the last tile's Ks/Vs/Ps are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < Skv;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + off;   // absolute query position
      bool ok[4];
      float mx = kMaskedMax;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[j] = kp < Skv && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        s[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) acc[i][kk] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float vv = Vs[c * D + tx + 16 * kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][kk] = fmaf(pa[i], vv, acc[i][kk]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + (static_cast<size_t>(bh) * Sq + r) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) from_f32(acc[i][kk] * inv, &orow[tx + 16 * kk]);
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                        int causal, int window, float scale, float softcap,
                        cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_simt_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_simt<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                window, scale, softcap, st);
    case 32:
      return launch_simt<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                window, scale, softcap, st);
    case 64:
      return launch_simt<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                window, scale, softcap, st);
    case 128:
      return launch_simt<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, softcap, st);
    case 256:
      return launch_simt<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- tensor cores

constexpr int kTcThreads = 128;        // one warpgroup
constexpr int kBox = 64;               // bf16 columns of one 128-byte box
constexpr int kBoxElems = 64 * kBox;   // a 64-row box: 8 KB
constexpr int kStages = 2;             // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, then K and V per stage, D / 64 boxes each; 3 mbarriers; 1 KB to
  // align the boxes to the 128B swizzle's 1024-byte period
  return 1024 + sizeof(__nv_bfloat16) * kBoxElems * (D / kBox) *
                    (1 + 2 * kStages) + sizeof(uint64_t) * (1 + kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// A barrier that completes a phase after `count` arrivals (and the bytes
// announced by expect_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar,
                                          uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the barrier's phase `parity` to complete.  A copy that never
// lands traps (a launch error the wrapper raises) instead of hanging the
// card: 2^26 polls take seconds, against microseconds a tile.
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

// One 64 x 64 box of a [B*H, S, D] map at (d0, row0, bh) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int d0, int row0,
                                        int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(row0), "r"(bh),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A K-major operand (rows of 128 bytes, 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t k_major(const __nv_bfloat16* p) {
  return sw128_desc(p, 16, 1024);
}

// An MN-major (transposed) operand: 64 contiguous MN values a 128-byte
// row, one row a K index, 8-row groups 1024 bytes apart along K.
__device__ __forceinline__ uint64_t mn_major(const __nv_bfloat16* p) {
  return sw128_desc(p, kBoxElems * 2, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A (4 registers of bf16 pairs) from registers, B
// from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The hardware tanh (relative error about 2^-11): the soft-cap multiplies
// it by the cap, so a logit moves by about 2^-11 of itself, under the
// bf16 rounding of P that follows.  tanhf's software sequence made the
// softmax the larger part of a tile at hd 256 (Gemma 3, the one config
// with a soft-cap).
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Online softmax of one 64 x 64 logit tile held as this thread's S
// fragment: fragment entry i sits in row `g + 8 * ((i >> 1) & 1)` of the
// warp's 16 and key column `8 * (i >> 2) + 2 * tig + (i & 1)`.  Turns s
// into p (in place), rescales l and m, and returns each row's correction
// of the old accumulator.
template <bool kMask>
__device__ __forceinline__ void tile_softmax(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const int (&qp)[2], int k0,
                                             int tig, int Skv, int causal,
                                             int window, float scale_log2,
                                             float softcap_log2,
                                             float scale_over_cap) {
  float mx[2] = {kMaskedMax, kMaskedMax};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = softcap_log2 > 0.f
                  ? softcap_log2 * fast_tanh(s[i] * scale_over_cap)
                  : s[i] * scale_log2;
    if (kMask) {
      const int kp = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
      const bool ok = kp < Skv && (!causal || kp <= qp[r]) &&
                      (window <= 0 || kp > qp[r] - window);
      if (!ok) x = __int_as_float(0xff800000);   // -inf
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);   // finite: m starts at -1e30
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - m[r]);          // masked: exp2(-inf) = 0
    sum[r] += s[i];
  }
  // l is this thread's share of the row sum; the quad adds them at the end
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_kernel(__grid_constant__ const CUtensorMap qmap,
                    __grid_constant__ const CUtensorMap kmap,
                    __grid_constant__ const CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                    int Skv, int causal, int window, float scale_log2,
                    float softcap_log2, float scale_over_cap) {
  constexpr int NB = D / kBox;         // 128-byte boxes across the head dim
  constexpr int kTileElems = NB * kBoxElems;
  constexpr uint32_t kKvBytes = 2 * kTileElems * sizeof(__nv_bfloat16);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));
  __nv_bfloat16* ks = qs + kTileElems;                // [kStages][NB][box]
  __nv_bfloat16* vs = ks + kStages * kTileElems;      // [kStages][NB][box]
  auto* bars = reinterpret_cast<uint64_t*>(vs + kStages * kTileElems);
  uint64_t* q_bar = bars;
  uint64_t* kv_bar = bars + 1;                        // [kStages]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;             // the thread's rows: g and g + 8
  const int tig = lane & 3;            // its place in the row's quad
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int kv_bh = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int off = Skv - Sq;            // queries sit at the end of the KV

  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, Sq) - 1 + off;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q_first - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  const CUtensorMap* kmap_p = &kmap;
  const CUtensorMap* vmap_p = &vmap;
  auto load_kv = [&](int t, int stage) {
    mbar_expect_tx(&kv_bar[stage], kKvBytes);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_box(ks + stage * kTileElems + nb * kBoxElems, kmap_p,
              &kv_bar[stage], nb * kBox, t * kBK, kv_bh);
      tma_box(vs + stage * kTileElems + nb * kBoxElems, vmap_p,
              &kv_bar[stage], nb * kBox, t * kBK, kv_bh);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar);
    for (int st = 0; st < kStages; ++st) mbar_init(&kv_bar[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && t_lo <= t_hi) {
    mbar_expect_tx(q_bar, kTileElems * sizeof(__nv_bfloat16));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_box(qs + nb * kBoxElems, &qmap, q_bar, nb * kBox, q0, bh);
    load_kv(t_lo, 0);
  }

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float m[2] = {kMaskedMax, kMaskedMax};
  float l[2] = {0.f, 0.f};
  const int qp[2] = {q0 + 16 * warp + g + off, q0 + 16 * warp + g + 8 + off};
  if (t_lo <= t_hi) mbar_wait(q_bar, 0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo;
    const int stage = i & 1;
    if (tid == 0 && t < t_hi) load_kv(t + 1, stage ^ 1);
    mbar_wait(&kv_bar[stage], (i >> 1) & 1);
    const __nv_bfloat16* kt = ks + stage * kTileElems;
    const __nv_bfloat16* vt = vs + stage * kTileElems;

    float s[32];
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) s[i2] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int e = (kk >> 2) * kBoxElems + (kk & 3) * 16;
      wgmma_ss(s, k_major(qs + e), k_major(kt + e), kk > 0);
    }
    wgmma_commit_wait();

    const int k0 = t * kBK;
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q_first) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 + off - window);
    float corr[2];
    if (edge)
      tile_softmax<true>(s, m, l, corr, qp, k0, tig, Skv, causal, window,
                         scale_log2, softcap_log2, scale_over_cap);
    else
      tile_softmax<false>(s, m, l, corr, qp, k0, tig, Skv, causal, window,
                          scale_log2, softcap_log2, scale_over_cap);

    // P as wgmma's A fragments, one per 16-key step: entries 8kk..8kk+7
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) acc[nb][i2] *= corr[(i2 >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs_tb(acc[nb], pa[kk], mn_major(vt + nb * kBoxElems +
                                              kk * 16 * kBox));
    wgmma_commit_wait();
    __syncthreads();                   // every warp is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * kBox + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[nb][4 * j + 2 * r] * inv[r],
                      acc[nb][4 * j + 2 * r + 1] * inv[r]);
      }
  }
}

// ------------------------------------------------- 128-row blocks (hd 256)

constexpr int kWideGroups = 2;                   // 64-row warpgroups a block
constexpr int kWideBQ = 64 * kWideGroups;        // query rows a block
constexpr int kWideThreads = 128 * kWideGroups;

constexpr int kWideD = 256;                      // its one head dim

constexpr size_t wide_smem_bytes() {
  // Q (one tile a warpgroup), then K and V per stage, D / 64 boxes a
  // tile; the q barrier and a full and an empty barrier a stage; 1 KB to
  // align the boxes to the 128B swizzle's 1024-byte period
  return 1024 + sizeof(__nv_bfloat16) * kBoxElems * (kWideD / kBox) *
                    (kWideGroups + 2 * kStages) +
         sizeof(uint64_t) * (1 + 2 * kStages);
}

__global__ void __launch_bounds__(kWideThreads, 1)
    flash_wide_kernel(__grid_constant__ const CUtensorMap qmap,
                      __grid_constant__ const CUtensorMap kmap,
                      __grid_constant__ const CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                      int Sq, int Skv, int causal, int window,
                      float scale_log2, float softcap_log2,
                      float scale_over_cap) {
  constexpr int D = kWideD;
  constexpr int NB = D / kBox;
  constexpr int kTileElems = NB * kBoxElems;   // 64 rows x D
  constexpr uint32_t kKvBytes = 2 * kTileElems * sizeof(__nv_bfloat16);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));   // [kWideGroups][tile]
  __nv_bfloat16* ks = qs + kWideGroups * kTileElems;   // [kStages][tile]
  __nv_bfloat16* vs = ks + kStages * kTileElems;       // [kStages][tile]
  auto* bars = reinterpret_cast<uint64_t*>(vs + kStages * kTileElems);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;                           // [kStages]
  uint64_t* empty = full + kStages;                    // [kStages]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;             // the thread's rows: g and g + 8
  const int tig = lane & 3;            // its place in the row's quad
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kv_bh = b * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWideBQ;   // longest first
  const int off = Skv - Sq;            // queries sit at the end of the KV
  const int r0 = q0 + 64 * wg;         // this warpgroup's first row

  // the key tiles some row of the block can see (both warpgroups take
  // every one: a tile skipped by one warpgroup alone makes ptxas
  // serialise the products)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kWideBQ, Sq) - 1 + off;
  int k_lo = 0;
  int k_hi = Skv - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q_first - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi >= k_lo ? k_hi / kBK : t_lo - 1;

  auto load_kv = [&](int t, int stage) {
    mbar_expect_tx(&full[stage], kKvBytes);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_box(ks + stage * kTileElems + nb * kBoxElems, &kmap,
              &full[stage], nb * kBox, t * kBK, kv_bh);
      tma_box(vs + stage * kTileElems + nb * kBoxElems, &vmap,
              &full[stage], nb * kBox, t * kBK, kv_bh);
    }
  };

  if (tid == 0) {
    mbar_init(q_bar);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st]);
      mbar_init(&empty[st], 4 * kWideGroups);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && t_lo <= t_hi) {
    mbar_expect_tx(q_bar, kWideGroups * kTileElems * 2);
    for (int c = 0; c < kWideGroups; ++c)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_box(qs + c * kTileElems + nb * kBoxElems, &qmap, q_bar,
                nb * kBox, q0 + 64 * c, bh);
    load_kv(t_lo, 0);
  }

  const __nv_bfloat16* qw = qs + wg * kTileElems;
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float m[2] = {kMaskedMax, kMaskedMax};
  float l[2] = {0.f, 0.f};
  const int qp[2] = {r0 + 16 * warp + g + off, r0 + 16 * warp + g + 8 + off};
  if (t_lo <= t_hi) mbar_wait(q_bar, 0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo;
    const int stage = i % kStages;
    if (tid == 0 && t < t_hi) {
      // the next tile goes where tile t - 1 was: both warpgroups are done
      // with it (each warp arrives on its empty barrier)
      if (i >= 1) mbar_wait(&empty[stage ^ 1], ((i - 1) / kStages) & 1);
      load_kv(t + 1, stage ^ 1);
    }
    mbar_wait(&full[stage], (i / kStages) & 1);
    const __nv_bfloat16* kt = ks + stage * kTileElems;
    const __nv_bfloat16* vt = vs + stage * kTileElems;

    float s[32];
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) s[i2] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int e = (kk >> 2) * kBoxElems + (kk & 3) * 16;
      wgmma_ss(s, k_major(qw + e), k_major(kt + e), kk > 0);
    }
    wgmma_commit_wait();

    const int k0 = t * kBK;
    const bool edge = k0 + kBK > Skv ||
                      (causal && k0 + kBK - 1 > r0 + off) ||
                      (window > 0 && k0 <= r0 + 63 + off - window);
    float corr[2];
    if (edge)
      tile_softmax<true>(s, m, l, corr, qp, k0, tig, Skv, causal, window,
                         scale_log2, softcap_log2, scale_over_cap);
    else
      tile_softmax<false>(s, m, l, corr, qp, k0, tig, Skv, causal, window,
                          scale_log2, softcap_log2, scale_over_cap);

    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) acc[nb][i2] *= corr[(i2 >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs_tb(acc[nb], pa[kk],
                    mn_major(vt + nb * kBoxElems + kk * 16 * kBox));
    wgmma_commit_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);   // the warp is done
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * kBox + 8 * j + 2 * tig;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[nb][4 * j + 2 * r] * inv[r],
                      acc[nb][4 * j + 2 * r + 1] * inv[r]);
      }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// The driver's cuTensorMapEncodeTiled, looked up once (the library links
// only the CUDA runtime).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The [rows, S, D] bf16 tensor at `ptr` as 64 x 64 boxes, 128B-swizzled.
bool box_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
             int rows, int S, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kBox, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                      int window, float scale, float softcap,
                      cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (!box_map(encode, &qmap, q, B * Hq, Sq, D) ||
      !box_map(encode, &kmap, k, B * Hkv, Skv, D) ||
      !box_map(encode, &vmap, v, B * Hkv, Skv, D))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kern = flash_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kTcThreads, smem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv,
      causal, window, scale * kLog2e,
      softcap > 0.f ? softcap * kLog2e : 0.f,
      softcap > 0.f ? scale / softcap : 0.f);
  return cudaGetLastError();
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                        int window, float scale, float softcap,
                        cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (!box_map(encode, &qmap, q, B * Hq, Sq, kWideD) ||
      !box_map(encode, &kmap, k, B * Hkv, Skv, kWideD) ||
      !box_map(encode, &vmap, v, B * Hkv, Skv, kWideD))
    return cudaErrorInvalidValue;
  constexpr size_t smem = wide_smem_bytes();
  auto kern = flash_wide_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kWideBQ - 1) / kWideBQ);
  kern<<<grid, kWideThreads, smem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv,
      causal, window, scale * kLog2e,
      softcap > 0.f ? softcap * kLog2e : 0.f,
      softcap > 0.f ? scale / softcap : 0.f);
  return cudaGetLastError();
}

}  // namespace

REPRO_STRERROR

// q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (float32 when bf16 == 0, bfloat16
// otherwise), all contiguous -> o [B, Hq, Sq, D] in the same type, by the
// SIMT kernel.  window <= 0: no window; softcap <= 0: no soft-capping.
REPRO_EXPORT int repro_flash_attention_simt(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Hq, int Hkv, int Sq, int Skv,
                                            int D, int causal, int window,
                                            int bf16, float scale,
                                            float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                       causal, window, scale, softcap, st)
           : dispatch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal,
                               window, scale, softcap, st);
  return static_cast<int>(err);
}

// The same on the tensor cores: bfloat16 only, D 64 or 128
// (flash_tc_kernel) or 256 (flash_wide_kernel), every pointer 16-byte
// aligned (TMA).
REPRO_EXPORT int repro_flash_attention_tc(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Skv,
                                          int D, int causal, int window,
                                          float scale, float softcap,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Skv <= 0)                          // no key: every row is 0
    return static_cast<int>(repro_memset(
        o, 0, static_cast<size_t>(B) * Hq * Sq * D * 2, st));
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_tc<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                          scale, softcap, st);
      break;
    case 128:
      err = launch_tc<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                           scale, softcap, st);
      break;
    case 256:
      err = launch_wide(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window,
                        scale, softcap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
