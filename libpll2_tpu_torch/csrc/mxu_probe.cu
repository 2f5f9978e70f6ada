// The matrix-unit rate probe: repeated small dense products, to measure what
// one contraction engine of the card sustains.
//
// Replaces the TPU kernel tools/mxu_probe.py:34 `kern` (reached through
// `make`/`run`), which timed the TPU's matrix unit. Called through
// libpll2_tpu_torch/tools/mxu_probe.py:probe, which also holds the plain
// PyTorch version (probe_reference) that this must agree with.
//
// What it computes. A [nmat * m, k] and X [k, tiles * t], both float32; for
// column tile j (one block each) and every column c of it,
//   out[:, c] = sum over i < iters of A[(i mod nmat) * m : +m, :] @ X[:, c]
// accumulated in float32. Three modes:
//   0 'f32'   -- CUDA-core float32 FMAs;
//   1 'bf16'  -- the tensor cores (wgmma) on A and X rounded to bf16 (to
//                nearest, ties to even, as astype(bfloat16) and
//                .to(torch.bfloat16)), float32 accumulation;
//   2 'split' -- three bf16 passes, hi.hi + hi.lo + lo.hi, with lo the bf16
//                rounding of x - hi: float32-class products from the bf16
//                tensor cores.
// The sum runs slice by slice (every i with i mod nmat == j, one after
// another, in k chunks of a ring stage), which reorders the float32
// additions of the plain version's loop over i; the products are the same.
//
// What bounds it on an H100: operations, by design (2 m k t FLOP a product
// against nothing read per product from device memory), at about 1070
// TFLOP/s in bf16 and 67 TFLOP/s in float32 (132 SMs at 1980 MHz). The
// design keeps both operands out of the way of the contraction engine:
//   - One block a column tile (8 tiles: 8 SMs; 264: the whole card), 8
//     consumer warps and one producer warp. The producer's lane 0 streams
//     A's slices, pre-laid by `pack` (a kernel of this file, its own entry
//     pll_mxu_probe_pack, launched by the wrapper just before the probe) in
//     the shared-memory layout the consumers read, through a ring of
//     stages: one bulk copy (cp.async.bulk) a stage, counted on the
//     stage's full mbarrier; each consumer warp arrives on its empty
//     mbarrier when done with it. Slice j is streamed once per pass and
//     used reps(j) times from shared memory.
//   - 'bf16' and 'split' compute out^T = X^T A_slice^T with
//     wgmma.mma_async.m64nNk16 (wgmma.cuh): the 64 rows are 64 columns of X
//     (a row tile; a pass gives each of the two consumer warpgroups one),
//     N is m rounded up to 8 (20 -> 24, 80, 128), K is k rounded up to 16.
//     X's fragment (hi, and lo for 'split') is loaded once a pass into
//     registers, 4 a k step (the array holds 8 k steps up to k = 128, 16
//     above: two instantiations), and is wgmma's A operand in every
//     product; in 'split' above k = 128 the lo part lies in shared memory
//     instead (hi.lo's wgmma reads both operands there): hi, lo and the
//     accumulators would pass the 168 registers ptxas gives a thread of
//     288, and it serializes wgmmas it cannot keep in registers. A's
//     slice (hi, and lo) is B, K-major bf16 in 128-byte swizzled rows
//     (`sw128_byte`; a stage is one swizzle atom of 64 k values of all N
//     rows). The float32 accumulators (N / 2 registers a thread) live
//     across all iters products; the wgmmas of a stage chain back to back,
//     one commit group a stage, and a warp waits only for the stage before
//     (wait_group 1) before it releases that stage.
//   - 'f32': a thread holds an 8-row x 8-column register tile; a k step
//     reads 2 float4 of the slice (staged transposed, rows padded to 8) and
//     2 float4 of X (a pass's columns, staged once a pass, a thread's 8
//     columns 4 + 4 half a pass apart so that a warp's loads are
//     contiguous) for 64 FMAs, with no bound check. The pass width
//     (`cols`) and the slice's k chunk a stage come from the plan.
// ops/_kernels.py:probe_plan lays this out (N, K, chunks, stages, shared
// bytes); pll_mxu_probe recomputes the plan and refuses another.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kConsumers = 256;            // 8 warps: 2 warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kSmemMax = 232448;           // a block's shared memory on an H100
constexpr int kRowTile = 64;               // wgmma's rows: columns of X
constexpr int kAtom = 64;                  // bf16 k values of a 128-byte row
constexpr int kMaxKSteps = 16;             // k <= 256
constexpr int kMaxStages = 8;
constexpr int kAlign = 1024;               // the swizzle atom's alignment
constexpr int kF32Stages = 2;
constexpr unsigned kCopyBytes = 32768;     // a bulk copy's largest piece
constexpr int kRefused = -1;               // pll_mxu_probe: another plan

struct Args {
  const float* a;              // [nmat * m, k]
  const float* x;              // [k, tiles * t]
  float* out;                  // [m, tiles * t]
  unsigned char* packed;       // A's slices as the consumers read them
  int m, k, nmat, t, tiles, iters;
};

// ops/_kernels.py:probe_plan, field for field
struct Plan {
  int n;                  // 'bf16'/'split': wgmma's N; 'f32': rows padded to 8
  int k_pad;              // K padded: to 16 (wgmma) or 4 ('f32')
  int chunk, chunks;      // k values a stage, stages a slice
  int cols;               // columns a pass: 64 a warpgroup, or 'f32''s own
  int passes;             // a tile's passes
  int stages;             // the ring's
  int frag;               // 'bf16'/'split': k steps of X's fragment: 8 or 16
  long long stage_bytes, smem_bytes, slice_bytes;
  long long x_bytes;      // 'split' at frag 16: X's lo part in shared memory
};

inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

Plan make_plan(int m, int k, int t, int mode) {
  Plan p{};
  if (mode == 0) {
    p.n = round_up(m, 8);
    p.k_pad = round_up(k, 4);
    const int rgs = p.n / 8;
    int cg = kConsumers / rgs;
    if (cg > (t + 7) / 8) cg = (t + 7) / 8;
    const long long bars = 2LL * kF32Stages * 8;
    while (cg > 1 && 4LL * p.k_pad * 8 * cg + kF32Stages * 16LL * p.n + bars > kSmemMax) --cg;
    p.cols = 8 * cg;
    const long long room =
        (kSmemMax - 4LL * p.k_pad * p.cols - bars) / (kF32Stages * 4LL * p.n);
    p.chunk = 4;
    for (int d = 4; d <= p.k_pad && d <= room; d += 4)
      if (p.k_pad % d == 0) p.chunk = d;
    p.stages = kF32Stages;
    p.stage_bytes = 4LL * p.chunk * p.n;
    p.smem_bytes = 4LL * p.k_pad * p.cols + p.stages * p.stage_bytes + bars;
    p.passes = (t + p.cols - 1) / p.cols;
  } else {
    const int parts = mode == 2 ? 2 : 1;
    p.n = round_up(m, 8);
    p.k_pad = round_up(k, 16);
    p.chunk = kAtom;
    p.frag = p.k_pad <= 8 * 16 ? kMaxKSteps / 2 : kMaxKSteps;
    p.x_bytes = mode == 2 && p.frag == kMaxKSteps
                    ? 2LL * ((p.k_pad + kAtom - 1) / kAtom) * kRowTile * 128
                    : 0;
    p.stage_bytes = 128LL * p.n * parts;
    long long stages = (kSmemMax - kAlign - p.x_bytes - 16LL * kMaxStages) / p.stage_bytes;
    p.stages = static_cast<int>(stages < kMaxStages ? stages : kMaxStages);
    p.smem_bytes = kAlign + p.x_bytes + p.stages * p.stage_bytes + 16LL * p.stages;
    p.cols = kRowTile;
    p.passes = ((t + kRowTile - 1) / kRowTile + 1) / 2;
  }
  p.chunks = (p.k_pad + p.chunk - 1) / p.chunk;
  p.slice_bytes = p.chunks * p.stage_bytes;
  return p;
}

// the iterations i < iters with i mod nmat == j
__device__ __forceinline__ int reps(const Args& p, int j) {
  return p.iters / p.nmat + (j < p.iters % p.nmat ? 1 : 0);
}

__device__ __forceinline__ uint16_t bf16_rne(float v) {
  const uint32_t u = __float_as_uint(v);
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// ---------------------------------------------------------------------------
// A's slices as the consumers read them, one thread an element, zero past m
// and k. 'bf16'/'split': slice j, stage c: the hi part, then (for 'split')
// the lo part, each the N x 64 block of k values 64 c .. 64 c + 63 as
// sw128_byte lays it out. 'f32': slice j transposed, k_pad x n floats.
__global__ void pack(Args p, Plan pl, int mode) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == 0) {
    const long long per = (long long)pl.k_pad * pl.n;
    if (i >= per * p.nmat) return;
    const int j = static_cast<int>(i / per), kk = static_cast<int>(i % per / pl.n);
    const int r = static_cast<int>(i % pl.n);
    reinterpret_cast<float*>(p.packed)[i] =
        r < p.m && kk < p.k ? __ldg(p.a + ((size_t)j * p.m + r) * p.k + kk) : 0.0f;
    return;
  }
  const int parts = mode == 2 ? 2 : 1;
  const long long atom = (long long)kAtom * pl.n;   // elements of a stage's part
  if (i >= atom * pl.chunks * p.nmat) return;
  const int j = static_cast<int>(i / (atom * pl.chunks));
  const int c = static_cast<int>(i / atom % pl.chunks);
  const int r = static_cast<int>(i % atom / kAtom), kk = static_cast<int>(i % kAtom);
  const float v = r < p.m && c * kAtom + kk < p.k
                      ? __ldg(p.a + ((size_t)j * p.m + r) * p.k + c * kAtom + kk)
                      : 0.0f;
  const uint16_t h = bf16_rne(v);
  unsigned char* const stage = p.packed + ((long long)j * pl.chunks + c) * pl.stage_bytes;
  const int at = sw128_byte(r, kk, pl.n);
  *reinterpret_cast<uint16_t*>(stage + at) = h;
  if (parts == 2) {
    *reinterpret_cast<uint16_t*>(stage + kAtom * 2 * pl.n + at) = bf16_rne(v - bf16_value(h));
  }
}

// ---------------------------------------------------------------------------
// The ring.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival on `bar`, and `bytes` more to land on it by bulk copies
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of `bar` with this parity has completed; a wait of 10 s
// (a lost arrival) traps, and the launch fails, instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ULL) __trap();
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory,
// counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer (one lane): stage n of the stream (a pass, a slice j with
// reps(j) > 0, a chunk c) into ring entry n % stages once every consumer
// warp is done with the entry's previous use.
__device__ void produce(const Args& p, const Plan& pl, unsigned char* ring,
                        unsigned long long* full, unsigned long long* empty) {
  int n = 0;
  for (int pass = 0; pass < pl.passes; ++pass) {
    for (int j = 0; j < p.nmat; ++j) {
      if (reps(p, j) == 0) continue;
      for (int c = 0; c < pl.chunks; ++c, ++n) {
        const int s = n % pl.stages;
        mbar_wait(empty + s, ((n / pl.stages) & 1) ^ 1);
        const unsigned bytes = static_cast<unsigned>(pl.stage_bytes);
        mbar_arrive_tx(full + s, bytes);
        const unsigned char* src = p.packed + ((long long)j * pl.chunks + c) * pl.stage_bytes;
        unsigned char* dst = ring + s * pl.stage_bytes;
        for (unsigned o = 0; o < bytes; o += kCopyBytes) {
          bulk_copy(dst + o, src + o, bytes - o < kCopyBytes ? bytes - o : kCopyBytes,
                    full + s);
        }
      }
    }
  }
}

// a consumer warp is done with ring entry s
__device__ __forceinline__ void release(unsigned long long* empty, int s) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// 'f32': consumer thread (rg, cg) = (tid / (cols / 8), tid % (cols / 8)) owns
// rows 8 rg .. 8 rg + 7 and columns 4 cg + e, cols / 2 + 4 cg + e (e < 4) of
// a pass; threads past the rows idle.
__global__ void __launch_bounds__(kThreads, 1) probe_f32(Args p, Plan pl) {
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);               // [k_pad][cols]
  unsigned char* const ring = reinterpret_cast<unsigned char*>(xs + pl.k_pad * pl.cols);
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(ring + pl.stages * pl.stage_bytes);
  unsigned long long* const empty = full + pl.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(p, pl, ring, full, empty);
    return;
  }
  const int tid = threadIdx.x;
  const int cgs = pl.cols / 8;
  const int rg = tid / cgs, cg = tid % cgs;
  const bool active = rg < pl.n / 8;
  const size_t W = (size_t)p.t * p.tiles;
  const size_t col0 = (size_t)blockIdx.x * p.t;
  const int n4 = pl.n / 4, c4 = pl.cols / 4;
  int n = 0;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int cb = pass * pl.cols;
    consumers_sync();  // the previous pass is done with xs
    for (int q = tid; q < pl.k_pad * pl.cols; q += kConsumers) {
      const int kk = q / pl.cols, c = cb + q % pl.cols;
      xs[q] = kk < p.k && c < p.t ? __ldg(p.x + (size_t)kk * W + col0 + c) : 0.0f;
    }
    consumers_sync();
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
    }
    for (int j = 0; j < p.nmat; ++j) {
      const int r = reps(p, j);
      if (r == 0) continue;
      for (int c = 0; c < pl.chunks; ++c, ++n) {
        const int s = n % pl.stages;
        mbar_wait(full + s, (n / pl.stages) & 1);
        if (active) {
          const float4* as = reinterpret_cast<const float4*>(ring + s * pl.stage_bytes) + 2 * rg;
          const float4* xv = reinterpret_cast<const float4*>(xs + c * pl.chunk * pl.cols) + cg;
          for (int it = 0; it < r; ++it) {
#pragma unroll 4
            for (int kk = 0; kk < pl.chunk; ++kk) {
              const float4 a0 = as[kk * n4], a1 = as[kk * n4 + 1];
              const float4 x0 = xv[kk * c4], x1 = xv[kk * c4 + cgs];
              const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
              const float xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
              for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], xw[e], acc[i][e]);
              }
            }
          }
        }
        release(empty, s);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * rg + i;
      if (row >= p.m) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = cb + (e < 4 ? 4 * cg + e : pl.cols / 2 + 4 * cg + e - 4);
        if (c < p.t) p.out[(size_t)row * W + col0 + c] = acc[i][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 'bf16' and 'split': warpgroup g of the block takes row tile 2 pass + g
// (64 columns of the tile) in each pass; a warpgroup past the tile's row
// tiles only keeps step with the ring.
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// this warpgroup's named barrier (0: __syncthreads, 1: the consumers)
__device__ __forceinline__ void warpgroup_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}

// KS: the k steps X's fragment holds (8: k <= 128, 16: k <= 256). In
// 'split' at KS 16 the fragment's lo part would not fit beside the hi part
// and the accumulators (the wgmmas would be serialized), so it lies in
// shared memory (a warpgroup's 64 rows x K, laid out as A's slices) and
// hi.lo's product reads it from there.
template <int N, int KS, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) probe_wgmma(Args p, Plan pl) {
  constexpr int R = N / 2;
  constexpr bool kLoShared = kSplit && KS > kMaxKSteps / 2;
  extern __shared__ float4 smem4[];
  unsigned char* const raw = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* const ring = raw + ((kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
  unsigned char* const x_lo = ring + pl.stages * pl.stage_bytes;  // [2][chunks] atoms
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(x_lo + pl.x_bytes);
  unsigned long long* const empty = full + pl.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // the warp's index, broadcast from lane 0 so that the compiler sees the
  // branches on it (and the warpgroup's) as uniform: a wgmma on a path it
  // takes for divergent is serialized
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= kConsumerWarps) {
    if (threadIdx.x == kConsumers) produce(p, pl, ring, full, empty);
    return;
  }
  const int g = warp / 4, w = warp % 4, lane = threadIdx.x % 32;
  const int row0 = 16 * w + lane / 4, q = lane % 4;
  const int ksteps = pl.k_pad / 16;
  const size_t W = (size_t)p.t * p.tiles;
  const size_t col0 = (size_t)blockIdx.x * p.t;
  unsigned char* const my_lo = x_lo + g * (pl.x_bytes / 2);
  int n = 0;
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int c0 = (2 * pass + g) * kRowTile;
    const bool active = c0 < p.t;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    // the previous pass's products (reading my_lo) are done in every warp
    if constexpr (kLoShared) warpgroup_sync(g);
    // X's fragment: register h of k step s holds columns c0 + row0 + 8 (h &
    // 1) at k = 16 s + 2 q + 8 (h >> 1) and the k after it
    uint32_t xh[KS][4], xl[kSplit && !kLoShared ? KS : 1][4];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = row0 + 8 * (h & 1), c = c0 + r, kk = 16 * s + 2 * q + 8 * (h >> 1);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = active && s < ksteps && kk + e < p.k && c < p.t
                     ? __ldg(p.x + (size_t)(kk + e) * W + col0 + c)
                     : 0.0f;
        }
        const uint16_t h0 = bf16_rne(v[0]), h1 = bf16_rne(v[1]);
        xh[s][h] = pack2(h0, h1);
        if constexpr (kSplit) {
          const uint32_t lo = pack2(bf16_rne(v[0] - bf16_value(h0)),
                                    bf16_rne(v[1] - bf16_value(h1)));
          if constexpr (kLoShared) {
            if (s < ksteps) *reinterpret_cast<uint32_t*>(my_lo + sw128_byte(r, kk, kRowTile)) = lo;
          } else {
            xl[s][h] = lo;
          }
        }
      }
    }
    if constexpr (kLoShared) {
      fence_proxy_async();
      warpgroup_sync(g);
    }
    fence_operands(acc);
    if (active) wgmma_fence();
    int prev = -1;
    for (int j = 0; j < p.nmat; ++j) {
      const int r = reps(p, j);
      if (r == 0) continue;
#pragma unroll
      for (int c = 0; c < KS / 4; ++c) {
        if (c >= pl.chunks) break;
        const int s = n % pl.stages;
        mbar_wait(full + s, (n / pl.stages) & 1);
        if (active) {
          const unsigned hi = smem_addr(ring + s * pl.stage_bytes), lo = hi + 128 * N;
          const unsigned xlo = smem_addr(my_lo) + c * kRowTile * 128;
          for (int it = 0; it < r; ++it) {
#pragma unroll
            for (int ks = 0; ks < kAtom / 16; ++ks) {
              if (4 * c + ks < ksteps) {
                Mma<N>::rs(acc, xh[4 * c + ks], sw128_desc(hi + 32 * ks));
                if constexpr (kLoShared) {
                  Mma<N>::ss(acc, sw128_desc(xlo + 32 * ks), sw128_desc(hi + 32 * ks));
                } else if constexpr (kSplit) {
                  Mma<N>::rs(acc, xl[4 * c + ks], sw128_desc(hi + 32 * ks));
                }
                if constexpr (kSplit) Mma<N>::rs(acc, xh[4 * c + ks], sw128_desc(lo + 32 * ks));
              }
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
        if (prev >= 0) release(empty, prev);
        prev = s;
        ++n;
      }
    }
    if (active) wgmma_wait<0>();
    fence_operands(acc);
    if (prev >= 0) release(empty, prev);
    if (!active) continue;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + row0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * jn + 2 * q + e;
          if (row < p.m && c < p.t) p.out[(size_t)row * W + col0 + c] = acc[4 * jn + 2 * h + e];
        }
      }
    }
  }
}

template <typename K>
int launch(K kernel, const Args& p, const Plan& pl, int threads, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.tiles, threads, pl.smem_bytes, st>>>(p, pl);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool kSplit>
int launch_wgmma(const Args& p, const Plan& pl, cudaStream_t st) {
  if constexpr (N > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (pl.n != N) return launch_wgmma<N + 8, kSplit>(p, pl, st);
    if (pl.frag == kMaxKSteps / 2)
      return launch(probe_wgmma<N, kMaxKSteps / 2, kSplit>, p, pl, kThreads, st);
    return launch(probe_wgmma<N, kMaxKSteps, kSplit>, p, pl, kThreads, st);
  }
}

// 0 when (m, k, nmat, t, tiles, iters, mode) fit the kernel and the caller's
// plan (n, k_pad, chunk, cols, stages, smem_bytes: ops/_kernels.py:
// probe_plan) is this one's, set in *pl; else an error code, or kRefused
int checked_plan(int m, int k, int nmat, int t, int tiles, int iters, int mode, int n,
                 int k_pad, int chunk, int cols, int stages, long long smem_bytes, Plan* pl) {
  if (m < 1 || m > 128 || k < 1 || k > kMaxKSteps * 16 || nmat < 1 || t < 1 ||
      tiles < 1 || iters < 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *pl = make_plan(m, k, t, mode);
  if (pl->n != n || pl->k_pad != k_pad || pl->chunk != chunk || pl->cols != cols ||
      pl->stages != stages || pl->smem_bytes != smem_bytes) {
    return kRefused;
  }
  return 0;
}

}  // namespace

// Launches `pack` on `stream`: A's nmat slices laid out in `packed` (nmat *
// the plan's slice bytes) as the probe reads them. Returns
// cudaGetLastError() (0 on success), an error code without launching when
// the shapes do not fit (m <= 128, k <= 256), and kRefused (-1) when the
// caller's plan is not this one's (checked_plan).
extern "C" int pll_mxu_probe_pack(const float* a, void* packed, int m, int k, int nmat,
                                  int t, int mode, int n, int k_pad, int chunk, int cols,
                                  int stages, long long smem_bytes, void* stream) {
  Plan pl;
  const int bad = checked_plan(m, k, nmat, t, 1, 0, mode, n, k_pad, chunk, cols, stages,
                               smem_bytes, &pl);
  if (bad != 0) return bad;
  const Args p{a, nullptr, nullptr, static_cast<unsigned char*>(packed), m, k, nmat, t, 1, 0};
  // one thread a float ('f32') or a (hi, lo) pair of bf16
  const long long elems =
      (mode == 0 ? pl.slice_bytes / 4 : pl.slice_bytes / 2 / (mode == 2 ? 2 : 1)) * nmat;
  pack<<<static_cast<unsigned>((elems + 255) / 256), 256, 0,
         static_cast<cudaStream_t>(stream)>>>(p, pl, mode);
  return static_cast<int>(cudaGetLastError());
}

// Launches one probe of `iters` products per column tile on `stream`,
// reading A's slices from `packed` as pll_mxu_probe_pack laid them out with
// the same plan. Returns as pll_mxu_probe_pack does.
extern "C" int pll_mxu_probe(const float* x, const void* packed, float* out, int m, int k,
                             int nmat, int t, int tiles, int iters, int mode, int n,
                             int k_pad, int chunk, int cols, int stages,
                             long long smem_bytes, void* stream) {
  Plan pl;
  const int bad = checked_plan(m, k, nmat, t, tiles, iters, mode, n, k_pad, chunk, cols,
                               stages, smem_bytes, &pl);
  if (bad != 0) return bad;
  const Args p{nullptr, x, out,
               static_cast<unsigned char*>(const_cast<void*>(packed)), m, k, nmat, t,
               tiles, iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch(probe_f32, p, pl, kThreads, st);
  if (mode == 2) return launch_wgmma<8, true>(p, pl, st);
  return launch_wgmma<8, false>(p, pl, st);
}
