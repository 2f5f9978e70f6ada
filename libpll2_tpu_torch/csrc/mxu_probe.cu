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
//   0 'f32'   -- CUDA-core float32 FMAs, A's slice and a 64-column sub-tile
//                of X staged in shared memory;
//   1 'bf16'  -- mma.sync.m16n8k16 with A and X rounded to bf16 (to nearest,
//                ties to even, as astype(bfloat16) and .to(torch.bfloat16))
//                and float32 accumulation; m and k padded with zeros to the
//                16-row, 16-deep tile;
//   2 'split' -- three bf16 passes, hi.hi + hi.lo + lo.hi, with lo the bf16
//                rounding of x - hi: float32-class products from the bf16
//                tensor cores, the candidate for the 20-state kernel's
//                'split' mode.
// The sum runs slice by slice (every i with i mod nmat == j after A's slice
// j is staged), which reorders the float32 additions of the plain version's
// loop over i; the products are the same.
//
// What bounds it on an H100: operations, by design. Per block and
// iteration 2 * m * k * t FLOP against nothing read from device memory (A's
// slices and X's sub-tile stay in shared memory). Shared-memory loads feed
// each FMA or mma here (a register-tiled FMA loop: 4 columns x up to 8 rows
// a thread; one warp per 8-column n-tile over all 16-row m-tiles for mma),
// so the rates are those of this simple design, not the card's peaks
// (67 TFLOP/s float32, 989 TFLOP/s bf16 dense); wgmma and register-resident
// operands are the redesign's work. With `tiles` = 8 (the TPU probe's grid)
// 8 of 132 SMs work; a tile count that fills the card gives its rate.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 64;       // columns of X staged at once
constexpr int kMaxMt = 8;      // 16-row m-tiles: m <= 128

struct Args {
  const float* a;   // [nmat * m, k]
  const float* x;   // [k, tiles * t]
  float* out;       // [m, tiles * t]
  int m, k, nmat, t, tiles, iters;
};

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

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// 'f32': thread (tx, ty) of 16 x 16 owns columns 4 tx .. 4 tx + 3 of the
// sub-tile and rows ty, ty + 16, ... (at most 8).
__global__ void __launch_bounds__(kThreads) probe_f32(Args p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int ka = p.k + 1;              // padded A row: no bank conflicts
  float* const xs = smem;              // [k][kSub]
  float* const as = xs + p.k * kSub;   // [m][k + 1]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t W = (size_t)p.t * p.tiles;
  const size_t col0 = (size_t)blockIdx.x * p.t;
  for (int c0 = 0; c0 < p.t; c0 += kSub) {
    float acc[kMaxMt][4];
#pragma unroll
    for (int q = 0; q < kMaxMt; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    }
    __syncthreads();  // the previous sub-tile is done with xs
    for (int q = threadIdx.x; q < p.k * kSub; q += kThreads) {
      const int kk = q / kSub, n = q % kSub;
      xs[q] = c0 + n < p.t ? __ldg(p.x + (size_t)kk * W + col0 + c0 + n) : 0.0f;
    }
    for (int j = 0; j < p.nmat; ++j) {
      __syncthreads();  // the previous slice is done with as
      const float* aj = p.a + (size_t)j * p.m * p.k;
      for (int q = threadIdx.x; q < p.m * p.k; q += kThreads) {
        as[(q / p.k) * ka + q % p.k] = __ldg(aj + q);
      }
      __syncthreads();
      const int n = reps(p, j);
      for (int it = 0; it < n; ++it) {
        for (int kk = 0; kk < p.k; ++kk) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + kk * kSub + 4 * tx);
#pragma unroll
          for (int q = 0; q < kMaxMt; ++q) {
            const int r = ty + 16 * q;
            if (r < p.m) {
              const float av = as[r * ka + kk];
              acc[q][0] += av * xv.x;
              acc[q][1] += av * xv.y;
              acc[q][2] += av * xv.z;
              acc[q][3] += av * xv.w;
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxMt; ++q) {
      const int r = ty + 16 * q;
      if (r >= p.m) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * tx + e;
        if (c < p.t) p.out[(size_t)r * W + col0 + c] = acc[q][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 'bf16' and 'split': warp w owns the 8-column n-tile w of the sub-tile and
// every 16-row m-tile. Operands are bf16 in shared memory, A as [row][k] and
// X as [column][k] (the col-major B of mma), rows padded by 8 values so that
// the 32 lanes' fragment loads fall in 32 banks.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1)
      : "memory");
}

__host__ __device__ inline int padded16(int v) { return (v + 15) & ~15; }

template <bool kSplit>
__global__ void __launch_bounds__(kThreads) probe_mma(Args p) {
  extern __shared__ float4 smem4[];
  uint16_t* const hs = reinterpret_cast<uint16_t*>(smem4);
  const int mp = padded16(p.m), kp = padded16(p.k), ld = kp + 8;
  const int n_buf = kSplit ? 2 : 1;
  uint16_t* const xh = hs;                     // [kSub][ld] (hi, then lo)
  uint16_t* const ah = hs + n_buf * kSub * ld; // [mp][ld] (hi, then lo)
  uint16_t* const xl = xh + kSub * ld;
  uint16_t* const al = ah + mp * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mt_n = mp / 16;
  const size_t W = (size_t)p.t * p.tiles;
  const size_t col0 = (size_t)blockIdx.x * p.t;
  for (int c0 = 0; c0 < p.t; c0 += kSub) {
    float acc[kMaxMt][4];
#pragma unroll
    for (int q = 0; q < kMaxMt; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    }
    __syncthreads();  // the previous sub-tile is done with xh, xl
    for (int q = threadIdx.x; q < kp * kSub; q += kThreads) {
      const int kk = q / kSub, n = q % kSub;
      const float v = kk < p.k && c0 + n < p.t
                          ? __ldg(p.x + (size_t)kk * W + col0 + c0 + n)
                          : 0.0f;
      const uint16_t h = bf16_rne(v);
      xh[n * ld + kk] = h;
      if (kSplit) xl[n * ld + kk] = bf16_rne(v - bf16_value(h));
    }
    for (int j = 0; j < p.nmat; ++j) {
      __syncthreads();  // the previous slice is done with ah, al
      const float* aj = p.a + (size_t)j * p.m * p.k;
      for (int q = threadIdx.x; q < mp * kp; q += kThreads) {
        const int r = q / kp, kk = q % kp;
        const float v = r < p.m && kk < p.k ? __ldg(aj + (size_t)r * p.k + kk) : 0.0f;
        const uint16_t h = bf16_rne(v);
        ah[r * ld + kk] = h;
        if (kSplit) al[r * ld + kk] = bf16_rne(v - bf16_value(h));
      }
      __syncthreads();
      const int n = reps(p, j);
      const uint16_t* xb = xh + (warp * 8 + gid) * ld + 2 * tig;
      for (int it = 0; it < n; ++it) {
        for (int kk = 0; kk < kp; kk += 16) {
          const uint32_t b0 = ld32(xb + kk), b1 = ld32(xb + kk + 8);
          uint32_t bl0 = 0, bl1 = 0;
          if (kSplit) {
            bl0 = ld32(xb + kSub * ld + kk);
            bl1 = ld32(xb + kSub * ld + kk + 8);
          }
#pragma unroll
          for (int mt = 0; mt < kMaxMt; ++mt) {
            if (mt >= mt_n) break;
            const uint16_t* ab = ah + (mt * 16 + gid) * ld + kk + 2 * tig;
            const uint32_t a0 = ld32(ab), a1 = ld32(ab + 8 * ld);
            const uint32_t a2 = ld32(ab + 8), a3 = ld32(ab + 8 * ld + 8);
            mma_bf16(acc[mt], a0, a1, a2, a3, b0, b1);
            if (kSplit) {
              mma_bf16(acc[mt], a0, a1, a2, a3, bl0, bl1);
              const uint16_t* lb = ab + mp * ld;
              mma_bf16(acc[mt], ld32(lb), ld32(lb + 8 * ld), ld32(lb + 8),
                       ld32(lb + 8 * ld + 8), b0, b1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMaxMt; ++mt) {
      if (mt >= mt_n) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + gid + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + warp * 8 + 2 * tig + e;
          if (r < p.m && c < p.t) p.out[(size_t)r * W + col0 + c] = acc[mt][2 * h + e];
        }
      }
    }
  }
}

template <typename K>
int launch(K kernel, const Args& p, size_t bytes, cudaStream_t st) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p.tiles, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one probe of `iters` products per column tile on `stream` and
// returns cudaGetLastError() (0 on success), or an error code without
// launching when the shapes do not fit (m <= 128, k <= 256).
extern "C" int pll_mxu_probe(const float* a, const float* x, float* out, int m,
                             int k, int nmat, int t, int tiles, int iters,
                             int mode, void* stream) {
  if (m < 1 || m > 16 * kMaxMt || k < 1 || k > 256 || nmat < 1 || t < 1 ||
      tiles < 1 || iters < 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args p{a, x, out, m, k, nmat, t, tiles, iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    const size_t bytes = ((size_t)k * kSub + (size_t)m * (k + 1)) * sizeof(float);
    return launch(probe_f32, p, bytes, st);
  }
  const size_t ld = padded16(k) + 8;
  const size_t bytes = (mode == 2 ? 2 : 1) * (kSub + padded16(m)) * ld * sizeof(uint16_t);
  if (mode == 2) return launch(probe_mma<true>, p, bytes, st);
  return launch(probe_mma<false>, p, bytes, st);
}
