// One dependency level of site-repeats pruning ops over the pooled class
// columns per launch, parent columns written in place.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_repeats.py:45 `_run_kernel`
// (reached through `pool_pallas`). That kernel runs one call per (width
// bucket, identity profile) run of ops and leans on the TPU's grid steps
// running in order, since a bucket may hold a parent and its own child. CUDA
// blocks run in no order, so the host (libpll2_tpu_torch/ops/pool.py)
// schedules by dependency levels and this kernel runs one level. The TPU
// kernel's block-band tables, 128-lane gather loop, float scaler rows and
// identity-profile split have no counterpart: a thread reads its child
// column gl[c] directly. The plain PyTorch version it must agree with is
// ops/pool.py:pool_update_reference.
//
// What it computes. A level table [11, ld] int64 (column k is op k):
//   p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off, W, g_off, has.
// For each op and parent class column c < W, with gl = gl_all[g_off + c] and
// gr = gr_all[g_off + c] (child class indices):
//   x[r,i] = (sum_j P[m1,r,i,j] pool[r*s+j, c1_off + gl])
//          * (sum_j P[m2,r,i,j] pool[r*s+j, c2_off + gr]).
// If has and x < threshold for every (r, i), x *= factor and the rescale
// counts 1; sc[psc_off + c] = sc[s1_off + gl] + sc[s2_off + gr] + rescale.
// The host points a missing child scaler at the always-zero region and a
// missing parent scaler at the trash region (has = 0: never rescaled). In
// per-rate mode (rate_scalers != 0; sc [R, T2]) each rate's block is
// compared with the threshold and rescaled on its own, and every scaler
// region holds one count row per rate. libpll2_tpu refuses per-rate scalers
// in its pool kernel and runs XLA; this kernel has the mode.
//
// Why in place is safe. Every node and every scaler index owns its own
// pooled region, and the host (ops/levels.py:schedule_levels) puts no two
// ops in a level where one writes a region another reads or writes. An op
// whose parent is its own child is refused on the host
// (ops/pool.py:pack_pool_levels): here one thread's child column is another
// thread's parent column. So no child column changes during a launch, and
// the runtime-size variant reads them through the read-only cache.
//
// What bounds it on an H100. Per parent class column it gathers two child
// columns and writes one (3 * R * s floats, 4 bytes each), and reads and
// writes 3 scaler and 2 gather int32s, against 4 * R * s * s + R * s FLOP:
// 1.3 FLOP per byte for DNA (R = s = 4), 6.6 for 20 states, below the
// card's 20 FLOP per byte (67 TFLOP/s float32 over 3.35 TB/s). The total is
// set by the data's class counts: chip_smoke.py computes it from them. But
// a level is narrow: the conserved 128 x 8192 LG+G4 protein computes
// 8,192-33,792 class columns a level (62-256 an SM), so a level's time is
// its latency chain (tile map, op, gather map, child columns, the FMAs,
// the store) and how busy its few warps keep an SM.
//
// The 4x4 variant (DNA): one thread per class column holds the op in
// registers, P through the read-only cache; grid (class column tiles of the
// level's widest op, ops of the level), each op masked to its own W.
//
// The runtime-size variant (20-state proteins, any other state count up to
// 32, any rate count), in the manner of level_update.cu's:
// - A flat grid over the level's tiles. The host packs, once per op list,
//   each level's tile map (ops/pool.py:tile_map): one (op, first column)
//   pair per 128 class columns of each op. A tile is 32-128 columns of one
//   op, so the launch covers exactly the level's columns rounded to 128,
//   not its widest op times its ops. A block takes a contiguous run of
//   tiles (several only on wide levels) and stages both P-matrices of an
//   op once for the whole run it spends in that op.
// - A thread owns one class column, and a column's rates are split over
//   the largest power of two of warps up to 4 that the rates fill
//   (blockDim.y, ops/_kernels.py:pool_plan); they meet in shared memory
//   once a tile for the column's maximum. Per rate a thread loads its
//   2 x s child values into registers before its FMAs, reads P four rows
//   at a time as float4 broadcasts (all rates that fit in 48 KB,
//   zero-padded to SP x SP, with SP a multiple of 4; 12.8 KB at 20 x 4)
//   and stores x[r, i] unscaled.
//   A block copies P into shared memory with cp.async, issued before the
//   child loads, so that both are in flight at once; one barrier then
//   makes it visible. There is no barrier inside the rate loop. A rescale,
//   which is rare, re-reads and multiplies the thread's own rows.
// - State counts are templates: 20 exactly, others padded to 4, 8, 16, 20
//   or 32 with masked loads (padded P and child entries are zero).
// Timed on an H100 against copies of this kernel (PERF.md, Findings):
// splitting the rates over 4 warps pays on the narrow levels of the
// conserved protein (8,192-33,792 columns, its every level), and
// staging P by cp.async beside the child loads beats loading it through
// registers; splitting a rate's rows over 2 lanes, 2 columns a thread, P
// read through the read-only cache instead of shared memory, 3 or 5
// blocks an SM, one tile a block, and reading the gather entries and the
// children's counts earlier were slower or no faster. What is left is each
// level's latency chain (as long as the 4x4 variant's whole level), the
// stores, the scattered child gathers of the top levels and the FMA loop
// at 8-16 warps an SM.
// Padding columns (W past the parent's class count) gather class 0 and are
// computed like the others: the plain version writes them too.
//
// Offsets into the pool are 64-bit (the table is int64): the pool holds
// R * s * T floats, past 2^31 at 80 rows and 27M columns.
//
// Numerics: built without --use_fast_math (IEEE, no flush to zero). nvcc
// contracts a*b+c into FMAs, which rounds differently from PyTorch's einsum;
// the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFixedBlock = 128;  // 4x4 variant: a thread per class column
constexpr int kBlock = 128;       // runtime-size variant: threads a block
constexpr int kBlocksPerSm = 4;   // its blocks resident on one SM
constexpr int kStageBytes = 48 * 1024;  // its shared memory, at most
constexpr int kGranule = 128;     // class columns a tile-map entry covers

struct Args {
  float* pool;               // [R * s, T]
  int* sc;                   // [SR, T2], SR = R per rate, else 1
  const float* pmat;         // [E, R, s, s]
  const long long* table;    // [11, ld]: this level's ops in columns 0..n-1
  int ld;
  long long T;
  const int* gl;             // gather maps of all ops, one after another
  const int* gr;
  int rates, states;
  float threshold, factor;
  long long T2;
  int rate_scalers;
};

struct Op {
  long long p, psc, c1, m1, s1, c2, m2, s2, w, g, has;
};

__device__ __forceinline__ Op load_op(const Args& a, int k) {
  const long long* t = a.table + k;
  Op op;
  op.p = __ldg(t);
  op.psc = __ldg(t + a.ld);
  op.c1 = __ldg(t + 2 * a.ld);
  op.m1 = __ldg(t + 3 * a.ld);
  op.s1 = __ldg(t + 4 * a.ld);
  op.c2 = __ldg(t + 5 * a.ld);
  op.m2 = __ldg(t + 6 * a.ld);
  op.s2 = __ldg(t + 7 * a.ld);
  op.w = __ldg(t + 8 * a.ld);
  op.g = __ldg(t + 9 * a.ld);
  op.has = __ldg(t + 10 * a.ld);
  return op;
}

// count group q (a rate in per-rate mode, else 0) of parent column c
__device__ __forceinline__ void write_count(const Args& a, const Op& op, int q,
                                            long long c, int gl, int gr,
                                            int rescale) {
  int* sc = a.sc + q * a.T2;
  sc[op.psc + c] = sc[op.s1 + gl] + sc[op.s2 + gr] + rescale;
}

// ---------------------------------------------------------------------------
// Sizes known at compile time: one thread per class column holds the op in
// registers. NSC counts per column: 1, or R_ in per-rate mode.
template <int S_, int R_, int NSC>
__global__ void __launch_bounds__(kFixedBlock) pool_fixed(Args a) {
  constexpr int RS = R_ * S_;
  constexpr int G = RS / NSC;  // rows per count
  const Op op = load_op(a, blockIdx.y);
  const long long c = (long long)blockIdx.x * kFixedBlock + threadIdx.x;
  if (c >= op.w) return;
  const size_t T = a.T;
  const int gl = __ldg(a.gl + op.g + c);
  const int gr = __ldg(a.gr + op.g + c);
  const float* left = a.pool + op.c1 + gl;
  const float* right = a.pool + op.c2 + gr;
  const float* pl = a.pmat + op.m1 * RS * S_;
  const float* pr = a.pmat + op.m2 * RS * S_;
  float l[RS], r[RS], x[RS];
#pragma unroll
  for (int k = 0; k < RS; ++k) {
    l[k] = left[k * T];
    r[k] = right[k * T];
  }
#pragma unroll
  for (int rate = 0; rate < R_; ++rate) {
#pragma unroll
    for (int i = 0; i < S_; ++i) {
      const float* p = pl + (rate * S_ + i) * S_;
      const float* q = pr + (rate * S_ + i) * S_;
      float ta = __ldg(p) * l[rate * S_];
      float tb = __ldg(q) * r[rate * S_];
#pragma unroll
      for (int j = 1; j < S_; ++j) {
        ta += __ldg(p + j) * l[rate * S_ + j];
        tb += __ldg(q + j) * r[rate * S_ + j];
      }
      x[rate * S_ + i] = ta * tb;
    }
  }
  float* dst = a.pool + op.p + c;
#pragma unroll
  for (int g = 0; g < NSC; ++g) {
    float m = 0.0f;
#pragma unroll
    for (int k = g * G; k < (g + 1) * G; ++k) m = x[k] > m ? x[k] : m;
    const int rescale = op.has && m < a.threshold;
#pragma unroll
    for (int k = g * G; k < (g + 1) * G; ++k) dst[k * T] = rescale ? x[k] * a.factor : x[k];
    write_count(a, op, g, c, gl, gr, rescale);
  }
}

// ---------------------------------------------------------------------------
// Sizes known at run time (any rates; states <= SP, SP a multiple of 4;
// EXACT: states == SP, no masks). Blocks of (w, TY) threads: w lanes over
// the w class columns of a tile, TY warps over the rates (rate r on thread
// row r % TY).
struct Tiles {
  const int2* map;   // [granules]: (op, its first column in the granule)
  int per_granule;   // tiles a granule: kGranule / w
  int count;         // tiles of the level
  int per_block;     // a block's tiles, one after another
  int rc;            // rates of P staged at a time
};

__device__ __forceinline__ void rescale_rows(float* dst, size_t T, int k0,
                                             int k1, float factor) {
  for (int k = k0; k < k1; ++k) dst[(size_t)k * T] *= factor;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 16-byte copy, or a 4-byte one (zeros where `ok` is false), from device
// to shared memory that does not wait for its data
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rates r0 .. r0+nr-1 of both P-matrices into `stage`, zero-padded to
// SP x SP, by all threads of the block, as cp.async copies that land while
// the thread goes on (cp_async_wait_all and a barrier before use); where
// the padded layout is P's own, 16 bytes at a time. Blocks start at
// different offsets (`rot`), so that blocks that read the same P at the
// same moment spread over its cache lines.
template <int SP, bool EXACT>
__device__ __forceinline__ void stage_p(float4* stage, const float* pl,
                                        const float* pr, int s, int r0,
                                        int nr) {
  constexpr int PP = SP * SP;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const bool vec = EXACT && ((reinterpret_cast<size_t>(pl) |
                              reinterpret_cast<size_t>(pr)) & 15) == 0;
  if (vec) {
    const int n4 = nr * (PP / 4), n = 2 * n4;
    const int rot = (int)((size_t)blockIdx.x * nt % n);
    const float4* gl = reinterpret_cast<const float4*>(pl + (size_t)r0 * PP);
    const float4* gr = reinterpret_cast<const float4*>(pr + (size_t)r0 * PP);
    for (int i = tid; i < n; i += nt) {
      const int k = i + rot < n ? i + rot : i + rot - n;
      cp_async16(stage + k, k < n4 ? gl + k : gr + (k - n4));
    }
    return;
  }
  float* sp = reinterpret_cast<float*>(stage);
  const int n = 2 * nr * PP;
  const int rot = (int)((size_t)blockIdx.x * nt % n);
  for (int i = tid; i < n; i += nt) {
    const int k = i + rot < n ? i + rot : i + rot - n;
    const int j = k % SP, row = (k / SP) % SP, cr = k / PP;
    const int c = cr >= nr, r = r0 + cr - c * nr;
    const bool ok = EXACT || (row < s && j < s);
    cp_async4(sp + k, ok ? (c ? pr : pl) + ((size_t)r * s + row) * s + j : pl,
              ok);
  }
}

// Rate r of the thread's child columns into registers (zero past the
// state count and for a column past W).
template <int SP, bool EXACT>
__device__ __forceinline__ void load_children(float (&cl)[SP], float (&cr)[SP],
                                              const float* left,
                                              const float* right, bool in,
                                              int r, int s, size_t T) {
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const bool ok = in && (EXACT || j < s);
    const size_t row = (size_t)(r * s + j) * T;
    cl[j] = ok ? __ldg(left + row) : 0.0f;
    cr[j] = ok ? __ldg(right + row) : 0.0f;
  }
}

template <int SP, bool EXACT>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    pool_generic(Args a, Tiles tl) {
  // [2][rc][SP][SP / 4] float4: P[m1], then P[m2]; then 2 x [TY][w]
  // floats: each rate warp's column maxima, two buffers by tile parity
  extern __shared__ float4 stage[];
  constexpr int PP = SP * SP;
  constexpr int kRows = 4;  // rows of P a step
  const int s = EXACT ? SP : a.states;
  const int RS = a.rates * s;
  const int TY = blockDim.y, ty = threadIdx.y;
  const int w = blockDim.x, lx = threadIdx.x;  // w: class columns a tile
  const size_t T = a.T;
  float* smax = reinterpret_cast<float*>(stage + (size_t)tl.rc * (PP / 2));
  int staged_op = -1, staged_r0 = -1;  // what `stage` holds
  const int t0 = blockIdx.x * tl.per_block;
  const int t1 = min(t0 + tl.per_block, tl.count);
  for (int t = t0; t < t1; ++t) {
    const int2 e = __ldg(tl.map + t / tl.per_granule);
    const Op op = load_op(a, e.x);
    const long long c = e.y + (long long)(t % tl.per_granule) * w + lx;
    const bool in = c < op.w;
    const int gl = in ? __ldg(a.gl + op.g + c) : 0;
    const int gr = in ? __ldg(a.gr + op.g + c) : 0;
    const float* left = a.pool + op.c1 + gl;
    const float* right = a.pool + op.c2 + gr;
    float* dst = a.pool + op.p + c;
    const float* pl = a.pmat + op.m1 * RS * s;
    const float* pr = a.pmat + op.m2 * RS * s;
    // The thread's rates are ty, ty + TY, ...: a rate's child columns are
    // all loaded before its FMAs, the next rate's as soon as its last row
    // is stored. P's first chunk (a new op's, the same for the whole block)
    // is copied while the tile's first rate loads.
    const bool fresh = staged_op != e.x || staged_r0 != 0;
    if (fresh) {
      if (staged_r0 >= 0) __syncthreads();  // every thread is done with it
      stage_p<SP, EXACT>(stage, pl, pr, s, 0, min(tl.rc, a.rates));
    }
    float cl[SP], cr[SP];
    if (ty < a.rates)
      load_children<SP, EXACT>(cl, cr, left, right, in, ty, s, T);
    float m = 0.0f;
    for (int r0 = 0; r0 < a.rates; r0 += tl.rc) {
      const int nr = min(tl.rc, a.rates - r0);
      if (r0 > 0) {  // a later chunk of many rates
        __syncthreads();
        stage_p<SP, EXACT>(stage, pl, pr, s, r0, nr);
      }
      if (r0 > 0 || fresh) {
        cp_async_wait_all();
        __syncthreads();
        staged_op = e.x;
        staged_r0 = r0;
      }
      // the thread's first rate in this chunk: the next of ty, ty + TY, ...
      for (int r = r0 + ((ty - r0) % TY + TY) % TY; r < r0 + nr; r += TY) {
        const float4* p = stage + (size_t)(r - r0) * (PP / 4);
        const float4* q = stage + (size_t)(nr + r - r0) * (PP / 4);
        float mr = 0.0f;
        // kRows rows at a time: each step of 4 columns of P loads 2 * kRows
        // float4 and feeds 8 * kRows independent FMAs
#pragma unroll 1
        for (int i0 = 0; i0 < SP; i0 += kRows) {
          if (!EXACT && i0 >= s) break;
          float ta[kRows], tb[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) ta[i] = tb[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < SP / 4; ++j) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float4 u = p[(i0 + i) * (SP / 4) + j];
              const float4 v = q[(i0 + i) * (SP / 4) + j];
              ta[i] = fmaf(u.x, cl[4 * j], ta[i]);
              tb[i] = fmaf(v.x, cr[4 * j], tb[i]);
              ta[i] = fmaf(u.y, cl[4 * j + 1], ta[i]);
              tb[i] = fmaf(v.y, cr[4 * j + 1], tb[i]);
              ta[i] = fmaf(u.z, cl[4 * j + 2], ta[i]);
              tb[i] = fmaf(v.z, cr[4 * j + 2], tb[i]);
              ta[i] = fmaf(u.w, cl[4 * j + 3], ta[i]);
              tb[i] = fmaf(v.w, cr[4 * j + 3], tb[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (!EXACT && i0 + i >= s) break;  // a padded row: not stored
            const float x = ta[i] * tb[i];
            mr = x > mr ? x : mr;
            if (in) dst[(size_t)(r * s + i0 + i) * T] = x;
          }
        }
        if (r + TY < a.rates)
          load_children<SP, EXACT>(cl, cr, left, right, in, r + TY, s, T);
        if (!a.rate_scalers) {
          m = mr > m ? mr : m;
        } else if (in) {  // this rate's count and rescale
          const int rescale = op.has && mr < a.threshold;
          if (rescale) rescale_rows(dst, T, r * s, (r + 1) * s, a.factor);
          write_count(a, op, r, c, gl, gr, rescale);
        }
      }
    }
    if (a.rate_scalers) continue;
    if (TY > 1) {  // the column's maximum over its rate warps
      // two buffers by tile parity: a thread writes one only after the
      // barrier of the tile between, which every reader of it has passed
      float* mx = smax + ((t - t0) & 1) * TY * w;
      mx[ty * w + lx] = m;
      __syncthreads();
      for (int y = 0; y < TY; ++y) {
        const float v = mx[y * w + lx];
        m = v > m ? v : m;
      }
    }
    if (!in) continue;
    const int rescale = op.has && m < a.threshold;
    if (rescale)
      for (int r = ty; r < a.rates; r += TY)
        rescale_rows(dst, T, r * s, (r + 1) * s, a.factor);
    if (ty == 0) write_count(a, op, 0, c, gl, gr, rescale);
  }
}

// One launch of the runtime-size variant with `ty` rate warps: tiles of
// kBlock / ty columns, `per_block` of them a block.
template <int SP, bool EXACT>
void launch_generic(const Args& a, const int* map, int granules, int ty,
                    int per_block, cudaStream_t st) {
  constexpr int per_rate = 2 * SP * SP * (int)sizeof(float);
  constexpr int maxima = 2 * kBlock * (int)sizeof(float);
  const int w = kBlock / ty;
  Tiles tl{reinterpret_cast<const int2*>(map), kGranule / w, 0, per_block,
           min(a.rates, (kStageBytes - maxima) / per_rate)};
  tl.count = granules * tl.per_granule;
  const int blocks = (tl.count + per_block - 1) / per_block;
  const size_t smem = (size_t)tl.rc * per_rate + (size_t)maxima;
  pool_generic<SP, EXACT><<<blocks, dim3(w, ty), smem, st>>>(a, tl);
}

}  // namespace

// Launches one level of `n_ops` ops on `stream` and returns
// cudaGetLastError() (0 on success). T2 is the scaler pool's column count
// (its row stride in per-rate mode). The 4x4 variant's grid covers the
// widest op, `max_width` class columns, for each op; the runtime-size
// variant's covers the level's tile map (`map`, `granules` int32 pairs)
// with the layout of ops/_kernels.py:pool_plan: `rate_threads` warps over
// the rates, `per_block` tiles a block.
extern "C" int pll_pool_update(float* pool, int* sc, const float* pmat,
                               const long long* table, int ld, int n_ops,
                               int max_width, long long T, const int* gl,
                               const int* gr, int rates, int states,
                               float threshold, float factor, long long T2,
                               int rate_scalers, const int* map, int granules,
                               int rate_threads, int per_block, void* stream) {
  Args a{pool, sc, pmat, table, ld, T, gl, gr, rates, states, threshold,
         factor, T2, rate_scalers};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4 && rates == 4) {
    const dim3 grid((max_width + kFixedBlock - 1) / kFixedBlock, n_ops);
    if (rate_scalers) {
      pool_fixed<4, 4, 4><<<grid, kFixedBlock, 0, st>>>(a);
    } else {
      pool_fixed<4, 4, 1><<<grid, kFixedBlock, 0, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int ty = rate_threads;
  if (!(ty == 1 || ty == 2 || ty == 4) || granules < 1 || per_block < 1 ||
      map == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (states == 20) {
    launch_generic<20, true>(a, map, granules, ty, per_block, st);
  } else if (states <= 4) {
    launch_generic<4, false>(a, map, granules, ty, per_block, st);
  } else if (states <= 8) {
    launch_generic<8, false>(a, map, granules, ty, per_block, st);
  } else if (states <= 16) {
    launch_generic<16, false>(a, map, granules, ty, per_block, st);
  } else if (states <= 20) {
    launch_generic<20, false>(a, map, granules, ty, per_block, st);
  } else {
    launch_generic<32, false>(a, map, granules, ty, per_block, st);
  }
  return static_cast<int>(cudaGetLastError());
}
