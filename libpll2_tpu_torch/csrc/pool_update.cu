// One dependency level of site-repeats pruning ops over the pooled class
// columns per launch, parent columns written in place.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_repeats.py:45 `_run_kernel`
// (reached through `pool_pallas`). That kernel runs one call per (width
// bucket, identity profile) run of ops and leans on the TPU's grid steps
// running in order, since a bucket may hold a parent and its own child. CUDA
// blocks run in no order, so the host (libpll2_tpu_torch/ops/pool.py)
// schedules by dependency levels and this kernel runs one level: grid (class
// column tiles of the level's widest op, ops of the level); each op masks to
// its own width W. The TPU kernel's block-band tables, 128-lane gather loop,
// float scaler rows and identity-profile split have no counterpart: a thread
// reads its child column gl[c] directly. The plain PyTorch version it must
// agree with is ops/pool.py:pool_update_reference.
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
// missing parent scaler at the trash region (has = 0: never rescaled).
//
// Why in place is safe. Every node and every scaler index owns its own
// pooled region, and the host (ops/levels.py:schedule_levels) puts no two
// ops in a level where one writes a region another reads or writes. An op
// whose parent is its own child is refused on the host
// (ops/pool.py:pack_pool_levels): here one thread's child column is another
// thread's parent column.
//
// What bounds it on an H100: bytes. Per parent class column it gathers two
// child columns and writes one (3 * R * s floats, 4 bytes each), and reads
// and writes 3 scaler and 2 gather int32s, against 4 * R * s * s + R * s
// FLOP: 1.3 FLOP per byte for DNA (R = s = 4), 6.6 for 20 states, below the
// card's 20 FLOP per byte (67 TFLOP/s float32 over 3.35 TB/s). The total is
// set by the data's class counts: chip_smoke.py computes it from them. The
// design does the simple thing: one thread per class column, parent stores
// coalesced, child gathers as coalesced as the class maps allow (classes
// are numbered in first-occurrence order on both ends, so neighbouring
// parent columns mostly gather neighbouring child columns). Levels of few
// narrow ops leave most of the card idle; fusing levels is later work.
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
constexpr int kTile = 32;         // generic variant: columns per block
constexpr int kWarps = 8;         // generic variant: warps per block
constexpr int kMaxStates = 32;

struct Args {
  float* pool;               // [R * s, T]
  int* sc;                   // [T2]
  const float* pmat;         // [E, R, s, s]
  const long long* table;    // [11, ld]: this level's ops in columns 0..n-1
  int ld;
  long long T;
  const int* gl;             // gather maps of all ops, one after another
  const int* gr;
  int rates, states;
  float threshold, factor;
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

// ---------------------------------------------------------------------------
// Sizes known at compile time: one thread per class column holds the op in
// registers.
template <int S_, int R_>
__global__ void __launch_bounds__(kFixedBlock) pool_fixed(Args a) {
  constexpr int RS = R_ * S_;
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
  float m = 0.0f;
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
      const float v = ta * tb;
      x[rate * S_ + i] = v;
      m = v > m ? v : m;
    }
  }
  const int rescale = op.has && m < a.threshold;
  float* dst = a.pool + op.p + c;
#pragma unroll
  for (int k = 0; k < RS; ++k) dst[k * T] = rescale ? x[k] * a.factor : x[k];
  a.sc[op.psc + c] = a.sc[op.s1 + gl] + a.sc[op.s2 + gr] + rescale;
}

// ---------------------------------------------------------------------------
// Sizes known at run time (any rates, states <= 32). A block owns 32 class
// columns (one per lane) of one op; its 8 warps split the rows of one rate
// at a time. Per rate: P[m1, r] and P[m2, r] and the gathered child columns'
// s rows are staged in shared memory, then each warp computes its rows and
// stores them unscaled. After all rates, the per-column maximum is reduced
// across warps; a column that must be rescaled has its stored rows
// multiplied by `factor` after a barrier (a global store by one thread is
// visible to the block after __syncthreads()).
__global__ void __launch_bounds__(kWarps * 32) pool_generic(Args a) {
  __shared__ float sp[2][kMaxStates * kMaxStates];
  __shared__ float sx[2][kMaxStates][kTile];
  __shared__ float smax[kWarps][kTile];
  __shared__ int sflag[kTile];
  const Op op = load_op(a, blockIdx.y);
  const long long c0 = (long long)blockIdx.x * kTile;
  if (c0 >= op.w) return;  // the same for the whole block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = a.states, RS = a.rates * a.states;
  const size_t T = a.T;
  const long long c = c0 + lane;
  const bool in = c < op.w;
  const int gl = in ? __ldg(a.gl + op.g + c) : 0;
  const int gr = in ? __ldg(a.gr + op.g + c) : 0;
  const float* left = a.pool + op.c1 + gl;
  const float* right = a.pool + op.c2 + gr;
  float* dst = a.pool + op.p + c;
  const float* pl = a.pmat + op.m1 * RS * s;
  const float* pr = a.pmat + op.m2 * RS * s;
  float m = 0.0f;
  for (int r = 0; r < a.rates; ++r) {
    __syncthreads();  // the previous rate's reads of sp and sx are done
    for (int k = threadIdx.x; k < s * s; k += kWarps * 32) {
      sp[0][k] = __ldg(pl + (size_t)r * s * s + k);
      sp[1][k] = __ldg(pr + (size_t)r * s * s + k);
    }
    for (int j = warp; j < s; j += kWarps) {
      const size_t at = (size_t)(r * s + j) * T;
      sx[0][j][lane] = in ? left[at] : 0.0f;
      sx[1][j][lane] = in ? right[at] : 0.0f;
    }
    __syncthreads();
    for (int i = warp; i < s; i += kWarps) {
      const float* p = sp[0] + i * s;
      const float* q = sp[1] + i * s;
      float ta = p[0] * sx[0][0][lane];
      float tb = q[0] * sx[1][0][lane];
      for (int j = 1; j < s; ++j) {
        ta += p[j] * sx[0][j][lane];
        tb += q[j] * sx[1][j][lane];
      }
      const float v = ta * tb;
      m = v > m ? v : m;
      if (in) dst[(size_t)(r * s + i) * T] = v;
    }
  }
  smax[warp][lane] = m;
  __syncthreads();
  if (warp == 0) {
    float mm = smax[0][lane];
    for (int w = 1; w < kWarps; ++w) {
      mm = smax[w][lane] > mm ? smax[w][lane] : mm;
    }
    const int rescale = op.has && mm < a.threshold;
    sflag[lane] = rescale;
    if (in) a.sc[op.psc + c] = a.sc[op.s1 + gl] + a.sc[op.s2 + gr] + rescale;
  }
  __syncthreads();
  if (in && sflag[lane]) {
    for (int k = warp; k < RS; k += kWarps) dst[(size_t)k * T] *= a.factor;
  }
}

}  // namespace

// Launches one level of `n_ops` ops, the widest `max_width` class columns
// wide, on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pll_pool_update(float* pool, int* sc, const float* pmat,
                               const long long* table, int ld, int n_ops,
                               int max_width, long long T, const int* gl,
                               const int* gr, int rates, int states,
                               float threshold, float factor, void* stream) {
  Args a{pool, sc, pmat, table, ld, T, gl, gr, rates, states, threshold,
         factor};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4 && rates == 4) {
    const dim3 grid((max_width + kFixedBlock - 1) / kFixedBlock, n_ops);
    pool_fixed<4, 4><<<grid, kFixedBlock, 0, st>>>(a);
  } else {
    const dim3 grid((max_width + kTile - 1) / kTile, n_ops);
    pool_generic<<<grid, kWarps * 32, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
