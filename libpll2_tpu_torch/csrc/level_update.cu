// One tree level of independent Felsenstein pruning ops per launch, with the
// parent rows written in place into the dense CLV buffer.
//
// Replaces two TPU kernels of libpll2_tpu/ops/pallas_partials.py: `_kernel`
// (:48, one level into compact outputs that the caller scatters) and
// `_inplace_kernel` (:170, the same arithmetic with the parent rows DMA'd
// into the aliased CLV buffer). On CUDA a block simply stores its parent
// rows where they belong, so one kernel covers both. Called through
// libpll2_tpu_torch/ops/levels.py:level_update, which also holds the plain
// PyTorch version (level_update_reference) that this must agree with.
//
// What it computes. A level table [9, W] int32 (column w is op w; the row
// stride is `ld`, so a level may be a column slice of a larger table):
//   parent, c1, c2, m1, m2, s1 (read), s2 (read), psc (write), has_scaler.
// For each op and site: x[r,i] = (sum_j P[m1,r,i,j] clv[c1,r,j])
//                              * (sum_j P[m2,r,i,j] clv[c2,r,j]).
// If has_scaler and x < threshold for every (r, i), x *= factor and the
// rescale counts 1. scaler[psc] = scaler[s1] + scaler[s2] + rescale. The
// host maps a missing child scaler to the always-zero row and a missing
// parent scaler to the trash row, so the kernel has no special cases.
//
// Why in place is safe. The host (ops/levels.py:schedule_levels) puts no
// two ops in a level where one writes a row (CLV or scaler) that another
// reads or writes; blocks of one op cover disjoint site tiles. Within an op,
// every child value a thread reads is read before the rows it came from can
// be written (the 4x4 variant holds the whole op in registers; the generic
// one stages a rate's child rows in shared memory before any of that rate's
// parent rows is stored), so even an op whose parent is its own child is
// right.
//
// What bounds it on an H100: bytes. Per op and site it reads 2 * R * s and
// writes R * s floats, against 2 * R * s * s FMAs. A DNA traversal at 128
// taxa x 16384 sites (126 ops, R = 4, s = 4, one CLV row 1.05 MB) moves,
// level by level, 126 * 3 * 1.05 MB = 396 MB, 118 us at 3.35 TB/s, and does
// 126 * 16384 * 2 * 4 * 16 * 2 FLOP = 0.53 GFLOP, 8 us at 67 TFLOP/s
// float32. Reading each tip row once and writing each inner row once (what
// any traversal must move; chip_smoke.py reports that bound) it is 254
// rows, 266 MB, 80 us. The protein traversal at 128 x 8192 (R = 4, s = 20,
// a row 2.6 MB) moves 126 * 3 * 2.6 MB = 991 MB (296 us; 666 MB or 199 us
// read and written once) against 6.6 GFLOP (99 us). The design does the
// simple thing about it: every CLV value
// is read and written once, by coalesced accesses (sites are the fastest
// axis, one thread per site). P comes through the read-only cache (4x4) or
// shared memory (generic). Width-1 levels (a caterpillar tree) leave most of
// the card idle; overlapping levels, cp.async/TMA staging and tensor cores
// are later work.
//
// Offsets into the CLV and scaler buffers are 64-bit: (N+1) * R * s * S
// passes 2^31 at 1000 taxa x 20 states x 4 rates x 30000 sites.
//
// Numerics: build without --use_fast_math (IEEE, no flush to zero, so 2^-64
// stays a normal float). nvcc contracts a*b+c into FMAs, which rounds
// differently from PyTorch's einsum; the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFixedBlock = 128;  // 4x4 variant: one thread per site
constexpr int kTile = 32;         // generic variant: sites per block, one a lane
constexpr int kWarps = 8;         // generic variant: warps per block
constexpr int kMaxStates = 32;

struct Args {
  float* clv;          // [N+1, R * s, S]
  int* scaler;         // [K+2, S]
  const float* pmat;   // [E, R, s, s]
  const int* table;    // [9, ld]: this level's ops in columns 0..W-1
  int ld;
  int sites, rates, states;
  float threshold, factor;
};

struct Op {
  int parent, c1, c2, m1, m2, s1, s2, psc, has;
};

__device__ __forceinline__ Op load_op(const Args& a, int w) {
  const int* t = a.table + w;
  Op op;
  op.parent = __ldg(t);
  op.c1 = __ldg(t + a.ld);
  op.c2 = __ldg(t + 2 * a.ld);
  op.m1 = __ldg(t + 3 * a.ld);
  op.m2 = __ldg(t + 4 * a.ld);
  op.s1 = __ldg(t + 5 * a.ld);
  op.s2 = __ldg(t + 6 * a.ld);
  op.psc = __ldg(t + 7 * a.ld);
  op.has = __ldg(t + 8 * a.ld);
  return op;
}

__device__ __forceinline__ void write_scaler(const Args& a, const Op& op,
                                             size_t site, int rescale) {
  const size_t S = a.sites;
  a.scaler[(size_t)op.psc * S + site] =
      a.scaler[(size_t)op.s1 * S + site] + a.scaler[(size_t)op.s2 * S + site] +
      rescale;
}

// ---------------------------------------------------------------------------
// Sizes known at compile time: one thread per site holds the op in registers.
template <int S_, int R_>
__global__ void __launch_bounds__(kFixedBlock) level_fixed(Args a) {
  constexpr int RS = R_ * S_;
  const Op op = load_op(a, blockIdx.y);
  const size_t site = (size_t)blockIdx.x * kFixedBlock + threadIdx.x;
  if (site >= (size_t)a.sites) return;
  const size_t S = a.sites;
  const float* left = a.clv + (size_t)op.c1 * RS * S + site;
  const float* right = a.clv + (size_t)op.c2 * RS * S + site;
  const float* pl = a.pmat + (size_t)op.m1 * RS * S_;
  const float* pr = a.pmat + (size_t)op.m2 * RS * S_;
  float l[RS], r[RS], x[RS];
#pragma unroll
  for (int k = 0; k < RS; ++k) {
    l[k] = left[k * S];
    r[k] = right[k * S];
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
  const float f = rescale ? a.factor : 1.0f;
  float* dst = a.clv + (size_t)op.parent * RS * S + site;
#pragma unroll
  for (int k = 0; k < RS; ++k) dst[k * S] = rescale ? x[k] * f : x[k];
  write_scaler(a, op, site, rescale);
}

// ---------------------------------------------------------------------------
// Sizes known at run time (any rates, states <= 32). A block owns 32 sites
// (one per lane) of one op; its 8 warps split the rows of one rate at a time.
// Per rate: P[m1, r] and P[m2, r] and the children's s rows of the tile are
// staged in shared memory, then each warp computes its rows and stores them
// unscaled. After all rates, the per-site maximum is reduced across warps; a
// site that must be rescaled has its stored rows multiplied by `factor`
// (a global store by one thread is visible to the block after
// __syncthreads()). x * factor is the same float whether multiplied before
// or after the store.
__global__ void __launch_bounds__(kWarps * 32) level_generic(Args a) {
  __shared__ float sp[2][kMaxStates * kMaxStates];
  __shared__ float sc[2][kMaxStates][kTile];
  __shared__ float smax[kWarps][kTile];
  __shared__ int sflag[kTile];
  const Op op = load_op(a, blockIdx.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = a.states, RS = a.rates * a.states;
  const size_t S = a.sites;
  const size_t site = (size_t)blockIdx.x * kTile + lane;
  const bool in = site < S;
  const float* left = a.clv + (size_t)op.c1 * RS * S;
  const float* right = a.clv + (size_t)op.c2 * RS * S;
  float* dst = a.clv + (size_t)op.parent * RS * S;
  const float* pl = a.pmat + (size_t)op.m1 * RS * s;
  const float* pr = a.pmat + (size_t)op.m2 * RS * s;
  float m = 0.0f;
  for (int r = 0; r < a.rates; ++r) {
    __syncthreads();  // the previous rate's reads of sp and sc are done
    for (int k = threadIdx.x; k < s * s; k += kWarps * 32) {
      sp[0][k] = __ldg(pl + (size_t)r * s * s + k);
      sp[1][k] = __ldg(pr + (size_t)r * s * s + k);
    }
    for (int j = warp; j < s; j += kWarps) {
      const size_t at = (size_t)(r * s + j) * S + site;
      sc[0][j][lane] = in ? left[at] : 0.0f;
      sc[1][j][lane] = in ? right[at] : 0.0f;
    }
    __syncthreads();
    for (int i = warp; i < s; i += kWarps) {
      const float* p = sp[0] + i * s;
      const float* q = sp[1] + i * s;
      float ta = p[0] * sc[0][0][lane];
      float tb = q[0] * sc[1][0][lane];
      for (int j = 1; j < s; ++j) {
        ta += p[j] * sc[0][j][lane];
        tb += q[j] * sc[1][j][lane];
      }
      const float v = ta * tb;
      m = v > m ? v : m;
      if (in) dst[(size_t)(r * s + i) * S + site] = v;
    }
  }
  smax[warp][lane] = m;
  __syncthreads();
  if (warp == 0) {
    float mm = smax[0][lane];
    for (int w = 1; w < kWarps; ++w) mm = smax[w][lane] > mm ? smax[w][lane] : mm;
    const int rescale = op.has && mm < a.threshold;
    sflag[lane] = rescale;
    if (in) write_scaler(a, op, site, rescale);
  }
  __syncthreads();
  if (in && sflag[lane]) {
    for (int k = warp; k < RS; k += kWarps) dst[(size_t)k * S + site] *= a.factor;
  }
}

}  // namespace

// Launches one level of `n_ops` ops on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int pll_level_update(float* clv, int* scaler, const float* pmat,
                                const int* table, int ld, int n_ops, int sites,
                                int rates, int states, float threshold,
                                float factor, void* stream) {
  Args a{clv, scaler, pmat, table, ld, sites, rates, states, threshold, factor};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4 && rates == 4) {
    const dim3 grid((sites + kFixedBlock - 1) / kFixedBlock, n_ops);
    level_fixed<4, 4><<<grid, kFixedBlock, 0, st>>>(a);
  } else {
    const dim3 grid((sites + kTile - 1) / kTile, n_ops);
    level_generic<<<grid, kWarps * 32, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
