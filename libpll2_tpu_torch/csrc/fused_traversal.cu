// The whole postorder traversal of a tree in one launch, per alignment site.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_fused.py:_fused_kernel_planes
// in all its modes: per-site or per-rate scalers (`rate_scalers`), tips from
// state codes and from raw probability rows (`has_ctips` there). Called
// through libpll2_tpu_torch/ops/fused.py:fused_traversal, which also holds the
// plain PyTorch version (fused_traversal_reference) that this must agree with.
//
// What it computes. An op table [n_ops + 1, 8] int32 from
// pack_fused_schedule: row k < n_ops is
//   [pslot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2, has_scaler]
// and row n_ops is the root edge [p_is_tip, p_idx, c_is_tip, c_idx, 0...].
// For each op and rate r: x[r,i] = (sum_j P[m1,r,i,j] left[r,j])
//                                * (sum_j P[m2,r,i,j] right[r,j]).
// If has_scaler and max over all (r, i) of x < threshold, x *= factor and
// the site's count grows by one; counts of the children are added (tips
// count 0). In per-rate mode (rate_scalers != 0, PLL_ATTRIB_RATE_SCALERS)
// each rate block's max is compared with the threshold on its own, and each
// slot and root output keeps one count per rate. A child's is_tip says what
// it is: 0 a slot; 1 a tip given by an int32 bitmask (bit j set means state
// j, so a gap decodes to a CLV of ones); 2 a row of the raw tip matrix
// ctips [n_ctips, s, S] (set_tip_clv tips). Tips of both kinds are the same
// for every rate. Only the root edge's two CLVs [R, s, S] and counts ([S],
// or [R, S] per rate) are written out.
//
// Slot reuse. pack_fused_schedule frees a dying child's slot before it
// allocates the parent, so a parent may overwrite a child it reads. Every
// output of an op is computed (in registers, or in the spare slot for the
// generic instantiation) before any of it is stored, and a child's count of
// a rate is read before the parent's count of that rate is stored.
//
// What bounds it on an H100. Compute per site: 2 * R * s * s FMAs per op
// (128 for DNA GTR+G4) on one thread, and about 3 * R * s * 4 bytes of slot
// traffic per op, which stays in the 50 MB L2 (slots are ~30 x 16 x 16384 x
// 4 B = 31 MB at 128 taxa x 16384 sites). Raw tips add s floats per site and
// use (coalesced along sites), and per-rate counts R - 1 more ints per slot
// and op. One thread owns one site, so at 16384 sites the launch has only
// 16384 threads, about 124 per SM: too few to hide latency. This first
// design does nothing about that yet; more threads per site, slots and P in
// shared memory, and tensor cores are for later work.
//
// Numerics: build without --use_fast_math (IEEE division, no flush to zero,
// so 2^-64 stays a normal float). nvcc contracts a*b+c into FMAs, which
// rounds differently from PyTorch's CPU einsum; the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRow = 8;      // op table row width
constexpr int kBlock = 64;   // threads per block: 256 blocks at 16384 sites

struct Args {
  const int* table;    // [n_ops + 1, 8]
  int n_ops;
  const float* pmat;   // [E, R, s, s]
  const int* tips;     // [n_tips, S]
  const float* ctips;  // [n_ctips, s, S] raw tip rows, or null
  int sites;
  int rates, states;
  float* slots;        // [n_slots + 1, R * s, S]; the last is the spare
  int* slot_sc;        // [n_slots, SR, S], SR = R per rate, else 1
  int n_slots;
  float* out_p;        // [R * s, S]
  float* out_c;
  int* sc_p;           // [SR, S]
  int* sc_c;
  float threshold, factor;
  int rate_scalers;
};

__device__ __forceinline__ float tip_bit(unsigned code, int j) {
  return static_cast<float>((code >> j) & 1u);
}

// ---------------------------------------------------------------------------
// Sizes known at compile time: the CLVs of one op live in registers. NSC is
// the number of counts per site: 1, or R_ in per-rate mode.
template <int S_, int R_, int NSC>
__device__ __forceinline__ void matvec_child(const Args& a, int is_tip, int idx,
                                             int mat, size_t site,
                                             float (&out)[R_ * S_],
                                             int (&sc)[NSC]) {
  constexpr int RS = R_ * S_;
  const float* __restrict__ P = a.pmat + (size_t)mat * RS * S_;
  const size_t S = a.sites;
  if (is_tip != 0) {  // a tip, the same for every rate; it counts 0
    float c[S_];
    if (is_tip == 1) {
      const unsigned code = static_cast<unsigned>(__ldg(a.tips + idx * S + site));
#pragma unroll
      for (int j = 0; j < S_; ++j) c[j] = tip_bit(code, j);
    } else {
      const float* src = a.ctips + (size_t)idx * S_ * S + site;
#pragma unroll
      for (int j = 0; j < S_; ++j) c[j] = __ldg(src + j * S);
    }
#pragma unroll
    for (int r = 0; r < R_; ++r) {
#pragma unroll
      for (int i = 0; i < S_; ++i) {
        const float* p = P + (r * S_ + i) * S_;
        float acc = __ldg(p) * c[0];
#pragma unroll
        for (int j = 1; j < S_; ++j) acc += __ldg(p + j) * c[j];
        out[r * S_ + i] = acc;
      }
    }
    return;
  }
  const float* src = a.slots + (size_t)idx * RS * S + site;
  float c[RS];
#pragma unroll
  for (int k = 0; k < RS; ++k) c[k] = src[k * S];
#pragma unroll
  for (int r = 0; r < R_; ++r) {
#pragma unroll
    for (int i = 0; i < S_; ++i) {
      const float* p = P + (r * S_ + i) * S_;
      float acc = __ldg(p) * c[r * S_];
#pragma unroll
      for (int j = 1; j < S_; ++j) acc += __ldg(p + j) * c[r * S_ + j];
      out[r * S_ + i] = acc;
    }
  }
#pragma unroll
  for (int q = 0; q < NSC; ++q) sc[q] += a.slot_sc[((size_t)idx * NSC + q) * S + site];
}

template <int S_, int R_, int NSC>
__device__ __forceinline__ void write_root_fixed(const Args& a, int is_tip,
                                                 int idx, size_t site,
                                                 float* out, int* sc) {
  constexpr int RS = R_ * S_;
  const size_t S = a.sites;
  if (is_tip != 0) {
    float c[S_];
    if (is_tip == 1) {
      const unsigned code = static_cast<unsigned>(__ldg(a.tips + idx * S + site));
#pragma unroll
      for (int j = 0; j < S_; ++j) c[j] = tip_bit(code, j);
    } else {
      const float* src = a.ctips + (size_t)idx * S_ * S + site;
#pragma unroll
      for (int j = 0; j < S_; ++j) c[j] = __ldg(src + j * S);
    }
#pragma unroll
    for (int r = 0; r < R_; ++r) {
#pragma unroll
      for (int j = 0; j < S_; ++j) out[(r * S_ + j) * S + site] = c[j];
    }
#pragma unroll
    for (int q = 0; q < NSC; ++q) sc[q * S + site] = 0;
    return;
  }
  const float* src = a.slots + (size_t)idx * RS * S + site;
#pragma unroll
  for (int k = 0; k < RS; ++k) out[k * S + site] = src[k * S];
#pragma unroll
  for (int q = 0; q < NSC; ++q) {
    sc[q * S + site] = a.slot_sc[((size_t)idx * NSC + q) * S + site];
  }
}

template <int S_, int R_, int NSC>
__global__ void __launch_bounds__(kBlock) fused_fixed(Args a) {
  constexpr int RS = R_ * S_;
  constexpr int G = RS / NSC;  // rows per count: all of them, or one rate's
  const size_t site = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= (size_t)a.sites) return;
  const size_t S = a.sites;
  for (int op = 0; op < a.n_ops; ++op) {
    const int* row = a.table + op * kRow;
    float x[RS], y[RS];
    int sc[NSC];
#pragma unroll
    for (int q = 0; q < NSC; ++q) sc[q] = 0;
    matvec_child<S_, R_, NSC>(a, __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
                              site, x, sc);
    matvec_child<S_, R_, NSC>(a, __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),
                              site, y, sc);
    const int has = __ldg(row + 7);
#pragma unroll
    for (int q = 0; q < NSC; ++q) {
      float m = 0.0f;
#pragma unroll
      for (int k = q * G; k < (q + 1) * G; ++k) {
        x[k] *= y[k];
        m = x[k] > m ? x[k] : m;
      }
      if (has && m < a.threshold) {
#pragma unroll
        for (int k = q * G; k < (q + 1) * G; ++k) x[k] *= a.factor;
        sc[q] += 1;
      }
    }
    const int pslot = __ldg(row);
    float* dst = a.slots + (size_t)pslot * RS * S + site;
#pragma unroll
    for (int k = 0; k < RS; ++k) dst[k * S] = x[k];
#pragma unroll
    for (int q = 0; q < NSC; ++q) a.slot_sc[((size_t)pslot * NSC + q) * S + site] = sc[q];
  }
  const int* root = a.table + a.n_ops * kRow;
  write_root_fixed<S_, R_, NSC>(a, __ldg(root), __ldg(root + 1), site, a.out_p,
                                a.sc_p);
  write_root_fixed<S_, R_, NSC>(a, __ldg(root + 2), __ldg(root + 3), site,
                                a.out_c, a.sc_c);
}

// ---------------------------------------------------------------------------
// Sizes known at run time (any rates, states <= 32): each op is built in the
// spare slot a.n_slots, then scaled into its own slot, one count group (all
// rows, or one rate's rows in per-rate mode) after another.
__device__ __forceinline__ float child_entry(const Args& a, int is_tip,
                                             unsigned code, const float* src,
                                             int r, int j) {
  if (is_tip == 1) return tip_bit(code, j);
  if (is_tip == 2) return src[(size_t)j * a.sites];
  return src[(size_t)(r * a.states + j) * a.sites];
}

// (bitmask code, row pointer) of one child or root end at `site`
__device__ __forceinline__ const float* child_source(const Args& a, int is_tip,
                                                     int idx, size_t site,
                                                     unsigned* code) {
  const size_t S = a.sites;
  *code = 0;
  if (is_tip == 1) {
    *code = static_cast<unsigned>(__ldg(a.tips + idx * S + site));
    return nullptr;
  }
  if (is_tip == 2) return a.ctips + (size_t)idx * a.states * S + site;
  return a.slots + (size_t)idx * a.rates * a.states * S + site;
}

__global__ void __launch_bounds__(kBlock) fused_generic(Args a) {
  const size_t site = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= (size_t)a.sites) return;
  const size_t S = a.sites;
  const int s = a.states, RS = a.rates * a.states;
  const int SR = a.rate_scalers ? a.rates : 1, G = RS / SR;
  float* tmp = a.slots + (size_t)a.n_slots * RS * S + site;
  for (int op = 0; op < a.n_ops; ++op) {
    const int* row = a.table + op * kRow;
    for (int side = 0; side < 2; ++side) {
      const int is_tip = __ldg(row + 1 + 3 * side);
      const float* P = a.pmat + (size_t)__ldg(row + 3 + 3 * side) * RS * s;
      unsigned code;
      const float* src = child_source(a, is_tip, __ldg(row + 2 + 3 * side), site, &code);
      for (int r = 0; r < a.rates; ++r) {
        for (int i = 0; i < s; ++i) {
          const float* p = P + (r * s + i) * s;
          float acc = __ldg(p) * child_entry(a, is_tip, code, src, r, 0);
          for (int j = 1; j < s; ++j) {
            acc += __ldg(p + j) * child_entry(a, is_tip, code, src, r, j);
          }
          float* t = tmp + (size_t)(r * s + i) * S;
          *t = side ? *t * acc : acc;
        }
      }
    }
    const int pslot = __ldg(row), has = __ldg(row + 7);
    float* dst = a.slots + (size_t)pslot * RS * S + site;
    for (int q = 0; q < SR; ++q) {
      float m = 0.0f;
      for (int k = q * G; k < (q + 1) * G; ++k) {
        const float v = tmp[k * S];
        m = v > m ? v : m;
      }
      const int rescale = has && m < a.threshold;
      const float f = rescale ? a.factor : 1.0f;
      int sc = rescale;
      for (int side = 0; side < 2; ++side) {
        if (__ldg(row + 1 + 3 * side) == 0) {
          sc += a.slot_sc[((size_t)__ldg(row + 2 + 3 * side) * SR + q) * S + site];
        }
      }
      for (int k = q * G; k < (q + 1) * G; ++k) dst[k * S] = tmp[k * S] * f;
      a.slot_sc[((size_t)pslot * SR + q) * S + site] = sc;
    }
  }
  const int* root = a.table + a.n_ops * kRow;
  for (int end = 0; end < 2; ++end) {
    const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
    float* out = end ? a.out_c : a.out_p;
    int* osc = end ? a.sc_c : a.sc_p;
    unsigned code;
    const float* src = child_source(a, is_tip, idx, site, &code);
    for (int q = 0; q < SR; ++q) {
      osc[q * S + site] = is_tip ? 0 : a.slot_sc[((size_t)idx * SR + q) * S + site];
    }
    for (int r = 0; r < a.rates; ++r) {
      for (int j = 0; j < s; ++j) {
        out[(size_t)(r * s + j) * S + site] = child_entry(a, is_tip, code, src, r, j);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pll_fused_traversal(const int* table, int n_ops,
                                   const float* pmat, const int* tips,
                                   const float* ctips, int sites, int rates,
                                   int states, float* slots, int* slot_sc,
                                   int n_slots, float* out_p, float* out_c,
                                   int* sc_p, int* sc_c, float threshold,
                                   float factor, int rate_scalers,
                                   void* stream) {
  Args a{table, n_ops, pmat, tips, ctips, sites, rates, states, slots, slot_sc,
         n_slots, out_p, out_c, sc_p, sc_c, threshold, factor, rate_scalers};
  const dim3 grid((sites + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (states == 4 && rates == 4) {
    if (rate_scalers) {
      fused_fixed<4, 4, 4><<<grid, kBlock, 0, st>>>(a);
    } else {
      fused_fixed<4, 4, 1><<<grid, kBlock, 0, st>>>(a);
    }
  } else {
    fused_generic<<<grid, kBlock, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
