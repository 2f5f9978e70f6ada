// The whole postorder traversal of a tree in one launch, row layout: one
// thread block per tile of 32 alignment sites.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_fused.py:_fused_kernel, the
// row-layout kernel that libpll2_tpu runs for alphabets of 16 or more states
// (proteins), with per-site scalers and tips from state codes. Called through
// libpll2_tpu_torch/ops/fused.py:fused_traversal_rows, which also holds the
// plain PyTorch version (fused_traversal_reference) that this must agree
// with.
//
// What it computes: the contract of fused_traversal.cu, for any states <= 32
// and any number of rate categories R. An op table [n_ops + 1, 8] int32 from
// pack_fused_schedule: row k < n_ops is
//   [pslot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2, has_scaler]
// and row n_ops is the root edge [p_is_tip, p_idx, c_is_tip, c_idx, 0...].
// For each op and rate r: x[r,i] = (sum_j P[m1,r,i,j] left[r,j])
//                                * (sum_j P[m2,r,i,j] right[r,j]).
// If has_scaler and max over all (r, i) of x < threshold, x *= factor and the
// site's count grows by one; counts of the children are added (tips count
// 0). Tip children are int32 bitmasks (bit j = state j), the same for every
// rate. Only the root edge's two CLVs [R, s, S] and counts [S] are written.
// With `bf16` set (the 'bf16' contraction mode), P and every inner-child CLV
// value are rounded to bf16 by (bits + 0x8000) & 0xFFFF0000 before use, the
// same bit operation as ops/fused.py:round_bf16; a product of two such values
// is exact in float32, so kernel and plain version differ only in the order
// of their float32 sums, as in the exact mode.
//
// Design. A block owns kTile = 32 consecutive sites, one per lane, and
// kWarps = 8 warps. For each op, and for each chunk of rc rates (rc = R
// unless the shared-memory tile of a large R * s needs chunks):
//   1. stage the chunk's rate blocks of P[m1] and P[m2] in shared memory (rows
//      padded to a multiple of 4 for float4 reads; 12.8 KB at LG+G4) and both
//      children's [rc * s, 32] columns (a tip is decoded once into s rows
//      that every rate reads);
//   2. __syncthreads(); each warp takes items (rate, block of kRowBlock
//      output rows): both matvecs for its 32 sites, their product into the
//      op's output tile x_sm [R * s, 32] in shared memory, and a running max;
//   3. __syncthreads() before the next chunk overwrites the staging buffers.
// Then the per-site max is reduced across warps in shared memory, and after
// a barrier every warp scales its rows and stores the parent into its slot.
// Inside a warp, P reads are one broadcast address and child reads 32
// consecutive floats: no bank conflicts.
//
// Slot reuse. pack_fused_schedule frees a dying child's slot before it
// allocates the parent, so a parent may take the slot of a child it reads.
// Every read of an op's children (step 1, all chunks) comes before the
// barrier that precedes the first store of its parent, and the parent is
// built in shared memory, so this is safe; the barrier at the start of the
// next op makes the stores visible to the whole block before they are read.
//
// What bounds it on an H100. Per site and op, 2 * R * s * s FMAs (3200 at
// LG+G4): 6.6 GFLOP for 126 ops over 8192 sites, ~0.1 ms at the 67 TFLOP/s
// float32 peak of CUDA cores. Each FMA also costs about half a shared-memory
// load (a thread keeps kRowBlock rows' accumulators and reuses each child
// value across them; P comes as float4), and every op runs three block-wide
// barriers in series, so this first design is bound by shared-memory
// instruction throughput and the op chain's latency, not by device memory: slots (~2.6 MB each at
// 128 taxa x 8192 sites) stay in the 50 MB L2. Tensor cores (mma.sync or
// wgmma in bf16, a split for fp32-class accuracy) and slots in shared memory
// are for later work.
//
// Numerics: build without --use_fast_math (IEEE division, no flush to zero,
// so 2^-64 stays a normal float).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRow = 8;        // op table row width
constexpr int kTile = 32;      // sites per block: one per lane
constexpr int kWarps = 8;      // warps per block
constexpr int kThreads = kTile * kWarps;
constexpr int kRowBlock = 5;   // output rows per item (4 items per rate at 20 states)

struct Args {
  const int* table;    // [n_ops + 1, 8]
  int n_ops;
  const float* pmat;   // [E, R, s, s]
  const int* tips;     // [n_tips, S]
  int sites;
  int rates, states;
  float* slots;        // [n_slots, R * s, S]
  int* slot_sc;        // [n_slots, S]
  float* out_p;        // [R * s, S]
  float* out_c;
  int* sc_p;           // [S]
  int* sc_c;
  float threshold, factor;
  int bf16;
  int rate_chunk;      // rc: rates staged at once
};

__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

__device__ __forceinline__ float tip_bit(unsigned code, int j) {
  return static_cast<float>((code >> j) & 1u);
}

// Shared memory layout, in floats (the P rows stay 16-byte aligned):
//   p_sm [2][rc * s][sp]  (sp = s rounded up to 4)
//   c_sm [2][rc * s][kTile]
//   x_sm [R * s][kTile]
//   red  [kWarps][kTile]
__host__ __device__ inline size_t smem_floats(int rates, int states, int rc) {
  const int sp = (states + 3) & ~3;
  return (size_t)2 * rc * states * sp + (size_t)2 * rc * states * kTile +
         (size_t)rates * states * kTile + (size_t)kWarps * kTile;
}

__global__ void __launch_bounds__(kThreads) fused_rows(Args a) {
  extern __shared__ float4 smem_raw[];
  float* const smem = reinterpret_cast<float*>(smem_raw);
  const int s = a.states, R = a.rates, RS = R * s, RC = a.rate_chunk;
  const int sp = (s + 3) & ~3;
  float* const p_sm = smem;
  float* const c_sm = p_sm + 2 * RC * s * sp;
  float* const x_sm = c_sm + 2 * RC * s * kTile;
  float* const red = x_sm + RS * kTile;

  const int lane = threadIdx.x % kTile, warp = threadIdx.x / kTile;
  const size_t S = a.sites;
  const size_t site = (size_t)blockIdx.x * kTile + lane;
  const bool live = site < S;
  const int nb = (s + kRowBlock - 1) / kRowBlock;   // row blocks per rate

  for (int op = 0; op < a.n_ops; ++op) {
    const int* row = a.table + op * kRow;
    const int is_tip[2] = {__ldg(row + 1), __ldg(row + 4)};
    const int idx[2] = {__ldg(row + 2), __ldg(row + 5)};
    const int mat[2] = {__ldg(row + 3), __ldg(row + 6)};
    // the children's counts, read before any store of this op
    int sc = 0;
    if (warp == 0 && live) {
      for (int side = 0; side < 2; ++side) {
        if (!is_tip[side]) sc += a.slot_sc[(size_t)idx[side] * S + site];
      }
    }
    float m = 0.0f;   // this thread's max over its rows (x is non-negative)

    for (int r0 = 0; r0 < R; r0 += RC) {
      const int rc = R - r0 < RC ? R - r0 : RC;
      __syncthreads();   // the previous chunk or op is done with the buffers
      // 1. stage P and the children
      for (int side = 0; side < 2; ++side) {
        const float* src = a.pmat + ((size_t)mat[side] * R + r0) * s * s;
        float* dst = p_sm + side * RC * s * sp;
        for (int q = threadIdx.x; q < rc * s * sp; q += kThreads) {
          const int prow = q / sp, j = q - prow * sp;
          const float v = j < s ? __ldg(src + prow * s + j) : 0.0f;
          dst[q] = a.bf16 ? round_bf16(v) : v;
        }
        float* cdst = c_sm + side * RC * s * kTile;
        if (is_tip[side]) {
          const unsigned code =
              live ? static_cast<unsigned>(__ldg(a.tips + (size_t)idx[side] * S + site))
                   : 0u;
          for (int q = warp; q < s; q += kWarps) cdst[q * kTile + lane] = tip_bit(code, q);
        } else {
          const float* csrc = a.slots + ((size_t)idx[side] * RS + (size_t)r0 * s) * S + site;
          for (int q = warp; q < rc * s; q += kWarps) {
            const float v = live ? csrc[(size_t)q * S] : 0.0f;
            cdst[q * kTile + lane] = a.bf16 ? round_bf16(v) : v;
          }
        }
      }
      __syncthreads();

      // 2. items (rate rr, rows i0 .. i0 + kRowBlock) for this warp
      for (int item = warp; item < rc * nb; item += kWarps) {
        const int rr = item / nb, i0 = (item - rr * nb) * kRowBlock;
        const int nv = s - i0 < kRowBlock ? s - i0 : kRowBlock;
        const float* cl = c_sm + (is_tip[0] ? 0 : rr * s * kTile) + lane;
        const float* cr = c_sm + (RC + (is_tip[1] ? 0 : rr)) * s * kTile + lane;
        const float* pl = p_sm + (rr * s + i0) * sp;
        const float* pr = p_sm + (RC * s + rr * s + i0) * sp;
        float al[kRowBlock], ar[kRowBlock];
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) al[n] = ar[n] = 0.0f;
        int j = 0;
        for (; j + 4 <= s; j += 4) {
          float vl[4], vr[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            vl[q] = cl[(j + q) * kTile];
            vr[q] = cr[(j + q) * kTile];
          }
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            if (n < nv) {
              const float4 u = *reinterpret_cast<const float4*>(pl + n * sp + j);
              const float4 w = *reinterpret_cast<const float4*>(pr + n * sp + j);
              al[n] += u.x * vl[0] + u.y * vl[1] + u.z * vl[2] + u.w * vl[3];
              ar[n] += w.x * vr[0] + w.y * vr[1] + w.z * vr[2] + w.w * vr[3];
            }
          }
        }
        for (; j < s; ++j) {
          const float vl = cl[j * kTile], vr = cr[j * kTile];
#pragma unroll
          for (int n = 0; n < kRowBlock; ++n) {
            if (n < nv) {
              al[n] += pl[n * sp + j] * vl;
              ar[n] += pr[n * sp + j] * vr;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kRowBlock; ++n) {
          if (n < nv) {
            const float x = al[n] * ar[n];
            x_sm[((r0 + rr) * s + i0 + n) * kTile + lane] = x;
            m = x > m ? x : m;
          }
        }
      }
    }

    // 3. per-site max across warps, scale, store the parent
    red[warp * kTile + lane] = m;
    __syncthreads();
    float mx = red[lane];
    for (int w = 1; w < kWarps; ++w) {
      const float v = red[w * kTile + lane];
      mx = v > mx ? v : mx;
    }
    const bool scale = __ldg(row + 7) && mx < a.threshold;
    const float f = scale ? a.factor : 1.0f;
    if (live) {
      const int pslot = __ldg(row);
      float* dst = a.slots + (size_t)pslot * RS * S + site;
      for (int q = warp; q < RS; q += kWarps) dst[(size_t)q * S] = x_sm[q * kTile + lane] * f;
      if (warp == 0) a.slot_sc[(size_t)pslot * S + site] = sc + (scale ? 1 : 0);
    }
  }

  __syncthreads();   // the last op's stores, made by other warps
  if (!live) return;
  const int* root = a.table + a.n_ops * kRow;
  for (int end = 0; end < 2; ++end) {
    const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
    float* out = (end ? a.out_c : a.out_p) + site;
    int* osc = end ? a.sc_c : a.sc_p;
    if (is_tip) {
      const unsigned code = static_cast<unsigned>(__ldg(a.tips + (size_t)idx * S + site));
      for (int q = warp; q < RS; q += kWarps) out[(size_t)q * S] = tip_bit(code, q % s);
      if (warp == 0) osc[site] = 0;
    } else {
      const float* src = a.slots + (size_t)idx * RS * S + site;
      for (int q = warp; q < RS; q += kWarps) out[(size_t)q * S] = src[(size_t)q * S];
      if (warp == 0) osc[site] = a.slot_sc[(size_t)idx * S + site];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or an
// error code without launching when the shapes do not fit.
extern "C" int pll_fused_traversal_rows(const int* table, int n_ops,
                                        const float* pmat, const int* tips,
                                        int sites, int rates, int states,
                                        float* slots, int* slot_sc, int n_slots,
                                        float* out_p, float* out_c, int* sc_p,
                                        int* sc_c, float threshold, float factor,
                                        int bf16, void* stream) {
  (void)n_slots;
  if (states < 1 || states > 32 || rates < 1 || sites < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest rate chunk whose staging buffers fit beside the output tile
  int rc = rates;
  while (rc > 1 && smem_floats(rates, states, rc) * sizeof(float) > (size_t)max_smem) --rc;
  const size_t bytes = smem_floats(rates, states, rc) * sizeof(float);
  if (bytes > (size_t)max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{table, n_ops, pmat, tips, sites, rates, states, slots, slot_sc,
         out_p, out_c, sc_p, sc_c, threshold, factor, bf16, rc};
  const dim3 grid((sites + kTile - 1) / kTile);
  fused_rows<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
