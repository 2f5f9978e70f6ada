// The 64-state body of the runtime-size level and pool kernels
// (level_update.cu's level_generic64, pool_update.cu's pool_generic64):
// alphabets of 33 to 64 states (codons: 61 sense codons), padded to 64.
//
// Why a body of its own. The runtime-size kernels hold a site's child
// entries of one rate in registers (2 x SP floats) and read P from shared
// memory. At SP = 64 that is 128 floats before the accumulators and P,
// past what a thread can keep without spilling. Here a thread copies its
// child entries of one rate into its own column of a shared-memory tile
// ([2][64][threads] floats, a column per thread: neighbouring lanes read
// neighbouring words, no bank conflicts), and then makes kGroup parent rows
// at a time, each group reading the children again from that tile and P
// (one rate of both matrices, zero-padded to 64 x 64: 32 KB) as float4
// broadcasts. A thread holds 2 x kGroup accumulators and 8 child values,
// not 128. A rate's children are in the tile before any of its parent
// rows is stored, so an op that writes its own child (the level kernel's
// in-place case) is still right.
//
// Shared memory: 32 KB of P and 64 KB of children for 128 threads, 96 KB a
// block, so two blocks an SM (the launch asks for more than the 48 KB
// default). P is staged one rate at a time, so every thread of a block
// works on the same rate, and a site's rates are never split over threads.
// Padded child entries are zero (j >= states), P's padded rows and columns
// too, and padded rows are never stored: 40 states give the same numbers as
// any other width would.
//
// Splitting a site's rows over up to 8 threads on narrow levels was tried
// on an H100 (PERF.md, Findings): a one-op level of the 61-state
// problem fell from 216 to 90 us, but every block then stages P for fewer
// sites, and the levels of 4 ops and more grew slower; the traversal went
// from 5.37 to 5.61 ms, so the simpler layout stays.
#pragma once

#include <cuda_runtime.h>

namespace states64 {

constexpr int kSP = 64;           // padded states
constexpr int kThreads = 128;     // a block: one site (class column) a thread
constexpr int kBlocksPerSm = 2;   // resident blocks an SM (shared memory)
constexpr int kGroup = 8;         // parent rows a thread makes at a time
constexpr int kPFloats = 2 * kSP * kSP;               // one rate of both P
constexpr int kChildFloats = 2 * kSP * kThreads;      // the children tile
constexpr int kSmemBytes = (kPFloats + kChildFloats) * (int)sizeof(float);

// One rate of one site: x[i] = (sum_j P1[i, j] cl[j]) * (sum_j P2[i, j]
// cr[j]) for i < s, each passed to `store(i, x)` unscaled; returns the
// largest x. `p` and `q` are P1 and P2 in shared memory ([64][16] float4),
// `cl` and `cr` the thread's child entries, `stride` floats apart (zero
// from s up to s rounded to 4).
template <class Store>
__device__ __forceinline__ float contract(const float4* p, const float4* q,
                                          const float* cl, const float* cr,
                                          int stride, int s, Store store) {
  float mx = 0.0f;
  const int n4 = (s + 3) >> 2;
  for (int i0 = 0; i0 < s; i0 += kGroup) {
    float ta[kGroup], tb[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) ta[i] = tb[i] = 0.0f;
#pragma unroll 2
    for (int j4 = 0; j4 < n4; ++j4) {
      float l[4], r[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        l[t] = cl[(4 * j4 + t) * stride];
        r[t] = cr[(4 * j4 + t) * stride];
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float4 u = p[(i0 + i) * (kSP / 4) + j4];
        const float4 v = q[(i0 + i) * (kSP / 4) + j4];
        ta[i] = fmaf(u.x, l[0], ta[i]);
        tb[i] = fmaf(v.x, r[0], tb[i]);
        ta[i] = fmaf(u.y, l[1], ta[i]);
        tb[i] = fmaf(v.y, r[1], tb[i]);
        ta[i] = fmaf(u.z, l[2], ta[i]);
        tb[i] = fmaf(v.z, r[2], tb[i]);
        ta[i] = fmaf(u.w, l[3], ta[i]);
        tb[i] = fmaf(v.w, r[3], tb[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i0 + i >= s) break;  // a padded row: not stored
      const float x = ta[i] * tb[i];
      mx = x > mx ? x : mx;
      store(i0 + i, x);
    }
  }
  return mx;
}

}  // namespace states64
