// The whole postorder traversal of a tree in one launch, row layout: one
// thread block per tile of 32 alignment sites.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_fused.py:_fused_kernel, the
// row-layout kernel that libpll2_tpu runs for alphabets of 16 or more states
// (proteins), in all its modes: per-site or per-rate scalers, tips from state
// codes and from raw probability rows. Called through
// libpll2_tpu_torch/ops/fused.py:fused_traversal_rows, which also holds the
// plain PyTorch version (fused_traversal_reference) that this must agree
// with; the launcher (ops/_kernels.py:launch_fused_traversal_rows) picks the
// plan below with ops/_kernels.py:rows_plan.
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
// 0). A child's is_tip says what it is: 0 a slot, 1 a tip given by an int32
// bitmask (bit j = state j), 2 a row of the raw tip matrix ctips [n_ctips,
// s, S] (set_tip_clv tips); tips of both kinds are the same for every rate.
// In per-rate mode (rate_scalers != 0) each rate block's max is compared
// with the threshold on its own and counts are kept per rate. Only the root
// edge's two CLVs [R, s, S] and counts ([S], or [R, S] per rate) are
// written. With `bf16` set (the 'bf16' contraction mode), P and every
// inner-child CLV value are rounded to bf16 by (bits + 0x8000) & 0xFFFF0000
// before use, the same bit operation as ops/fused.py:round_bf16, and raw tip
// values to the nearest bf16, ties to even (ops/fused.py:round_bf16_rne, the
// astype(bfloat16) of JAX's kernel); a product of two such values is exact
// in float32, so kernel and plain version differ only in the order of their
// float32 sums, as in the exact mode.
//
// Candidates: as in fused_traversal.cu, one launch walks K tables (the
// table [K, n_ops + 1, 8], P [K, E, R, SP, SP], the spill plan's slots
// [K, n_slots, R * s, S] and the outputs gain a leading K; tip codes and raw
// tip rows are shared). Candidate k is blockIdx.y, whose blocks offset each
// per-candidate pointer by k strides (`candidate`); blockIdx.x stays the
// tile of sites. One topology is the case K = 1. One block of 64 sites an
// SM already fills the card at 128 x 8192, so a candidate costs what a walk
// alone does (PERF.md).
//
// Queries: as in fused_traversal.cu, Q queries (blockIdx.z) walk the K
// candidates in one launch, each reading tip row `query_row` from its own
// codes `qcodes + q * S` (`tip_row`) and every other row from the shared
// matrix; the outputs and the spill plan's slots are [Q, K, ...], the table
// and P per candidate. Without queries `query_row` is -1.
//
// Design. A block owns a tile of T = 32 * SPT consecutive sites for the
// whole walk (SPT = 1 or 2 sites a thread, 32 apart, one lane per site
// column) and kWarps = 8 warps. The warps form G groups of H = 8 / G (G the
// largest power of two <= min(R, 8)); group g takes the rates r = g (mod
// G), and warp h of a group a block of rows_per_warp output rows of each of
// them. P arrives padded to SP x SP (SP = 8, 16, 20, 24 or 32 >= s, the
// template argument; the launcher pads P on the card when s != SP). For
// each op and each rate of its group a thread
//   1. reads its sites' two child columns of that rate into registers (2 *
//      SPT * SP floats): a slot's rows, a tip whose code bits are selected
//      (not converted: I2F runs at a quarter of the FMA rate), or a raw
//      tip's rows from device memory;
//   2. runs kRows rows at a time (5 for SP = 20, else 4): each step of 4
//      columns reads 2 * kRows float4 of P from shared memory (one address
//      for the whole warp, a broadcast) and feeds 8 * kRows * SPT FMAs into
//      2 * kRows * SPT accumulators in registers;
//   3. stores each product x unscaled straight into the parent's rows and
//      keeps its running max.
// The maxima meet in shared memory ([warp][site] per site; [rate][h][site]
// per rate); after one barrier every thread decides its sites' (or its
// rates') rescale, multiplies its own stored rows by `factor` where needed
// (x * factor is the same float before or after the store) and the count
// is written by one thread per (site, count row).
//
// Two plans, one kernel body templated on where the slots live:
//   on-chip (ONCHIP): the block's slots [n_slots][R * s][T] and their
//     counts live in shared memory, beside two buffers of both P-matrices
//     (all rates) and both tip-code rows. Inner children and parents never
//     touch device memory: only P, tip codes, raw tips and the two root
//     outputs do. While op k computes, op k + 1's P blocks and tip codes are
//     copied into the other buffer with cp.async (16-byte copies of padded
//     P; 12.8 KB at LG+G4); each thread waits for its own copies, rounds
//     them in 'bf16', then the barrier that starts op k + 1 publishes them.
//     Two block-wide barriers an op: inputs ready, maxima written. At LG+G4
//     with 6 slots a tile of 64 sites takes 153,088 bytes (one block an
//     SM, up to 255 registers a thread) and a tile of 32 89,344 (two).
//     Two sites a thread halve P's shared loads per FMA; the launcher takes
//     them where tiles of 64 still give nearly every SM a block.
//   spill: where that does not fit in a block's shared memory (32 x 32, 16
//     rates x 32 states, a tree with many slots), the slots stay in device
//     memory [n_slots][R * s][S] as the launcher allocates them and P is
//     staged rate_chunk rates at a time (up to 64 KB), without prefetch: a
//     chunk after the first costs two more barriers. One site a thread.
// The launcher computes the plan and the shared-memory bytes
// (ops/_kernels.py:rows_plan); the entry below recomputes the bytes and
// refuses a launch whose layout it does not share.
//
// Slot reuse. pack_fused_schedule frees a dying child's slot before it
// allocates the parent, so a parent may take the slot of a child it reads.
// Rate r's parent rows overwrite only rate r's child rows of that slot, and
// those are read only by the H warps of the group that owns rate r. On an
// op whose parent takes a child's slot, each of those warps reads the
// rate's two child columns into registers and then waits at a named
// barrier of its group (bar.sync 1 + g, H * 32 threads) before it stores a
// row; other groups never touch those rows. A parent's count overwrites a
// child's count only by the thread that read that count before the op's
// second barrier. The barrier that starts the next op orders every store
// (and every rescale) before any read of the parent.
//
// What bounds it on an H100. Per site and op, 2 * R * s * s FMAs (3200 at
// LG+G4): 6.6 GFLOP for 126 ops over 8192 sites, ~0.1 ms at the 67 TFLOP/s
// float32 peak of CUDA cores. The ops run one after another and every warp
// of an SM reaches the same phase of an op at the same moment, so the
// phases do not overlap: the child loads and the epilogue (about half of
// the time before they were trimmed) and the FMA loop, which issues a
// 16-byte shared load for every 4 * SPT FMAs. Removing either barrier
// saves under 1 %. PERF.md has the measurements. Tensor cores for
// 'bf16' are later work.
//
// Numerics: build without --use_fast_math (IEEE division, no flush to zero,
// so 2^-64 stays a normal float).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRow = 8;        // op table row width
constexpr int kLanes = 32;
constexpr int kWarps = 8;      // warps per block
constexpr int kThreads = kLanes * kWarps;

struct Args {
  const int* table;    // [n_ops + 1, 8]
  int n_ops;
  const float* pmat;   // [E, R, SP, SP], zero-padded, 16-byte aligned
  const int* tips;     // [n_tips, S]
  const float* ctips;  // [n_ctips, s, S] raw tip rows, or null
  const int* qcodes;   // [Q, S] the queries' tip codes, or null
  int query_row;       // the tip row a query's codes replace (-1: none)
  int sites;
  int rates, states;
  float* slots;        // spill plan: [n_slots, R * s, S]
  int* slot_sc;        // spill plan: [n_slots, SR, S], SR = R per rate, else 1
  int n_slots;
  float* out_p;        // [R * s, S]
  float* out_c;
  int* sc_p;           // [SR, S]
  int* sc_c;
  float threshold, factor;
  int rate_scalers;
  int bf16;
  int rate_chunk;      // rates of P staged at once (all of them on chip)
  int groups;          // G
  int rows_per_warp;   // a multiple of kRows
  // the strides of the candidate axis (table, P) and of the walk axis
  // (slots, outputs), in elements (0 for the slots on chip)
  long long table_stride, pmat_stride, slot_stride, slot_sc_stride;
  long long out_stride, sc_stride;
};

// Candidate blockIdx.y's table and P, and walk (blockIdx.z, blockIdx.y)'s
// spilled slots.
struct Cand {
  const int* table;
  const float* pmat;
  float* slots;
  int* slot_sc;
};

__device__ __forceinline__ Cand candidate(const Args& a) {
  const long long k = blockIdx.y, w = (long long)blockIdx.z * gridDim.y + k;
  return {a.table + k * a.table_stride, a.pmat + k * a.pmat_stride,
          a.slots + w * a.slot_stride, a.slot_sc + w * a.slot_sc_stride};
}

// blockIdx.y, read where it is used: a volatile read keeps the compiler from
// computing the output offsets below at the kernel's start and holding them
// in registers over the walk (which took the two-sites-a-thread body to 255
// registers and a spill, 14 % slower at LG+G4; PERF.md has the measurements)
__device__ __forceinline__ unsigned cand_index() {
  unsigned k;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(k));
  return k;
}

// blockIdx.z, the query, read the same way
__device__ __forceinline__ unsigned query_index() {
  unsigned q;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(q));
  return q;
}

// the walk (query, candidate): blockIdx.z * gridDim.y + blockIdx.y
__device__ __forceinline__ long long walk_index() {
  unsigned n;
  asm volatile("mov.u32 %0, %%nctaid.y;" : "=r"(n));
  return (long long)query_index() * n + cand_index();
}

// the walk's root CLV rows of the parent (end 0) or child end
__device__ __forceinline__ float* out_clv(const Args& a, int end) {
  return (end ? a.out_c : a.out_p) + walk_index() * a.out_stride;
}

// and their counts
__device__ __forceinline__ int* out_sc(const Args& a, int end) {
  return (end ? a.sc_c : a.sc_p) + walk_index() * a.sc_stride;
}

// the state codes of tip row `idx`: the block's query's in place of row
// query_row
__device__ __forceinline__ const int* tip_row(const Args& a, int idx) {
  if (idx == a.query_row) return a.qcodes + (size_t)query_index() * a.sites;
  return a.tips + (size_t)idx * a.sites;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x8000u) & 0xFFFF0000u);
}

// to the nearest bf16, ties to even (finite x)
__device__ __forceinline__ float round_bf16_rne(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the warps of one group meet: barrier `id` (1-15) of `n` threads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory layout, in 4-byte words, for tiles of T = 32 * SPT sites
// (every part a multiple of 16 bytes; P first, so that its rows are 16-byte
// aligned):
//   P      [NB][2][rc][SP * SP] float   NB = 2 buffers on chip, 1 spilled
//   codes  [NB][2][T] int               the op's state-code tips
//   red    [kWarps][T] float, per rate [R][H][T]: the maxima
//   csc    [R][T] int, per rate only: the children's counts
//   on chip only:
//   slots  [n_slots][R * s][T] float
//   counts [n_slots][SR][T] int
// ops/_kernels.py:rows_plan computes the same bytes.
__host__ __device__ inline size_t smem_words(bool onchip, int spt, int sp,
                                             int rates, int states,
                                             int n_slots, int rate_scalers,
                                             int rc, int groups) {
  const size_t nb = onchip ? 2 : 1, h = kWarps / groups, tile = kLanes * spt;
  size_t w = nb * 2 * rc * sp * sp + nb * 2 * tile;
  w += rate_scalers ? (size_t)rates * h * tile + (size_t)rates * tile
                    : (size_t)kWarps * tile;
  if (onchip) {
    const size_t sr = rate_scalers ? rates : 1;
    w += (size_t)n_slots * rates * states * tile + (size_t)n_slots * sr * tile;
  }
  return w;
}

// Rates r0 .. r0+nr-1 of P[m1] and P[m2] ([nr][SP * SP] each, side stride
// rc * SP * SP) into `dst` with 16-byte cp.async copies by all threads,
// blocks starting at different offsets (`rot`) so that the blocks of one op
// spread over P's cache lines. With `round` set, instead of copying, each
// thread rounds to bf16 the units it copied (after its copies landed).
template <int SP>
__device__ __forceinline__ void stage_p(float* dst, const float* pmat, int m1,
                                        int m2, int R, int r0, int nr, int rc,
                                        bool round) {
  constexpr int PP = SP * SP;
  const int n4 = nr * (PP / 4), n = 2 * n4;
  const int rot = (int)((size_t)blockIdx.x * kThreads % n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i + rot < n ? i + rot : i + rot - n;
    const int side = k >= n4, kk = k - side * n4;
    float4* d = reinterpret_cast<float4*>(dst + (size_t)side * rc * PP) + kk;
    if (round) {
      float4 v = *d;
      v.x = round_bf16(v.x);
      v.y = round_bf16(v.y);
      v.z = round_bf16(v.z);
      v.w = round_bf16(v.w);
      *d = v;
    } else {
      const float4* src = reinterpret_cast<const float4*>(
                              pmat + ((size_t)(side ? m2 : m1) * R + r0) * PP) + kk;
      cp_async16(d, src);
    }
  }
}

// The op's state-code tips of the tile's `tile` sites from `tile0` on into
// `dst` [2][tile] (0 past the last site).
__device__ __forceinline__ void stage_codes(int* dst, const Args& a,
                                            const int* row, size_t S,
                                            size_t tile0, int tile) {
  if (threadIdx.x >= 2 * tile) return;
  const int side = threadIdx.x / tile, col = threadIdx.x % tile;
  if (__ldg(row + 1 + 3 * side) != 1) return;
  const size_t site = tile0 + col;
  int* d = dst + side * tile + col;
  if (site < S) {
    cp_async4(d, tip_row(a, __ldg(row + 2 + 3 * side)) + site);
  } else {
    *d = 0;
  }
}

// One child's column of rate r at the thread's SPT sites (32 apart) into
// registers: a slot's rows (`slot` points at the rate's row 0 of the first
// site, rows `rstride` apart; read where `ok`), a decoded tip code, or a raw
// tip's rows (read where the site is `live`); zero past the state count,
// where P's padded columns are zero too. A tip's bit is selected, not
// converted (I2F runs at a quarter of the FMA rate), and the mode is tested
// once, outside the unrolled loads.
template <int SP, int SPT>
__device__ __forceinline__ void load_child(float (&c)[SPT][SP], int is_tip,
                                           const float* slot, size_t rstride,
                                           const unsigned (&code)[SPT],
                                           const float* raw, size_t S, int s,
                                           const bool (&ok)[SPT],
                                           const bool (&live)[SPT], bool bf16) {
  if (is_tip == 1) {   // bits at and above s are 0 (and meet zero columns)
#pragma unroll
    for (int k = 0; k < SPT; ++k)
#pragma unroll
      for (int j = 0; j < SP; ++j) c[k][j] = (code[k] >> j) & 1u ? 1.0f : 0.0f;
  } else if (is_tip == 2) {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
#pragma unroll
      for (int j = 0; j < SP; ++j) {
        c[k][j] = (live[k] && j < s) ? __ldg(raw + (size_t)j * S + kLanes * k) : 0.0f;
      }
    if (bf16) {
#pragma unroll
      for (int k = 0; k < SPT; ++k)
#pragma unroll
        for (int j = 0; j < SP; ++j) c[k][j] = round_bf16_rne(c[k][j]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
#pragma unroll
      for (int j = 0; j < SP; ++j) {
        c[k][j] = (ok[k] && j < s) ? slot[(size_t)j * rstride + kLanes * k] : 0.0f;
      }
    if (bf16) {
#pragma unroll
      for (int k = 0; k < SPT; ++k)
#pragma unroll
        for (int j = 0; j < SP; ++j) c[k][j] = round_bf16(c[k][j]);
    }
  }
}

template <int SP, int SPT, bool ONCHIP>
__global__ void __launch_bounds__(kThreads, SPT == 1 ? 2 : 1) fused_rows(Args a) {
  const Cand cand = candidate(a);
  constexpr int PP = SP * SP;
  constexpr int kRows = SP % 5 == 0 ? 5 : 4;  // rows of P a step
  constexpr int NB = ONCHIP ? 2 : 1;
  constexpr int T = kLanes * SPT;             // sites a block
  extern __shared__ float4 smem_raw[];
  float* const pbuf = reinterpret_cast<float*>(smem_raw);
  const int s = a.states, R = a.rates, RS = R * s, RC = a.rate_chunk;
  const int G = a.groups, H = kWarps / G;
  const int SR = a.rate_scalers ? R : 1;
  int* const codes = reinterpret_cast<int*>(pbuf + (size_t)NB * 2 * RC * PP);
  float* const red = reinterpret_cast<float*>(codes + NB * 2 * T);
  int* const csc = reinterpret_cast<int*>(red + (a.rate_scalers ? R * H : kWarps) * T);
  float* const sslots = reinterpret_cast<float*>(csc + (a.rate_scalers ? R * T : 0));
  int* const scnt = reinterpret_cast<int*>(sslots + (size_t)a.n_slots * RS * T);

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int g = warp / H, h = warp % H;
  const size_t S = a.sites;
  const size_t tile0 = (size_t)blockIdx.x * T;
  const size_t site = tile0 + lane;   // the thread's sites: site + 32 k
  bool live[SPT], ok[SPT];   // ok: the thread may touch that slot column
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    live[k] = site + kLanes * k < S;
    ok[k] = ONCHIP || live[k];
  }
  // a slot's rows are `rstride` words apart; slot k starts k * sstride on
  const size_t rstride = ONCHIP ? (size_t)T : S;
  const size_t sstride = (size_t)RS * rstride;
  float* const slot0 = ONCHIP ? sslots + lane : cand.slots + site;
  int* const cnt0 = ONCHIP ? scnt + lane : cand.slot_sc + site;
  const int row0 = h * a.rows_per_warp;
  const int row1 = min(s, row0 + a.rows_per_warp);
  const int nr0 = min(RC, R);   // rates of the first chunk

  if (a.n_ops > 0) {
    const int* row = cand.table;
    stage_p<SP>(pbuf, cand.pmat, __ldg(row + 3), __ldg(row + 6), R, 0, nr0, RC, false);
    stage_codes(codes, a, row, S, tile0, T);
    cp_async_commit();
  }
  for (int op = 0; op < a.n_ops; ++op) {
    const int* row = cand.table + op * kRow;
    const int is_tip[2] = {__ldg(row + 1), __ldg(row + 4)};
    const int idx[2] = {__ldg(row + 2), __ldg(row + 5)};
    const int mat[2] = {__ldg(row + 3), __ldg(row + 6)};
    const int pslot = __ldg(row), has = __ldg(row + 7);
    float* const pb = pbuf + (size_t)(ONCHIP ? op & 1 : 0) * 2 * RC * PP;
    const int* const cb = codes + (ONCHIP ? op & 1 : 0) * 2 * T;
    cp_async_wait_all();
    if (a.bf16) stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, 0, nr0, RC, true);
    __syncthreads();   // A: this op's inputs are in, the last op's parent stored
    if (ONCHIP && op + 1 < a.n_ops) {   // prefetch the next op's inputs
      const int* next = row + kRow;
      float* nb = pbuf + (size_t)((op + 1) & 1) * 2 * RC * PP;
      stage_p<SP>(nb, cand.pmat, __ldg(next + 3), __ldg(next + 6), R, 0, R, RC, false);
      stage_codes(codes + ((op + 1) & 1) * 2 * T, a, next, S, tile0, T);
      cp_async_commit();
    }
    const bool reuse = H > 1 && ((is_tip[0] == 0 && idx[0] == pslot) ||
                                 (is_tip[1] == 0 && idx[1] == pslot));
    // the children's counts, read before the op's second barrier by the
    // thread that later writes the parent's count
    int sc[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) sc[k] = 0;
    if (a.rate_scalers) {
      if (h == 0) {
        for (int r = g; r < R; r += G) {
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            int c = 0;
            for (int side = 0; side < 2; ++side) {
              if (is_tip[side] == 0 && ok[k]) {
                c += cnt0[((size_t)idx[side] * SR + r) * rstride + kLanes * k];
              }
            }
            csc[r * T + lane + kLanes * k] = c;
          }
        }
      }
    } else if (warp == 0) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        for (int side = 0; side < 2; ++side) {
          if (is_tip[side] == 0 && ok[k]) sc[k] += cnt0[(size_t)idx[side] * rstride + kLanes * k];
        }
      }
    }
    unsigned code[2][SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      code[0][k] = is_tip[0] == 1 ? static_cast<unsigned>(cb[lane + kLanes * k]) : 0u;
      code[1][k] = is_tip[1] == 1 ? static_cast<unsigned>(cb[T + lane + kLanes * k]) : 0u;
    }
    float m[SPT];   // this thread's max over its rows (x is non-negative)
#pragma unroll
    for (int k = 0; k < SPT; ++k) m[k] = 0.0f;

    for (int r0 = 0; r0 < R; r0 += RC) {
      const int nr = min(RC, R - r0);
      if (r0 > 0) {   // spill plan: the next chunk of P
        __syncthreads();
        stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, r0, nr, RC, false);
        cp_async_commit();
        cp_async_wait_all();
        if (a.bf16) stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, r0, nr, RC, true);
        __syncthreads();
      }
      // this group's rates in the chunk: r = g (mod G)
      for (int r = r0 + ((g - r0) % G + G) % G; r < r0 + nr; r += G) {
        float cl[SPT][SP], cr[SPT][SP];
        const float* raw[2];
        for (int side = 0; side < 2; ++side)
          raw[side] = is_tip[side] == 2 ? a.ctips + (size_t)idx[side] * s * S + site : nullptr;
        load_child<SP, SPT>(cl, is_tip[0], slot0 + idx[0] * sstride + (size_t)r * s * rstride,
                            rstride, code[0], raw[0], S, s, ok, live, a.bf16);
        load_child<SP, SPT>(cr, is_tip[1], slot0 + idx[1] * sstride + (size_t)r * s * rstride,
                            rstride, code[1], raw[1], S, s, ok, live, a.bf16);
        if (reuse) group_sync(1 + g, H * kLanes);
        const float4* p = reinterpret_cast<const float4*>(pb + (size_t)(r - r0) * PP);
        const float4* q = reinterpret_cast<const float4*>(pb + (size_t)(RC + r - r0) * PP);
        float* dst = slot0 + pslot * sstride + (size_t)r * s * rstride;
        float mr[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) mr[k] = 0.0f;
#pragma unroll 1
        for (int i0 = row0; i0 < row1; i0 += kRows) {
          float ta[kRows][SPT], tb[kRows][SPT];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int k = 0; k < SPT; ++k) ta[i][k] = tb[i][k] = 0.0f;
#pragma unroll
          for (int j = 0; j < SP / 4; ++j) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float4 u = p[(i0 + i) * (SP / 4) + j];
              const float4 v = q[(i0 + i) * (SP / 4) + j];
#pragma unroll
              for (int k = 0; k < SPT; ++k) {
                ta[i][k] = fmaf(u.x, cl[k][4 * j], ta[i][k]);
                tb[i][k] = fmaf(v.x, cr[k][4 * j], tb[i][k]);
                ta[i][k] = fmaf(u.y, cl[k][4 * j + 1], ta[i][k]);
                tb[i][k] = fmaf(v.y, cr[k][4 * j + 1], tb[i][k]);
                ta[i][k] = fmaf(u.z, cl[k][4 * j + 2], ta[i][k]);
                tb[i][k] = fmaf(v.z, cr[k][4 * j + 2], tb[i][k]);
                ta[i][k] = fmaf(u.w, cl[k][4 * j + 3], ta[i][k]);
                tb[i][k] = fmaf(v.w, cr[k][4 * j + 3], tb[i][k]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (i0 + i < row1) {
#pragma unroll
              for (int k = 0; k < SPT; ++k) {
                const float x = ta[i][k] * tb[i][k];
                mr[k] = x > mr[k] ? x : mr[k];
                if (ok[k]) dst[(size_t)(i0 + i) * rstride + kLanes * k] = x;
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          if (a.rate_scalers) {
            red[(r * H + h) * T + lane + kLanes * k] = mr[k];
          } else {
            m[k] = mr[k] > m[k] ? mr[k] : m[k];
          }
        }
      }
    }
    if (!a.rate_scalers) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) red[warp * T + lane + kLanes * k] = m[k];
    }
    __syncthreads();   // B: the maxima are in

    // rescale the thread's own rows where needed, then the counts
    float* const dst = slot0 + pslot * sstride;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int col = lane + kLanes * k;
      if (a.rate_scalers) {
        for (int r = g; r < R; r += G) {
          float mr = 0.0f;
          for (int hh = 0; hh < H; ++hh) {
            const float v = red[(r * H + hh) * T + col];
            mr = v > mr ? v : mr;
          }
          const int flag = has && mr < a.threshold;
          if (flag && ok[k]) {
            for (int i = row0; i < row1; ++i) {
              dst[(size_t)(r * s + i) * rstride + kLanes * k] *= a.factor;
            }
          }
          if (h == 0 && ok[k]) {
            cnt0[((size_t)pslot * SR + r) * rstride + kLanes * k] = csc[r * T + col] + flag;
          }
        }
      } else {
        float mx = red[col];
        for (int w = 1; w < kWarps; ++w) {
          const float v = red[w * T + col];
          mx = v > mx ? v : mx;
        }
        const bool scale = has && mx < a.threshold;
        if (scale && ok[k]) {
          for (int r = g; r < R; r += G) {
            for (int i = row0; i < row1; ++i) {
              dst[(size_t)(r * s + i) * rstride + kLanes * k] *= a.factor;
            }
          }
        }
        if (warp == 0 && ok[k]) cnt0[(size_t)pslot * rstride + kLanes * k] = sc[k] + (scale ? 1 : 0);
      }
    }
    if (!ONCHIP && op + 1 < a.n_ops) {   // spill plan: the next op's first chunk
      const int* next = row + kRow;
      // every thread is done with the buffer: its last readers passed B
      stage_p<SP>(pb, cand.pmat, __ldg(next + 3), __ldg(next + 6), R, 0, nr0, RC, false);
      stage_codes(codes, a, next, S, tile0, T);
      cp_async_commit();
    }
  }

  __syncthreads();   // the last op's stores and rescales, made by other warps
  const int* root = cand.table + a.n_ops * kRow;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    if (!live[k]) continue;
    const size_t sk = site + kLanes * k;
    for (int end = 0; end < 2; ++end) {
      const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
      float* out = out_clv(a, end) + sk;
      int* osc = out_sc(a, end);
      if (is_tip == 1) {
        const unsigned code = static_cast<unsigned>(__ldg(tip_row(a, idx) + sk));
        for (int q = warp; q < RS; q += kWarps) {
          out[(size_t)q * S] = (code >> (q % s)) & 1u ? 1.0f : 0.0f;
        }
      } else if (is_tip == 2) {
        const float* src = a.ctips + (size_t)idx * s * S + sk;
        for (int q = warp; q < RS; q += kWarps) out[(size_t)q * S] = __ldg(src + (size_t)(q % s) * S);
      } else {
        const float* src = slot0 + idx * sstride + kLanes * k;
        for (int q = warp; q < RS; q += kWarps) out[(size_t)q * S] = src[(size_t)q * rstride];
      }
      for (int r = warp; r < SR; r += kWarps) {
        osc[r * S + sk] = is_tip ? 0 : cnt0[((size_t)idx * SR + r) * rstride + kLanes * k];
      }
    }
  }
}

template <int SP, int SPT, bool ONCHIP>
int launch(const Args& a, int n_cand, int n_query, size_t bytes,
           cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_rows<SP, SPT, ONCHIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile = kLanes * SPT;
  const dim3 grid((a.sites + tile - 1) / tile, n_cand, n_query);
  fused_rows<SP, SPT, ONCHIP><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the plans: on chip with one or two sites a thread, or spilled (one)
template <int SP>
int launch_plan(const Args& a, int n_cand, int n_query, bool onchip, int spt,
                size_t bytes, cudaStream_t stream) {
  if (!onchip) return launch<SP, 1, false>(a, n_cand, n_query, bytes, stream);
  return spt == 2 ? launch<SP, 2, true>(a, n_cand, n_query, bytes, stream)
                  : launch<SP, 1, true>(a, n_cand, n_query, bytes, stream);
}

}  // namespace

// The largest dynamic shared memory a block of the current device may ask
// for (the opt-in limit), in bytes, or a negative CUDA error code.
extern "C" int pll_rows_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or an
// error code without launching when the shapes or the plan do not fit.
// `n_cand` candidates (1 to 65,535, the grid's y) each have a table and a
// padded P, `table_stride` and `pmat_stride` elements apart (P's 16-byte
// aligned for each). `n_query` queries (1 to 65,535, the grid's z) replace
// tip row `query_row` by their codes `qcodes` [n_query, S]; without queries
// `qcodes` is null, `query_row` -1 and `n_query` 1. The outputs are
// [n_query, n_cand, R * s, S] and [n_query, n_cand, SR, S], the spill plan's
// slots [n_query * n_cand, n_slots, R * s, S] and their counts [n_query *
// n_cand, n_slots, SR, S]. The trailing arguments are the launcher's plan
// (ops/_kernels.py:rows_plan): on chip or spilled, sites a thread, SP, the
// rates of P staged at once, the warp groups and the shared-memory bytes,
// which must equal this file's own count.
extern "C" int pll_fused_traversal_rows(const int* table, int n_ops,
                                        const float* pmat, int n_cand,
                                        long long table_stride,
                                        long long pmat_stride, const int* tips,
                                        const float* ctips, const int* qcodes,
                                        int query_row, int n_query, int sites,
                                        int rates,
                                        int states, float* slots, int* slot_sc,
                                        int n_slots, float* out_p, float* out_c,
                                        int* sc_p, int* sc_c, float threshold,
                                        float factor, int rate_scalers, int bf16,
                                        void* stream, int onchip,
                                        int sites_per_thread, int padded_states,
                                        int rate_chunk, int groups,
                                        long long smem_bytes) {
  const int sp = padded_states, spt = sites_per_thread;
  const bool sp_ok = sp == 8 || sp == 16 || sp == 20 || sp == 24 || sp == 32;
  const bool g_ok = groups == 1 || groups == 2 || groups == 4 || groups == 8;
  if (states < 1 || states > sp || !sp_ok || rates < 1 || sites < 1 ||
      n_ops < 0 || n_slots < 1 || !g_ok || rate_chunk < 1 ||
      rate_chunk > rates || (onchip && rate_chunk != rates) ||
      !(spt == 1 || (spt == 2 && onchip)) ||
      (!onchip && (slots == nullptr || slot_sc == nullptr)) ||
      (reinterpret_cast<size_t>(pmat) & 15) != 0 || n_cand < 1 ||
      n_cand > 65535 || n_query < 1 || n_query > 65535 ||
      (qcodes == nullptr) != (query_row < 0) ||
      (qcodes == nullptr && n_query != 1) ||
      table_stride < (long long)(n_ops + 1) * kRow ||
      pmat_stride < 0 || pmat_stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_words(onchip != 0, spt, sp, rates, states, n_slots,
                                  rate_scalers, rate_chunk, groups) * 4;
  const int max_smem = pll_rows_smem_optin();
  if (max_smem < 0) return -max_smem;
  if (bytes != static_cast<size_t>(smem_bytes) || bytes > (size_t)max_smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_rows = sp % 5 == 0 ? 5 : 4;
  const int h = kWarps / groups;
  const int rows = (states + h - 1) / h;
  const long long S = sites, RS = (long long)rates * states;
  const long long SR = rate_scalers ? rates : 1;
  Args a{table, n_ops, pmat, tips, ctips, qcodes, query_row, sites, rates, states, slots, slot_sc,
         onchip ? n_slots : 0, out_p, out_c, sc_p, sc_c, threshold, factor,
         rate_scalers, bf16, rate_chunk, groups,
         (rows + k_rows - 1) / k_rows * k_rows, table_stride, pmat_stride,
         onchip ? 0 : n_slots * RS * S, onchip ? 0 : n_slots * SR * S, RS * S,
         SR * S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sp) {
    case 8: return launch_plan<8>(a, n_cand, n_query, onchip != 0, spt, bytes, st);
    case 16: return launch_plan<16>(a, n_cand, n_query, onchip != 0, spt, bytes, st);
    case 20: return launch_plan<20>(a, n_cand, n_query, onchip != 0, spt, bytes, st);
    case 24: return launch_plan<24>(a, n_cand, n_query, onchip != 0, spt, bytes, st);
    default: return launch_plan<32>(a, n_cand, n_query, onchip != 0, spt, bytes, st);
  }
}
