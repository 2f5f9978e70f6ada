// The whole postorder traversal of a tree in one launch, row layout: one
// thread block per tile of 32 or 64 alignment sites.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_fused.py:_fused_kernel, the
// row-layout kernel that libpll2_tpu runs for alphabets of 16 or more states
// (proteins), in all its modes: per-site or per-rate scalers, tips from state
// codes and from raw probability rows, and its three contraction modes.
// Called through libpll2_tpu_torch/ops/fused.py:fused_traversal_rows, which
// also holds the plain PyTorch version (fused_traversal_reference) that this
// must agree with; the launcher (ops/_kernels.py:launch_fused_traversal_rows)
// picks the plan below with ops/_kernels.py:rows_plan.
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
// written. The contraction (`mode`, ops/fused.py's module docstring):
//   0 'highest' -- exact float32 products and sums;
//   1 'bf16'    -- P and every inner-child CLV value rounded to bf16
//                  half-up ((bits + 0x8000) & 0xFFFF0000, ops/fused.py:
//                  round_bf16), raw tip values to the nearest bf16, ties to
//                  even (round_bf16_rne), code tips exact; float32 sums;
//   2 'split'   -- JAX's three-term product Ph.ch + Ph.cl + Pl.ch: P and
//                  every child split into bf16 pairs (hi half-up, lo the
//                  residual rounded to nearest even: ops/fused.py:
//                  split_bf16; a code tip's lo is 0); float32 sums.
// A product of two bf16 values is exact in float32, so in every mode the
// kernel and the plain version differ only in the order of their float32
// sums.
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
// Three plans (ops/_kernels.py:rows_plan picks one from the mode and the
// shape; the entry below recomputes the shared-memory bytes and refuses a
// launch whose layout it does not share):
//
// tc-on-chip ('bf16' and 'split', `fused_rows_tc`): the tensor cores. A
// block owns a tile of T = 64 sites, wgmma's M, for the whole walk, in two
// warpgroups that take the rates r = g (mod 2). For each op and rate a
// warpgroup issues D[64 sites, N] += A[64, 16] . B[16, N] (wgmma.cuh,
// Mma<N>::rs) for each child: A is the child transposed (sites x input
// states) as bf16 pairs in registers, B is P_r transposed (input states x
// output states), N the states padded to 8 (24 at 20 states). Row i of
// P_r is a K-major row of B, so P is staged as it is stored, one 128-byte
// swizzled row (64 bf16 k values, wgmma.cuh's sw128_byte layout) per output
// state and atom [side][rate]: k < N holds Ph and, in 'split', N <= k < 2N
// holds Pl, the rest zero. 'split' then runs the hi term as one K = 2N
// product, [ch | ch] against [Ph | Pl] (3 k steps at N = 24), and the lo
// term as a K = N product, cl against Ph (2 more); a code tip's lo is 0 and
// its lo term is skipped; 'bf16' runs ch against Ph (2 k steps).
//   wgmma's accumulator layout puts output state 8 j + 2 (lane % 4) + e of
//   site 16 w + lane / 4 + 8 h in the thread that holds input state 8 j +
//   2 (lane % 4) + e of the same site in A's register layout, so every
//   thread reads and writes only its own (site, state) positions of a
//   slot, for the rates of its warpgroup: both children's products land in
//   the same registers (x = left * right elementwise), the parent is stored
//   from them and read back as a child by the same thread, and a parent
//   that takes a child's slot needs no barrier (its thread read the child
//   before the wgmma). A tip's operands are the same for every rate and
//   are built once an op; a slot's next rate is read and split while the
//   tensor cores run this rate's products. A thread's addresses are laid
//   out once: its state 2 (lane % 4) at its first site is `col` words into
//   a rate's rows, and states below 16 need no bound check (s >= 16).
//   A site's maximum is a max over the thread's states,
//   two __shfl_xor_sync over lane % 4 and, per site, the two warpgroups'
//   maxima in shared memory (`red`); the rescale and the counts follow
//   after one block barrier, as below. Slots stay float32 in shared memory
//   [n_slots][R * s][T + 4]: 4 words of padding put the 4 states a warp's
//   quad reads on distinct banks. While op k computes, each thread loads
//   its share of op k + 1's P (its warpgroup's rates; all of it up to 4
//   rates, beyond that the rest when it splits them) into registers and,
//   once its warpgroup's last wgmma of op k has completed, splits it into
//   the single buffer of atoms (a proxy fence, then the op's barriers
//   publish it to the tensor cores); the op table's next two rows wait in
//   registers. Two block-wide barriers an op: inputs ready, maxima
//   written. The hot loop is kept short (about 1,500 instructions): the
//   kernel was issue- and latency-bound at two warps a scheduler, and
//   every cut in its code made it faster (PERF.md).
//
// on-chip ('highest'; 'bf16' and 'split' where the tensor-core layout does
// not fit, as with many slots: `fused_rows` with ONCHIP): CUDA-core FMAs,
// on rounded operands in 'bf16' and as the spill plan's two FMAs a term
// in 'split' (one site a thread). A block
// owns a tile of T = 32 * SPT consecutive sites (SPT = 1 or 2 sites a
// thread, 32 apart, one lane per site column) and kWarps = 8 warps. The
// warps form G groups of H = 8 / G (G the largest power of two <= min(R,
// 8)); group g takes the rates r = g (mod G), and warp h of a group a block
// of rows_per_warp output rows of each of them. P arrives padded to SP x SP
// (SP = 8, 16, 20, 24 or 32 >= s, the template argument; the launcher pads
// P on the card when s != SP). For each op and each rate of its group a
// thread
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
// is written by one thread per (site, count row). The block's slots
// [n_slots][R * s][T] and their counts live in shared memory, beside two
// buffers of both P-matrices (all rates) and both tip-code rows. Inner
// children and parents never touch device memory: only P, tip codes, raw
// tips and the two root outputs do. While op k computes, op k + 1's P
// blocks and tip codes are copied into the other buffer with cp.async
// (16-byte copies of padded P; 12.8 KB at LG+G4). At LG+G4 with 6 slots a
// tile of 64 sites takes 153,088 bytes (one block an SM, up to 255
// registers a thread) and a tile of 32 89,344 (two). Two sites a thread
// halve P's shared loads per FMA; the launcher takes them where tiles of 64
// still give nearly every SM a block.
//   Slot reuse. pack_fused_schedule frees a dying child's slot before it
//   allocates the parent, so a parent may take the slot of a child it
//   reads. Rate r's parent rows overwrite only rate r's child rows of that
//   slot, and those are read only by the H warps of the group that owns
//   rate r. On an op whose parent takes a child's slot, each of those warps
//   reads the rate's two child columns into registers and then waits at a
//   named barrier of its group (bar.sync 1 + g, H * 32 threads) before it
//   stores a row; other groups never touch those rows. A parent's count
//   overwrites a child's count only by the thread that read that count
//   before the op's second barrier. The barrier that starts the next op
//   orders every store (and every rescale) before any read of the parent.
//
// spill (every mode, `fused_rows` without ONCHIP): where no on-chip plan
// fits in a block's shared memory (16 rates x 32 states, a tree with many
// slots), the slots stay in device memory
// [n_slots][R * s][S] as the launcher allocates them and P is staged
// rate_chunk rates at a time (up to 64 KB), without prefetch: a chunk after
// the first costs two more barriers. One site a thread, the on-chip
// plan's FMA body: in 'bf16' on rounded operands, in 'split' on Ph and Pl
// (both staged) against ch + cl and ch, two FMAs a term where the tensor
// cores take three products (ch + cl is exact in float32).
//
// What bounds it on an H100. Per site and op, 2 * R * s * s multiply-adds
// (3200 at LG+G4): 6.6 GFLOP for 126 ops over 8192 sites, ~0.1 ms at the
// 67 TFLOP/s float32 peak of CUDA cores; on the tensor cores the same
// products take ~7 us at the 989 TFLOP/s bf16 peak in 'bf16' and ~20 us in
// 'split' (three terms), above the walk's ~3 us of bytes. The ops run one after
// another and every warp of an SM reaches the same phase of an op at the
// same moment, so the phases do not overlap: the child loads and the
// epilogue, and the contraction (the FMA loop, which issues a 16-byte
// shared load for every 4 * SPT FMAs; on the tensor cores a thread's
// conversion of its child values to bf16 pairs, 6 registers a child at N =
// 24, and the wgmmas). PERF.md has the measurements.
//
// Numerics: build without --use_fast_math (IEEE division, no flush to zero,
// so 2^-64 stays a normal float).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

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
  int mode;            // 0 'highest', 1 'bf16', 2 'split'
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

// Shared memory layout of the FMA plans, in 4-byte words, for tiles of T =
// 32 * SPT sites (every part a multiple of 16 bytes; P first, so that its
// rows are 16-byte aligned):
//   P      [NB][2][rc][SP * SP] float   NB = 2 buffers on chip, 1 spilled;
//                                       'split' (spilled) adds Pl's [2][rc]
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
                                             int rc, int groups, bool split) {
  const size_t nb = onchip ? 2 : 1, h = kWarps / groups, tile = kLanes * spt;
  size_t w = nb * 2 * rc * sp * sp * (split ? 2 : 1) + nb * 2 * tile;
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
// spread over P's cache lines. With `round` 1 or 2, instead of copying,
// each thread rounds to bf16 the units it copied (after its copies landed):
// 1 in place, 2 splits them, hi in place and lo 2 * rc * SP * SP words on.
template <int SP>
__device__ __forceinline__ void stage_p(float* dst, const float* pmat, int m1,
                                        int m2, int R, int r0, int nr, int rc,
                                        int round) {
  constexpr int PP = SP * SP;
  const int n4 = nr * (PP / 4), n = 2 * n4;
  const int rot = (int)((size_t)blockIdx.x * kThreads % n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = i + rot < n ? i + rot : i + rot - n;
    const int side = k >= n4, kk = k - side * n4;
    float4* d = reinterpret_cast<float4*>(dst + (size_t)side * rc * PP) + kk;
    if (round) {
      const float4 v = *d;
      const float4 hi = {round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                         round_bf16(v.w)};
      *d = hi;
      if (round == 2) {
        d[2 * rc * (PP / 4)] = {round_bf16_rne(v.x - hi.x), round_bf16_rne(v.y - hi.y),
                                round_bf16_rne(v.z - hi.z), round_bf16_rne(v.w - hi.w)};
      }
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

// 'split' on the FMA plans: a child's column c becomes ch + cl (exact in
// float32) and `h` gets ch, where `split` (a slot or a raw tip; a code tip's
// 0/1 is its own ch and its cl is 0)
template <int SP, int SPT>
__device__ __forceinline__ void split_column(float (&c)[SPT][SP], float (&h)[SPT][SP],
                                             bool split) {
#pragma unroll
  for (int k = 0; k < SPT; ++k)
#pragma unroll
    for (int j = 0; j < SP; ++j) {
      const float hi = split ? round_bf16(c[k][j]) : c[k][j];
      h[k][j] = hi;
      if (split) c[k][j] = hi + round_bf16_rne(c[k][j] - hi);
    }
}

// The FMA plans. SPLIT ('split', one site a thread): the staged P is Ph,
// with Pl 2 * RC * SP * SP words on in its buffer, and a child's column is
// ch + cl (exact in float32) beside ch, so that Ph (ch + cl) + Pl ch is two
// FMAs.
template <int SP, int SPT, bool ONCHIP, bool SPLIT>
__global__ void __launch_bounds__(kThreads, SPT == 1 && !SPLIT ? 2 : 1)
    fused_rows(Args a) {
  const Cand cand = candidate(a);
  constexpr int PP = SP * SP;
  constexpr int kRows = SP % 5 == 0 ? 5 : 4;  // rows of P a step
  constexpr int NB = ONCHIP ? 2 : 1;
  constexpr int PW = SPLIT ? 2 : 1;           // P's parts: Ph (and Pl)
  constexpr int T = kLanes * SPT;             // sites a block
  extern __shared__ float4 smem_raw[];
  float* const pbuf = reinterpret_cast<float*>(smem_raw);
  const int s = a.states, R = a.rates, RS = R * s, RC = a.rate_chunk;
  const int G = a.groups, H = kWarps / G;
  const int SR = a.rate_scalers ? R : 1;
  int* const codes = reinterpret_cast<int*>(pbuf + (size_t)NB * 2 * RC * PP * PW);
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
    float* const pb = pbuf + (size_t)(ONCHIP ? op & 1 : 0) * 2 * RC * PP * PW;
    const int* const cb = codes + (ONCHIP ? op & 1 : 0) * 2 * T;
    cp_async_wait_all();
    if (a.mode) stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, 0, nr0, RC, a.mode);
    __syncthreads();   // A: this op's inputs are in, the last op's parent stored
    if (ONCHIP && op + 1 < a.n_ops) {   // prefetch the next op's inputs
      const int* next = row + kRow;
      float* nb = pbuf + (size_t)((op + 1) & 1) * 2 * RC * PP * PW;
      stage_p<SP>(nb, cand.pmat, __ldg(next + 3), __ldg(next + 6), R, 0, R, RC, 0);
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
        stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, r0, nr, RC, 0);
        cp_async_commit();
        cp_async_wait_all();
        if (a.mode) stage_p<SP>(pb, cand.pmat, mat[0], mat[1], R, r0, nr, RC, a.mode);
        __syncthreads();
      }
      // this group's rates in the chunk: r = g (mod G)
      for (int r = r0 + ((g - r0) % G + G) % G; r < r0 + nr; r += G) {
        float cl[SPT][SP], cr[SPT][SP];
        const float* raw[2];
        for (int side = 0; side < 2; ++side)
          raw[side] = is_tip[side] == 2 ? a.ctips + (size_t)idx[side] * s * S + site : nullptr;
        load_child<SP, SPT>(cl, is_tip[0], slot0 + idx[0] * sstride + (size_t)r * s * rstride,
                            rstride, code[0], raw[0], S, s, ok, live, a.mode == 1);
        load_child<SP, SPT>(cr, is_tip[1], slot0 + idx[1] * sstride + (size_t)r * s * rstride,
                            rstride, code[1], raw[1], S, s, ok, live, a.mode == 1);
        // 'split': ch beside ch + cl (a code tip is its own ch, its cl 0)
        float hl[SPLIT ? SPT : 1][SPLIT ? SP : 1], hr[SPLIT ? SPT : 1][SPLIT ? SP : 1];
        if constexpr (SPLIT) {
          split_column<SP, SPT>(cl, hl, is_tip[0] != 1);
          split_column<SP, SPT>(cr, hr, is_tip[1] != 1);
        }
        if (reuse) group_sync(1 + g, H * kLanes);
        const float4* p = reinterpret_cast<const float4*>(pb + (size_t)(r - r0) * PP);
        const float4* q = reinterpret_cast<const float4*>(pb + (size_t)(RC + r - r0) * PP);
        const float4* pl = p + 2 * RC * (PP / 4);   // 'split': Pl
        const float4* ql = q + 2 * RC * (PP / 4);
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
              if constexpr (SPLIT) {
                const float4 ul = pl[(i0 + i) * (SP / 4) + j];
                const float4 vl = ql[(i0 + i) * (SP / 4) + j];
#pragma unroll
                for (int k = 0; k < SPT; ++k) {
                  ta[i][k] = fmaf(ul.x, hl[k][4 * j], ta[i][k]);
                  tb[i][k] = fmaf(vl.x, hr[k][4 * j], tb[i][k]);
                  ta[i][k] = fmaf(ul.y, hl[k][4 * j + 1], ta[i][k]);
                  tb[i][k] = fmaf(vl.y, hr[k][4 * j + 1], tb[i][k]);
                  ta[i][k] = fmaf(ul.z, hl[k][4 * j + 2], ta[i][k]);
                  tb[i][k] = fmaf(vl.z, hr[k][4 * j + 2], tb[i][k]);
                  ta[i][k] = fmaf(ul.w, hl[k][4 * j + 3], ta[i][k]);
                  tb[i][k] = fmaf(vl.w, hr[k][4 * j + 3], tb[i][k]);
                }
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
      stage_p<SP>(pb, cand.pmat, __ldg(next + 3), __ldg(next + 6), R, 0, nr0, RC, 0);
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

// ---------------------------------------------------------------------------
// The tensor-core plan ('bf16' and 'split'): fused_rows_tc, header above.
// the entry's `plan`: the FMA body spilled or on chip, the tensor cores'
// with the slots on chip or spilled
constexpr int kPlanSpill = 0, kPlanOnChip = 1, kPlanTc = 2, kPlanTcSpill = 3;
constexpr int kTcTile = 64;                // sites a block: wgmma's M
constexpr int kTcStride = kTcTile + 4;     // a slot row's words
constexpr int kTcAlign = 1024;             // a swizzle atom's alignment
constexpr int kWarpgroup = 128;

// wgmma's N: the states padded to 8
__host__ __device__ constexpr int tc_n(int sp) { return (sp + 7) / 8 * 8; }

// Shared memory of the tensor-core plans, in bytes: the alignment's slack,
// then (ops/_kernels.py:rows_plan computes the same)
//   P atoms [2][R][N][128 bytes] bf16   the op's P, both sides, all rates
//   codes   [2][2][T] int               two buffers of the op's code tips
//   red     [2][T] float, per rate [R][T]: the maxima
//   csc     [R][T] int, per rate only: the children's counts
//   on chip only:
//   slots   [n_slots][R * s][T + 4] float
//   counts  [n_slots][SR][T] int
__host__ __device__ inline size_t tc_smem_bytes(bool onchip, int sp, int rates, int states,
                                                int n_slots, int rate_scalers) {
  const size_t sr = rate_scalers ? rates : 1;
  size_t w = 2 * 2 * kTcTile;
  w += rate_scalers ? 2 * (size_t)rates * kTcTile : 2 * kTcTile;
  if (onchip) w += (size_t)n_slots * ((size_t)rates * states * kTcStride + sr * kTcTile);
  return kTcAlign + 2 * (size_t)rates * tc_n(sp) * 128 + 4 * w;
}

// the bf16 pair (x0 low, x1 high) of the half-up roundings (round_bf16)
__device__ __forceinline__ uint32_t pack_hi(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0) + 0x8000u, __float_as_uint(x1) + 0x8000u, 0x7632);
}

// the bf16 pair of the roundings to nearest even (round_bf16_rne)
__device__ __forceinline__ uint32_t pack_rne(float x0, float x1) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// the lo pair of split_bf16: x - round_bf16(x), rounded to nearest even
__device__ __forceinline__ uint32_t pack_lo(float x0, float x1) {
  return pack_rne(x0 - round_bf16(x0), x1 - round_bf16(x1));
}

// A thread's share of an op's P: element e = t + 128 u (u < PF) of its
// warpgroup's rates r = g + G v, both sides, SP * SP / 4 float4 each: row
// i, columns j .. j + 3 of P[side ? m2 : m1, r]. Where it comes from (`src`,
// P[m, r] at (m * R) * SP * SP words on) and where its bf16 pairs go in the
// atoms (`hi`, and `lo` in 'split': Ph at k = j, Pl at k = N + j) depend on
// the thread and u only, so they are laid out once.
template <int SP, int PF>
struct PShare {
  int src[PF];    // words from P[m, 0] on
  int hi[PF];     // bytes in the atoms
  int lo[PF];
  int side;       // bit u: the element is P[m2]'s
  int n;          // elements this thread holds (the first n of PF)
};

template <int SP>
__device__ __forceinline__ void p_element(int e, int R, int g, int G, int& src, int& hi,
                                          int& lo, int& side) {
  constexpr int P4 = SP * SP / 4, N = tc_n(SP);
  const int v = e / (2 * P4), f = e % P4;
  const int i = f / (SP / 4), j = f % (SP / 4) * 4, r = g + G * v;
  side = e / P4 % 2;
  src = r * SP * SP + 4 * f;
  const int atom = (side * R + r) * N * 128;
  hi = atom + sw128_byte(i, j, N);
  lo = atom + sw128_byte(i, N + j, N);
}

// Four values of P as bf16 pairs at byte `hi` (and their lo parts at `lo`)
template <bool SPLIT>
__device__ __forceinline__ void put_p(unsigned char* atoms, int hi, int lo, float4 v) {
  *reinterpret_cast<uint2*>(atoms + hi) = {pack_hi(v.x, v.y), pack_hi(v.z, v.w)};
  if constexpr (SPLIT) {
    *reinterpret_cast<uint2*>(atoms + lo) = {pack_lo(v.x, v.y), pack_lo(v.z, v.w)};
  }
}

// A child's values at the thread's positions as bf16 pairs: hi[j][h] (and
// lo[j][h] in 'split') holds states 8 j + 2 q (low) and 8 j + 2 q + 1 of
// site srow + 8 h, from rows `stride` apart whose first is `src` (the
// thread's state 2 q at site srow: a slot's, in shared memory or spilled
// to device memory, or a raw tip's), read where `ok[h]` if MASKED; zero at
// and past s (`lim` = s - 2 q; states below 16 always are). RAW: `src` is
// a raw tip's ('bf16' rounds it to nearest even).
template <int NJ, bool SPLIT, bool RAW, bool MASKED>
__device__ __forceinline__ void tc_values(uint32_t (&hi)[NJ][2], uint32_t (&lo)[NJ][2],
                                          const float* src, size_t stride, int lim,
                                          const bool (&ok)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = (8 * j + e + 6 < 16 || 8 * j + e < lim) && (!MASKED || ok[h]);
        v[e] = in ? (RAW ? __ldg(src + (8 * j + e) * stride + 8 * h)
                         : src[(8 * j + e) * stride + 8 * h])
                  : 0.0f;
      }
      hi[j][h] = !SPLIT && RAW ? pack_rne(v[0], v[1]) : pack_hi(v[0], v[1]);
      lo[j][h] = SPLIT ? pack_lo(v[0], v[1]) : 0u;
    }
}

// A code tip's 0/1 indicators as bf16 pairs (exact: 1.0 is 0x3F80), from
// its two sites' masks shifted down by 2 q; its lo parts are 0
template <int NJ>
__device__ __forceinline__ void tc_code(uint32_t (&hi)[NJ][2], uint32_t (&lo)[NJ][2],
                                        const unsigned (&code)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned b = code[h] >> (8 * j);
      hi[j][h] = (b & 1u ? 0x3F80u : 0u) | (b & 2u ? 0x3F800000u : 0u);
      lo[j][h] = 0u;
    }
}

// D[64, N] += the child's product with its atom (shared address `atom`):
// the hi term over K = 2N ('split': [ch | ch] against [Ph | Pl]) or K = N
// ('bf16'), then in 'split' where `with_lo` the lo term over K = N
template <int N, bool SPLIT>
__device__ __forceinline__ void tc_product(float (&d)[N / 2], const uint32_t (&hi)[N / 8][2],
                                           const uint32_t (&lo)[N / 8][2], unsigned atom,
                                           bool with_lo) {
  constexpr int NJ = N / 8;
  constexpr int KH = SPLIT ? NJ : (NJ + 1) / 2, KL = (NJ + 1) / 2;
#pragma unroll
  for (int ks = 0; ks < KH; ++ks) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jb = 2 * ks + r / 2, h = r % 2;
      a[r] = jb < NJ ? hi[jb][h] : (SPLIT && jb < 2 * NJ ? hi[jb - NJ][h] : 0u);
    }
    Mma<N>::rs(d, a, sw128_desc(atom + 32 * ks));
  }
  if constexpr (SPLIT) {
    if (with_lo) {
#pragma unroll
      for (int ks = 0; ks < KL; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jb = 2 * ks + r / 2;
          a[r] = jb < NJ ? lo[jb][r % 2] : 0u;
        }
        Mma<N>::rs(d, a, sw128_desc(atom + 32 * ks));
      }
    }
  }
}

// max over the 4 lanes of a quad (the thread's site's other states)
__device__ __forceinline__ float quad_max(float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// An op's table row, read ahead into registers
struct OpRow {
  int pslot, is_tip0, idx0, mat0, is_tip1, idx1, mat1, has;
};

__device__ __forceinline__ OpRow op_row(const int* row) {
  return {__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
          __ldg(row + 4), __ldg(row + 5), __ldg(row + 6), __ldg(row + 7)};
}

// stage_codes for a row read ahead: the op's state-code tips of the tile's
// T sites from `tile0` on into `dst` [2][T] (0 past the last site)
template <int T>
__device__ __forceinline__ void stage_row_codes(int* dst, const Args& a, const OpRow& row,
                                                size_t S, size_t tile0) {
  if (threadIdx.x >= 2 * T) return;
  const int side = threadIdx.x / T, col = threadIdx.x % T;
  if ((side ? row.is_tip1 : row.is_tip0) != 1) return;
  const size_t site = tile0 + col;
  int* d = dst + side * T + col;
  if (site < S) {
    cp_async4(d, tip_row(a, side ? row.idx1 : row.idx0) + site);
  } else {
    *d = 0;
  }
}

template <int SP, bool SPLIT, bool ONCHIP>
__global__ void __launch_bounds__(kThreads, 1) fused_rows_tc(Args a) {
  constexpr int N = tc_n(SP), NJ = N / 8, T = kTcTile, LD = kTcStride;
  constexpr int P4 = SP * SP / 4;
  // float4 of the next op's P a thread holds: all of two rates (R <= 4);
  // with more rates it loads the rest where it splits them
  constexpr int PF = (2 * 2 * P4 + kWarpgroup - 1) / kWarpgroup;
  const Cand cand = candidate(a);
  extern __shared__ float4 smem_raw[];
  unsigned char* const raw_base = reinterpret_cast<unsigned char*>(smem_raw);
  unsigned char* const atoms =
      raw_base + ((kTcAlign - (smem_addr(raw_base) & (kTcAlign - 1))) & (kTcAlign - 1));
  const int s = a.states, R = a.rates, RS = R * s;
  const int G = R > 1 ? 2 : 1;   // the warpgroups that take rates
  const int SR = a.rate_scalers ? R : 1;
  const size_t atom_bytes = (size_t)N * 128;
  int* const codes = reinterpret_cast<int*>(atoms + 2 * R * atom_bytes);
  float* const red = reinterpret_cast<float*>(codes + 2 * 2 * T);
  int* const csc = reinterpret_cast<int*>(red + (a.rate_scalers ? R : 2) * T);
  float* const onchip_slots = reinterpret_cast<float*>(csc + (a.rate_scalers ? R * T : 0));
  int* const onchip_counts = reinterpret_cast<int*>(onchip_slots + (size_t)a.n_slots * RS * LD);

  // the warp's index, broadcast from lane 0 so that the compiler sees the
  // branches on it (and the warpgroup's) as uniform: a wgmma on a path it
  // takes for divergent is serialized
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int g = warp / 4, lane = threadIdx.x % 32, q = lane % 4;
  const int t = threadIdx.x % kWarpgroup;
  const int srow = 16 * (warp % 4) + lane / 4;   // the thread's sites: srow, srow + 8
  const int lim = s - 2 * q;                     // its states 8 j + e + 2 q below s: 8 j + e < lim
  const bool mine = g < G;
  const size_t S = a.sites, tile0 = (size_t)blockIdx.x * T;
  const bool live[2] = {tile0 + srow < S, tile0 + srow + 8 < S};
  // the slots from the tile's first site: on chip [n_slots][R * s][LD],
  // spilled [n_slots][R * s][S] in device memory (read and written where
  // the site is live); their counts [n_slots][SR][T], or [S] spilled
  float* const sslots = ONCHIP ? onchip_slots : cand.slots + tile0;
  int* const scnt = ONCHIP ? onchip_counts : cand.slot_sc + tile0;
  const size_t ld = ONCHIP ? (size_t)LD : S, cld = ONCHIP ? (size_t)T : S;
  const size_t col = 2 * q * ld + srow;          // its state 2 q at site srow, in a rate's rows
  const bool all[2] = {ONCHIP || live[0], ONCHIP || live[1]};
  const bool own = ONCHIP || tile0 + t < S;      // thread t < T's site (its counts) is live
  // this warpgroup's share of an op's P (its rates, both sides), and the
  // thread's first PF elements of it laid out
  const int share = mine ? (R - g + G - 1) / G * 2 * P4 : 0;
  PShare<SP, PF> ps;
  ps.side = 0;
  ps.n = 0;
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    int side = 0;
    ps.src[u] = ps.hi[u] = ps.lo[u] = 0;
    if (t + kWarpgroup * u < share) {
      p_element<SP>(t + kWarpgroup * u, R, g, G, ps.src[u], ps.hi[u], ps.lo[u], side);
      ps.side |= side << u;
      ps.n = u + 1;
    }
  }

  // the atoms' padding (k past the states, rows past SP) is never staged
  for (size_t o = threadIdx.x * 16; o < 2 * R * atom_bytes; o += kThreads * 16) {
    *reinterpret_cast<uint4*>(atoms + o) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();
  float4 pf[PF];   // the next op's P, this thread's share
  const size_t mstride = (size_t)R * SP * SP;   // P[m] to P[m + 1]
  const auto fetch = [&](int m1, int m2) {
    const float* const p1 = cand.pmat + m1 * mstride;
    const float* const p2 = cand.pmat + m2 * mstride;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      if (u < ps.n) {
        pf[u] = __ldg(reinterpret_cast<const float4*>((ps.side >> u & 1 ? p2 : p1) + ps.src[u]));
      }
    }
  };
  const auto put = [&](int m1, int m2) {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      if (u < ps.n) put_p<SPLIT>(atoms, ps.hi[u], ps.lo[u], pf[u]);
    }
    for (int e = t + kWarpgroup * PF; e < share; e += kWarpgroup) {   // more than 4 rates
      int src, hi, lo, side;
      p_element<SP>(e, R, g, G, src, hi, lo, side);
      put_p<SPLIT>(atoms, hi, lo, __ldg(reinterpret_cast<const float4*>(
                                      cand.pmat + (side ? m2 : m1) * mstride + src)));
    }
    fence_proxy_async();
  };
  // rows op and op + 1 of the table in registers, op + 2 read during op
  OpRow cur{}, nxt{};
  if (a.n_ops > 0) {
    cur = op_row(cand.table);
    fetch(cur.mat0, cur.mat1);
    put(cur.mat0, cur.mat1);
    stage_row_codes<T>(codes, a, cur, S, tile0);
    cp_async_commit();
  }
  if (a.n_ops > 1) nxt = op_row(cand.table + kRow);
  for (int op = 0; op < a.n_ops; ++op) {
    const OpRow ahead = op + 2 < a.n_ops ? op_row(cand.table + (op + 2) * kRow) : OpRow{};
    const int* const cb = codes + (op & 1) * 2 * T;
    const int is_tip[2] = {cur.is_tip0, cur.is_tip1}, idx[2] = {cur.idx0, cur.idx1};
    cp_async_wait_all();
    __syncthreads();   // A: this op's inputs are in, the last op's parent stored
    if (op + 1 < a.n_ops) {   // prefetch the next op's inputs
      stage_row_codes<T>(codes + ((op + 1) & 1) * 2 * T, a, nxt, S, tile0);
      cp_async_commit();
      fetch(nxt.mat0, nxt.mat1);
    }
    // the children's counts, read by the thread that writes the parent's
    // (site t of warpgroup 0 per site; per rate site t of the rate's)
    int sc = 0;
    if (a.rate_scalers) {
      if (mine && t < T && own) {
        for (int r = g; r < R; r += G) {
          int c = 0;
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            if (is_tip[side] == 0) c += scnt[((size_t)idx[side] * SR + r) * cld + t];
          }
          csc[r * T + t] = c;
        }
      }
    } else if (threadIdx.x < T && own) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (is_tip[side] == 0) sc += scnt[(size_t)idx[side] * cld + threadIdx.x];
      }
    }
    // the code tips' masks of the thread's sites, its states 2 q on at bit 0
    unsigned code[2][2];
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        code[side][h] =
            is_tip[side] == 1 ? static_cast<unsigned>(cb[side * T + srow + 8 * h]) >> (2 * q) : 0u;
      }
    float mx[2] = {0.0f, 0.0f};   // the thread's max over its rates (x >= 0)
    if (mine) {
      // the children's operands of rate r: a tip's are the same for every
      // rate, a slot's are read again for each; the next rate's slot
      // operands are read while the tensor cores run this rate's products
      uint32_t hi[2][NJ][2], lo[2][NJ][2];
      const auto slot_operands = [&](int r, uint32_t(&oh)[2][NJ][2],
                                     uint32_t(&ol)[2][NJ][2]) {
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (is_tip[side] == 0) {
            tc_values<NJ, SPLIT, false, !ONCHIP>(
                oh[side], ol[side], sslots + ((size_t)idx[side] * RS + (size_t)r * s) * ld + col,
                ld, lim, all);
          }
        }
      };
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (is_tip[side] == 1) {
          tc_code<NJ>(hi[side], lo[side], code[side]);
        } else if (is_tip[side] == 2) {   // a raw tip's rows
          tc_values<NJ, SPLIT, true, true>(
              hi[side], lo[side], a.ctips + ((size_t)idx[side] * s + 2 * q) * S + tile0 + srow,
              S, lim, live);
        }
      }
      slot_operands(g, hi, lo);
      for (int r = g; r < R; r += G) {
        float d[2][N / 2];
#pragma unroll
        for (int side = 0; side < 2; ++side) {
#pragma unroll
          for (int i = 0; i < N / 2; ++i) d[side][i] = 0.0f;
        }
        fence_operands(d[0]);
        fence_operands(d[1]);
        wgmma_fence();
        const unsigned atom = smem_addr(atoms) + (unsigned)(r * atom_bytes);
        tc_product<N, SPLIT>(d[0], hi[0], lo[0], atom, is_tip[0] != 1);
        tc_product<N, SPLIT>(d[1], hi[1], lo[1], atom + (unsigned)(R * atom_bytes),
                             is_tip[1] != 1);
        wgmma_commit();
        uint32_t nhi[2][NJ][2], nlo[2][NJ][2];
        const bool more = r + G < R;
        if (more) slot_operands(r + G, nhi, nlo);
        wgmma_wait<0>();
        fence_operands(d[0]);
        fence_operands(d[1]);
        if (more) {
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            if (is_tip[side] != 0) continue;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                hi[side][j][h] = nhi[side][j][h];
                lo[side][j][h] = nlo[side][j][h];
              }
          }
        }
        // x = left * right; stored unscaled, at the thread's own positions
        float* const dst = sslots + ((size_t)cur.pslot * RS + (size_t)r * s) * ld + col;
        float m[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = d[0][4 * j + 2 * h + e] * d[1][4 * j + 2 * h + e];
              m[h] = x > m[h] ? x : m[h];
              if ((8 * j + e + 6 < 16 || 8 * j + e < lim) && all[h]) {
                dst[(8 * j + e) * ld + 8 * h] = x;
              }
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (a.rate_scalers) {
            const float v = quad_max(m[h]);
            if (q == 0) red[r * T + srow + 8 * h] = v;
          } else {
            mx[h] = m[h] > mx[h] ? m[h] : mx[h];
          }
        }
      }
      // this warpgroup's atoms are free: its last product has completed
      if (op + 1 < a.n_ops) put(nxt.mat0, nxt.mat1);
      if (!a.rate_scalers) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = quad_max(mx[h]);
          if (q == 0) red[g * T + srow + 8 * h] = v;
        }
      }
    }
    __syncthreads();   // B: the maxima are in

    // rescale the thread's own values where needed, then the counts
    const int pslot = cur.pslot, has = cur.has;
    float* const pdst = sslots + (size_t)pslot * RS * ld + col;
    if (a.rate_scalers) {
      if (mine) {
        for (int r = g; r < R; r += G) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (has && all[h] && red[r * T + srow + 8 * h] < a.threshold) {
#pragma unroll 1
              for (int n = 0; n < lim; n += 8) {
                pdst[(r * s + n) * ld + 8 * h] *= a.factor;
                if (n + 1 < lim) pdst[(r * s + n + 1) * ld + 8 * h] *= a.factor;
              }
            }
          }
          if (t < T && own) {
            scnt[((size_t)pslot * SR + r) * cld + t] =
                csc[r * T + t] + (has && red[r * T + t] < a.threshold);
          }
        }
      }
    } else {
      bool scale[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = red[srow + 8 * h];
        if (G == 2) m = fmaxf(m, red[T + srow + 8 * h]);
        scale[h] = has && m < a.threshold && all[h];
      }
      if (mine && (scale[0] || scale[1])) {
        for (int r = g; r < R; r += G) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!scale[h]) continue;
#pragma unroll 1
            for (int n = 0; n < lim; n += 8) {
              pdst[(r * s + n) * ld + 8 * h] *= a.factor;
              if (n + 1 < lim) pdst[(r * s + n + 1) * ld + 8 * h] *= a.factor;
            }
          }
        }
      }
      if (threadIdx.x < T && own) {
        float m = red[threadIdx.x];
        if (G == 2) m = fmaxf(m, red[T + threadIdx.x]);
        scnt[(size_t)pslot * cld + threadIdx.x] = sc + (has && m < a.threshold);
      }
    }
    cur = nxt;
    nxt = ahead;
  }

  __syncthreads();   // the last op's stores and rescales, made by other threads
  const int* root = cand.table + a.n_ops * kRow;
  const int site = threadIdx.x % T;
  const size_t sk = tile0 + site;
  if (sk >= S) return;
  for (int end = 0; end < 2; ++end) {
    const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
    float* out = out_clv(a, end) + sk;
    int* osc = out_sc(a, end);
    if (is_tip == 1) {
      const unsigned c = static_cast<unsigned>(__ldg(tip_row(a, idx) + sk));
      for (int qq = threadIdx.x / T; qq < RS; qq += kThreads / T) {
        out[(size_t)qq * S] = (c >> (qq % s)) & 1u ? 1.0f : 0.0f;
      }
    } else if (is_tip == 2) {
      const float* src = a.ctips + (size_t)idx * s * S + sk;
      for (int qq = threadIdx.x / T; qq < RS; qq += kThreads / T) {
        out[(size_t)qq * S] = __ldg(src + (size_t)(qq % s) * S);
      }
    } else {
      const float* src = sslots + (size_t)idx * RS * ld + site;
      for (int qq = threadIdx.x / T; qq < RS; qq += kThreads / T) out[(size_t)qq * S] = src[qq * ld];
    }
    for (int r = threadIdx.x / T; r < SR; r += kThreads / T) {
      osc[r * S + sk] = is_tip ? 0 : scnt[((size_t)idx * SR + r) * cld + site];
    }
  }
}

template <typename K>
int launch(K kernel, const Args& a, int tile, int n_cand, int n_query, size_t bytes,
           cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.sites + tile - 1) / tile, n_cand, n_query);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the plans: on the tensor cores ('bf16', 'split'; the slots on chip or
// spilled), on chip with one or two sites a thread ('highest'), or spilled
// (one; every mode)
template <int SP>
int launch_plan(const Args& a, int n_cand, int n_query, int plan, int spt,
                size_t bytes, cudaStream_t stream) {
  if constexpr (SP >= 16) {
    if (plan == kPlanTc) {
      return a.mode == 2
                 ? launch(fused_rows_tc<SP, true, true>, a, kTcTile, n_cand, n_query, bytes, stream)
                 : launch(fused_rows_tc<SP, false, true>, a, kTcTile, n_cand, n_query, bytes, stream);
    }
    if (plan == kPlanTcSpill) {
      return a.mode == 2
                 ? launch(fused_rows_tc<SP, true, false>, a, kTcTile, n_cand, n_query, bytes, stream)
                 : launch(fused_rows_tc<SP, false, false>, a, kTcTile, n_cand, n_query, bytes,
                          stream);
    }
    if (a.mode == 2) {
      return launch(fused_rows<SP, 1, false, true>, a, kLanes, n_cand, n_query, bytes, stream);
    }
  }
  if (plan == kPlanSpill) {
    return launch(fused_rows<SP, 1, false, false>, a, kLanes, n_cand, n_query, bytes, stream);
  }
  return spt == 2
             ? launch(fused_rows<SP, 2, true, false>, a, 2 * kLanes, n_cand, n_query, bytes, stream)
             : launch(fused_rows<SP, 1, true, false>, a, kLanes, n_cand, n_query, bytes, stream);
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
// n_cand, n_slots, SR, S]. `mode` is the contraction (0 'highest', 1
// 'bf16', 2 'split'). The trailing arguments are the launcher's plan
// (ops/_kernels.py:rows_plan): `plan` 0 spill, 1 on chip, 2 on the tensor
// cores (modes 1 and 2, 16 or more states), sites a thread, SP, the rates
// of P staged at once, the warp groups (warpgroups on the tensor cores) and
// the shared-memory bytes, which must equal this file's own count.
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
                                        float factor, int rate_scalers, int mode,
                                        void* stream, int plan,
                                        int sites_per_thread, int padded_states,
                                        int rate_chunk, int groups,
                                        long long smem_bytes) {
  const int sp = padded_states, spt = sites_per_thread;
  const bool onchip = plan == kPlanOnChip, tc = plan == kPlanTc || plan == kPlanTcSpill;
  const bool spill = plan == kPlanSpill || plan == kPlanTcSpill;
  const bool sp_ok = sp == 8 || sp == 16 || sp == 20 || sp == 24 || sp == 32;
  const bool g_ok = tc ? groups == (rates > 1 ? 2 : 1)
                       : groups == 1 || groups == 2 || groups == 4 || groups == 8;
  const bool plan_ok = (mode == 0 || (sp >= 16 && states >= 16)) &&
                       (plan == kPlanSpill || (onchip && mode == 0) || (tc && mode != 0));
  if (states < 1 || states > sp || !sp_ok || rates < 1 || sites < 1 ||
      n_ops < 0 || n_slots < 1 || !g_ok || !plan_ok || mode < 0 || mode > 2 ||
      rate_chunk < 1 || rate_chunk > rates || (plan != kPlanSpill && rate_chunk != rates) ||
      !(spt == 1 || (spt == 2 && plan != kPlanSpill)) || (tc && spt != 2) ||
      (spill && (slots == nullptr || slot_sc == nullptr)) ||
      (reinterpret_cast<size_t>(pmat) & 15) != 0 || n_cand < 1 ||
      n_cand > 65535 || n_query < 1 || n_query > 65535 ||
      (qcodes == nullptr) != (query_row < 0) ||
      (qcodes == nullptr && n_query != 1) ||
      table_stride < (long long)(n_ops + 1) * kRow ||
      pmat_stride < 0 || pmat_stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes =
      tc ? tc_smem_bytes(plan == kPlanTc, sp, rates, states, n_slots, rate_scalers)
         : smem_words(onchip, spt, sp, rates, states, n_slots, rate_scalers, rate_chunk,
                      groups, mode == 2) * 4;
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
         spill ? 0 : n_slots, out_p, out_c, sc_p, sc_c, threshold, factor,
         rate_scalers, mode, rate_chunk, groups,
         (rows + k_rows - 1) / k_rows * k_rows, table_stride, pmat_stride,
         spill ? n_slots * RS * S : 0, spill ? n_slots * SR * S : 0, RS * S,
         SR * S};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sp) {
    case 8: return launch_plan<8>(a, n_cand, n_query, plan, spt, bytes, st);
    case 16: return launch_plan<16>(a, n_cand, n_query, plan, spt, bytes, st);
    case 20: return launch_plan<20>(a, n_cand, n_query, plan, spt, bytes, st);
    case 24: return launch_plan<24>(a, n_cand, n_query, plan, spt, bytes, st);
    default: return launch_plan<32>(a, n_cand, n_query, plan, spt, bytes, st);
  }
}
