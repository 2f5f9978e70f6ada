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
// parent scaler to the trash row, so the kernel has no special cases. In
// per-rate mode (rate_scalers != 0; scaler [K+2, R, S]) each rate's block
// is compared with the threshold and rescaled on its own, and every scaler
// row holds one count per rate. libpll2_tpu's level kernel has no per-rate
// mode (its per-rate step-by-step API runs XLA); the port's step-by-step API
// always launches this kernel, so it has one.
//
// The trial form (B-3b: libpll2_tpu/optimize.py:366 vmaps the TPU kernel
// over model trials, which gives it one more grid dimension). K trials run
// the same level in one launch, each with its own P-matrices [K][E, R, s,
// s], its own CLV rows [K][N+1-base, R*s, S] and its own scaler rows [K][K+2,
// SR, S] (trials > 0; `clv_rows`, `sc_rows` and `n_mats` are a trial's
// rows and matrices). Rows below `base` (the tips, from state codes or
// set_tip_clv alike) are the same for every trial and are read from the
// shared buffer `tips` [base, R*s, S] at trial stride 0, never copied K
// times. Every parent row is at or above `base` (the host checks it). An
// op of trial k is resolved once, when it is loaded (`resolve`): its parent
// and scaler rows and matrices move to trial k's, and a shared child is
// marked by a negative row, so the rest of the kernel is the one-topology
// form's and holds no more registers. Rows are then indexed across the
// trials (k * clv_rows + row, an int: the host keeps K x rows below 2^31),
// and every offset is taken in 64 bits (41 protein trials at 128 x 8192
// pass 2^31 floats). The 4x4 variant puts the trial into its flat list of
// tiles, (trial, op, tile) with the trial outermost, so a one-op level of
// K trials is K ops wide for fixed_plan and its narrow levels take more
// sites a lane; the runtime-size variant puts the trial on blockIdx.z.
// Each form is its own instantiation (TRIALS), so the one-topology form is
// compiled as it was. What bounds the trial form is bytes, as for one
// traversal; the tips are needed once, but every trial reads them again
// (from HBM: 128 DNA tip rows at 16384 sites are 134 MB). 19 DNA trials at
// 128 x 16384 take 2.95-3.00 ms on an H100 against a 0.84 ms byte bound
// that counts the tips once (one launch a level; the one-op levels are 19
// ops wide), 9 protein trials at 128 x 8192 4.56-4.63 ms against 1.00 ms
// (PERF.md §6).
//
// Why in place is safe. The host (ops/levels.py:schedule_levels) puts no
// two ops in a level where one writes a row (CLV or scaler) that another
// reads or writes; blocks of one op cover disjoint sites. Within an op, the
// rows of one rate at one site are read and written by one thread only, and
// it reads every child value of that rate into registers before it stores
// any parent value of that rate (the 4x4 variant holds a tile of the op in
// registers, and the next tile it loads before storing this one covers
// other sites; the runtime-size one goes rate by rate, and rescales by
// re-reading only rows it has stored itself). Nothing crosses threads but P,
// staged in shared memory, and the maxima for the rescale test (a warp vote
// in the 4x4 variant). So even an op whose parent is its own child is right,
// and no CLV load may go through the read-only cache. In the trial form a
// trial reads its own rows and the shared tips and writes only its own
// rows, so the argument holds for each trial on its own, and no trial
// writes a row that another reads.
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
// read and written once: chip_smoke.py's bound, 0.2005 ms with P and the
// scaler rows) against 6.6 GFLOP (99 us).
//
// The design, 4x4 (DNA; each part measured against kernel copies on an H100,
// PERF.md §6):
// - Four neighbouring lanes hold the 4 rates of V consecutive sites, so a
//   lane keeps only its rate's two 4x4 P-matrices, 32 registers loaded once
//   per op (8 16-byte loads), and the inner loop loads nothing but child
//   columns: 2 x 16 FMAs a site and rate. The per-site rescale test is one
//   warp vote (__ballot_sync) over the 4 lanes of a site; per-rate counts
//   need none. Lane q writes the count of site q of its group, so a warp's
//   count stores are one 128-byte line.
// - V = 4 where S % 4 == 0 (every row starts on 16 bytes: float4 loads and
//   stores, a warp's access 4 rows x 128 B), 2 where S % 2 == 0, else 1;
//   narrow levels take fewer sites a lane until they have 2 tiles an SM
//   (the one-op levels of the DNA tree and of a caterpillar run 512 blocks
//   of 32 sites), so that more warps wait on device memory at once.
// - Blocks take runs of tiles of the level's flat (op, tile) list, as many
//   blocks as stay resident fill the card once, and issue the next tile's
//   child loads (and counts) before this tile's stores. Resident blocks by
//   instantiation: 5 an SM for V = 4 per site (96 registers), 4 per rate
//   (122: it spills at 5), 6 for V <= 2 (80); each was the fastest copy.
// - Child loads are evict-first (ld.global.cs): every CLV row is read once
//   a traversal, and the parents a level stores with the default policy
//   then stay in L2 for the next level (the 15-op level of the DNA tree
//   takes 14.1-14.9 us with the hint, 17.2 without, against its HBM bound
//   of 14.1 us).
// - What is left (PERF.md §5): the 42-op first level streams its tips from
//   device memory at ~2.55 TB/s; every level pays a launch's ramp and
//   drain, 2.8-3 us for a one-op level (0.94 us of bytes), which only a
//   launch that spans levels removes (ROADMAP B8).
// Runtime sizes (20-state proteins, any other state count up to 32, any
// rate count):
// - A thread owns one site of one op across its rates, or two sites (s0 and
//   s0 + blockDim.x, each access coalesced) on a wide level. Per rate it
//   loads its child columns L[r, .] and R[r, .] into registers
//   (neighbouring lanes, neighbouring sites: 128 B a row a warp), then reads
//   P four rows at a time as float4 broadcasts (one address for the whole
//   warp, no bank conflicts), each feeding 4 FMAs a site, and stores x[r, i]
//   unscaled.
// - A block stages both P-matrices of its op, for all rates that fit in
//   48 KB (all four at 20 states: 12.8 KB), zero-padded to SP x SP with SP
//   a multiple of 4, once: more rates are staged in chunks. Its threads
//   start at offsets that differ from block to block, since the blocks of
//   one op read the same P at the same moment.
// - The width W of the level sets the threads. A wide level (W * S at least
//   1536 sites an SM) runs two sites a thread, one tile of 256 sites a
//   block. Else one site a thread, and where that leaves an SM fewer than
//   2048 threads, a site's rates are split over 2 or 4 threads
//   (blockDim.y), so a narrow level runs more, shorter threads; blocks then
//   loop over tiles so that the card is filled once and P is staged once a
//   block.
// - The thread keeps its own maximum (per rate in per-rate mode); split
//   rates meet in shared memory once a tile. A rescale, which is rare,
//   re-reads the thread's own rows and multiplies them.
// - State counts are templates: 20 exactly, others padded to 4, 8, 16 or 32
//   with masked loads (padded P and child entries are zero).
// Dispatching the instructions at the protein shape, ~3200 FMAs and
// 400-800 shared loads a site, takes 0.14-0.2 ms a traversal, under the
// byte bound; the loss is latency: a warp waits on shared loads, on its FMA
// chains and on device memory, with at most 12 warps an SM to hide it (3
// blocks of 128 threads at ~166 registers).
//
// What is left for the runtime sizes: the tensor cores (3 x bf16 or 3 x
// TF32 for float32 accuracy); cp.async or TMA staging of the child columns,
// so that the next rate's or tile's columns arrive while this one is
// computed without holding registers; levels of width 1 to 3 (the protein
// tree's top) still cost 9-18 us each.
//
// 33 to 64 states: the 64-state body of states64.cuh (its note has the
// design and the bound): one rate of one op a block over a run of 64-site
// tiles of the level's flat (trial, op, tile) list, the tile's rates in a
// thread block cluster, laid out by ops/_kernels.py:level64_plan.
//
// Offsets into the CLV and scaler buffers are 64-bit: (N+1) * R * s * S
// passes 2^31 at 1000 taxa x 20 states x 4 rates x 30000 sites.
//
// Numerics: build without --use_fast_math (IEEE, no flush to zero, so 2^-64
// stays a normal float). nvcc contracts a*b+c into FMAs, which rounds
// differently from PyTorch's einsum; the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

#include "states64.cuh"

namespace {

// 4x4 variant (ops/_kernels.py: LEVEL_FIXED_*): lanes a block (a rate each,
// four a site group); its blocks resident on one SM, by instantiation (the
// launch bounds, so the registers a thread: 4 sites a lane per site 5
// blocks, <= 102 registers; per rate 4, <= 128, as its 125 would spill at
// 5; 1 or 2 sites a lane 6, <= 85); and the tiles an SM a level must have
// before a lane takes 2 or 4 sites
constexpr int kFixedThreads = 128;
constexpr int kFixedBlocksPerSm = 5;
constexpr int kFixedBlocksPerSmRate = 4;
constexpr int kFixedBlocksPerSmNarrow = 6;
constexpr int kFixedMinTilesPerSm = 2;

constexpr int fixed_blocks_per_sm(int v, bool per_rate) {
  return v < 4 ? kFixedBlocksPerSmNarrow
               : per_rate ? kFixedBlocksPerSmRate : kFixedBlocksPerSm;
}
constexpr int kBlock = 128;       // runtime-size variant: most threads a block
constexpr int kBlocksPerSm = 3;   // its blocks resident on one SM
constexpr int kStageBytes = 48 * 1024;  // its shared memory, at most

struct Args {
  float* clv;          // [N+1, R * s, S]; trial form [K][N+1-base, R * s, S]
  int* scaler;         // [K+2, SR, S], SR = R per rate, else 1; trial form
                       // one such buffer a trial
  const float* pmat;   // [E, R, s, s]; trial form one a trial
  const int* table;    // [9, ld]: this level's ops in columns 0..W-1
  int ld;
  int sites, rates, states;
  float threshold, factor;
  int rate_scalers;
  const float* tips;   // trial form: rows below `base`, shared by the trials
  int base;
  int clv_rows, sc_rows, n_mats;  // trial form: a trial's rows, matrices
};

struct Op {
  int parent, c1, c2, m1, m2, s1, s2, psc, has;
};

// Op `op` of trial k, resolved: its parent row, scaler rows and matrices
// indexed across the trials' buffers, a child from `base` up likewise, and
// a shared child (below `base`) as -1 - its row in `tips`.
__device__ __forceinline__ void resolve(Op& op, const Args& a, int k) {
  const int rows = k * a.clv_rows - a.base, sc = k * a.sc_rows;
  op.parent += rows;
  op.c1 = op.c1 < a.base ? -1 - op.c1 : op.c1 + rows;
  op.c2 = op.c2 < a.base ? -1 - op.c2 : op.c2 + rows;
  op.s1 += sc, op.s2 += sc, op.psc += sc;
  op.m1 += k * a.n_mats, op.m2 += k * a.n_mats;
}

// A child's row (`row` floats a row): in the trial form a resolved child,
// a shared row where it is negative.
template <bool TRIALS>
__device__ __forceinline__ const float* child_row(const Args& a, int node,
                                                  size_t row) {
  if (TRIALS && node < 0) return a.tips + (size_t)(-1 - node) * row;
  return a.clv + (size_t)node * row;
}

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

// count group q (a rate in per-rate mode, else 0) of the parent's scaler row
__device__ __forceinline__ void write_scaler(const Args& a, const Op& op, int q,
                                             size_t site, int rescale) {
  const size_t S = a.sites;
  const int SR = a.rate_scalers ? a.rates : 1;
  a.scaler[((size_t)op.psc * SR + q) * S + site] =
      a.scaler[((size_t)op.s1 * SR + q) * S + site] +
      a.scaler[((size_t)op.s2 * SR + q) * S + site] + rescale;
}

// ---------------------------------------------------------------------------
// 4 states x 4 rates (DNA). Four neighbouring lanes hold the 4 rates of V
// consecutive sites (V = 4, 2 or 1: ops/_kernels.py:level_fixed_plan), so
// a lane needs only its rate's two 4x4 P-matrices, which it keeps in
// registers for as long as its block stays on one op. A block of
// kFixedThreads lanes covers a tile of kFixedThreads / 4 * V sites of one
// op; blocks take runs of `per_block` consecutive tiles of the level's
// flat (op, tile) list ((trial, op, tile) in the trial form), and load the
// next tile's child columns and counts before they store this tile's
// products.
template <int V>
__device__ __forceinline__ void load_v(float (&d)[V], const float* p) {
  // evict-first (ld.global.cs, not the read-only path: an op may write its
  // own child): each CLV row is read once a traversal
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_v(int (&d)[V], const int* p) {
  if constexpr (V == 4) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (V == 2) {
    const int2 t = __ldcs(reinterpret_cast<const int2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = __ldcs(p);
  }
}

// parent rows and counts with the default policy: the next level reads them
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

template <int V>
__device__ __forceinline__ void store_v(int* p, const int (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

// One tile's child columns of one lane: its rate's 4 rows of both children
// at its V sites (zero past the last site: S % V == 0, so a site group is
// all in or all out).
template <int V>
struct FixedTile {
  float l[4][V], r[4][V];
};

template <int V, bool TRIALS>
__device__ __forceinline__ void load_tile(FixedTile<V>& t, const Args& a,
                                          const Op& op, int q, size_t site) {
  const size_t S = a.sites;
  if (site >= S) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) t.l[j][v] = t.r[j][v] = 0.0f;
    return;
  }
  const float* left = child_row<TRIALS>(a, op.c1, 16 * S) + q * 4 * S + site;
  const float* right = child_row<TRIALS>(a, op.c2, 16 * S) + q * 4 * S + site;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    load_v<V>(t.l[j], left + j * S);
    load_v<V>(t.r[j], right + j * S);
  }
}

// The counts a lane combines for one tile: per site, lane q's one site
// (q < V); per rate, its rate's V counts. NC of them, each child's.
template <int V, bool PER_RATE>
struct FixedCounts {
  static constexpr int NC = PER_RATE ? V : 1;
  int k1[NC], k2[NC];
};

template <int V, bool PER_RATE>
__device__ __forceinline__ void load_counts(FixedCounts<V, PER_RATE>& k,
                                            const Args& a, const Op& op,
                                            int q, size_t site) {
  const size_t S = a.sites;
  if (site >= S) {
#pragma unroll
    for (int c = 0; c < FixedCounts<V, PER_RATE>::NC; ++c) k.k1[c] = k.k2[c] = 0;
    return;
  }
  const int* sc = a.scaler;
  if constexpr (PER_RATE) {
    load_v<V>(k.k1, sc + ((size_t)op.s1 * 4 + q) * S + site);
    load_v<V>(k.k2, sc + ((size_t)op.s2 * 4 + q) * S + site);
  } else if (q < V) {
    k.k1[0] = __ldcs(sc + (size_t)op.s1 * S + site + q);
    k.k2[0] = __ldcs(sc + (size_t)op.s2 * S + site + q);
  } else {
    k.k1[0] = k.k2[0] = 0;  // a lane without a site of its own
  }
}

// rate q's P[m1] and P[m2], 16 floats each, 16-byte aligned (the wrapper
// passes P so)
__device__ __forceinline__ void load_p(float (&pl)[16], float (&pr)[16],
                                       const Args& a, const Op& op, int q) {
  const float4* gl = reinterpret_cast<const float4*>(a.pmat + ((size_t)op.m1 * 4 + q) * 16);
  const float4* gr = reinterpret_cast<const float4*>(a.pmat + ((size_t)op.m2 * 4 + q) * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = __ldg(gl + i), w = __ldg(gr + i);
    pl[4 * i] = u.x, pl[4 * i + 1] = u.y, pl[4 * i + 2] = u.z, pl[4 * i + 3] = u.w;
    pr[4 * i] = w.x, pr[4 * i + 1] = w.y, pr[4 * i + 2] = w.z, pr[4 * i + 3] = w.w;
  }
}

// Op j of the flat list: in the trial form op j % n_ops of trial j / n_ops,
// resolved.
template <bool TRIALS>
__device__ __forceinline__ Op load_op_of(const Args& a, long long j, int n_ops) {
  if constexpr (TRIALS) {
    Op op = load_op(a, (int)(j % n_ops));
    resolve(op, a, (int)(j / n_ops));
    return op;
  } else {
    return load_op(a, (int)j);
  }
}

template <int V, bool PER_RATE, bool TRIALS>
__global__ void __launch_bounds__(kFixedThreads,
                                  fixed_blocks_per_sm(V, PER_RATE))
    level_fixed(Args a, long long tiles_per_op, long long n_tiles,
                int per_block, int n_ops) {
  constexpr int kTile = kFixedThreads / 4 * V;
  const int q = threadIdx.x & 3;  // the lane's rate
  const int lane = threadIdx.x & 31;
  const size_t S = a.sites;
  long long t = (long long)blockIdx.x * per_block;
  const long long t_end = min(t + per_block, n_tiles);
  if (t >= t_end) return;
  const auto site_of = [&](long long tile) {
    return (size_t)(tile % tiles_per_op) * kTile + (threadIdx.x >> 2) * V;
  };
  long long w = t / tiles_per_op;  // the op (trial and op) of the list
  Op op = load_op_of<TRIALS>(a, w, n_ops);
  float pl[16], pr[16];
  load_p(pl, pr, a, op, q);
  size_t site = site_of(t);
  FixedTile<V> in;
  FixedCounts<V, PER_RATE> k;
  load_tile<V, TRIALS>(in, a, op, q, site);
  load_counts<V, PER_RATE>(k, a, op, q, site);
  for (;;) {
    float x[4][V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ta = pl[4 * i] * in.l[0][v];
        float tb = pr[4 * i] * in.r[0][v];
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          ta = fmaf(pl[4 * i + j], in.l[j][v], ta);
          tb = fmaf(pr[4 * i + j], in.r[j][v], tb);
        }
        x[i][v] = ta * tb;
      }
    }
    int ksum[FixedCounts<V, PER_RATE>::NC];  // this tile's, both children's
#pragma unroll
    for (int c = 0; c < FixedCounts<V, PER_RATE>::NC; ++c) ksum[c] = k.k1[c] + k.k2[c];
    // the next tile's loads are in flight while this one is stored; tiles
    // of one level never read what another writes (schedule_levels), and
    // the next tile of the same op covers other sites
    const long long tn = t + 1;
    const bool more = tn < t_end;  // the same in the whole block
    Op next = op;
    if (more) {
      if (tn / tiles_per_op != w)
        next = load_op_of<TRIALS>(a, tn / tiles_per_op, n_ops);
      load_tile<V, TRIALS>(in, a, next, q, site_of(tn));
      load_counts<V, PER_RATE>(k, a, next, q, site_of(tn));
    }
    // the rescale test: per site, the site's 16 values are all below the
    // threshold exactly when the 4 lanes' maxima are (one warp vote);
    // per rate, the lane's own 4 values
    int rescale[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float m = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) m = x[i][v] > m ? x[i][v] : m;
      bool below = m < a.threshold;
      if constexpr (!PER_RATE) {
        const unsigned votes = __ballot_sync(0xffffffffu, below);
        below = ((votes >> (lane & ~3)) & 0xFu) == 0xFu;
      }
      rescale[v] = op.has && below;
      if (rescale[v]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i][v] *= a.factor;
      }
    }
    if (site < S) {
      float* dst = a.clv + ((size_t)op.parent * 16 + q * 4) * S + site;
#pragma unroll
      for (int i = 0; i < 4; ++i) store_v<V>(dst + i * S, x[i]);
      if constexpr (PER_RATE) {
        int c[V];
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] = ksum[v] + rescale[v];
        store_v<V>(a.scaler + ((size_t)op.psc * 4 + q) * S + site, c);
      } else if (q < V) {
        int mine = 0;  // lane q's site is site + q
#pragma unroll
        for (int v = 0; v < V; ++v) mine = v == q ? rescale[v] : mine;
        a.scaler[(size_t)op.psc * S + site + q] = ksum[0] + mine;
      }
    }
    if (!more) break;
    if (tn / tiles_per_op != w) {
      w = tn / tiles_per_op;
      op = next;
      load_p(pl, pr, a, op, q);
    }
    t = tn;
    site = site_of(t);
  }
}

// ---------------------------------------------------------------------------
// Sizes known at run time (any rates; states <= SP, SP a multiple of 4; EXACT:
// states == SP, no masks). A thread owns SPT sites of one op (sites s0 and
// s0 + blockDim.x); `rc` rates of both P-matrices are staged at a time, all
// of them where they fit in kStageBytes. Rows are stored unscaled as they are
// computed; a site (per-rate mode: a rate of a site) that must be rescaled
// has its rows re-read and multiplied by `factor` by the thread that stored
// them. x * factor is the same float whether multiplied before or after the
// store.
__device__ __forceinline__ void rescale_rows(float* dst, size_t S, size_t site,
                                             int k0, int k1, float factor) {
  for (int k = k0; k < k1; ++k) dst[(size_t)k * S + site] *= factor;
}

// Rates r0 .. r0+nr-1 of both P-matrices into `stage`, zero-padded to
// SP x SP, by all threads of the block. Every thread's loads are started
// before its stores (a few iterations unrolled), so a block pays about one
// L2 latency for the staging, not one per element; where the padded layout
// is P's own it is copied 16 bytes at a time. Blocks start at different
// offsets (`rot`), so that the blocks of one op, which read the same P at
// the same moment, spread over its cache lines.
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
    const int rot = (int)(((size_t)blockIdx.x + blockIdx.y) * nt % n);
    const float4* gl = reinterpret_cast<const float4*>(pl + (size_t)r0 * PP);
    const float4* gr = reinterpret_cast<const float4*>(pr + (size_t)r0 * PP);
#pragma unroll 4
    for (int i = tid; i < n; i += nt) {
      const int k = i + rot < n ? i + rot : i + rot - n;
      stage[k] = __ldg(k < n4 ? gl + k : gr + (k - n4));
    }
    return;
  }
  float* sp = reinterpret_cast<float*>(stage);
  const int n = 2 * nr * PP;
  const int rot = (int)(((size_t)blockIdx.x + blockIdx.y) * nt % n);
#pragma unroll 4
  for (int i = tid; i < n; i += nt) {
    const int k = i + rot < n ? i + rot : i + rot - n;
    const int j = k % SP, row = (k / SP) % SP, cr = k / PP;
    const int c = cr >= nr, r = r0 + cr - c * nr;
    sp[k] = (EXACT || (row < s && j < s))
                ? __ldg((c ? pr : pl) + ((size_t)r * s + row) * s + j)
                : 0.0f;
  }
}

// The thread's sites of tile `tile` (tiles of blockDim.x * SPT sites; the
// thread's are threadIdx.x, + blockDim.x, ...) and whether each is a site.
template <int SPT>
__device__ __forceinline__ void tile_sites(size_t (&site)[SPT], bool (&in)[SPT],
                                           int tile, size_t S) {
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    site[k] = ((size_t)tile * SPT + k) * blockDim.x + threadIdx.x;
    in[k] = site[k] < S;
  }
}

// Rate r of the child columns at the thread's sites into registers (zero
// past the state count and the last site).
template <int SP, int SPT, bool EXACT>
__device__ __forceinline__ void load_children(
    float (&cl)[SPT][SP], float (&cr)[SPT][SP], const float* left,
    const float* right, const size_t (&site)[SPT], const bool (&in)[SPT],
    int r, int s, size_t S) {
#pragma unroll
  for (int j = 0; j < SP; ++j) {
    const size_t row = (size_t)(r * s + j) * S;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const bool ok = in[k] && (EXACT || j < s);
      cl[k][j] = ok ? left[row + site[k]] : 0.0f;
      cr[k][j] = ok ? right[row + site[k]] : 0.0f;
    }
  }
}

template <int SP, int SPT, bool EXACT, bool TRIALS>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    level_generic(Args a, int rc, int tiles) {
  // [2][rc][SP][SP / 4] float4: P[m1], then P[m2]; then 2 x [blockDim.y]
  // [sites of a tile] floats: each thread's maximum, for the cross-rate one
  extern __shared__ float4 stage[];
  constexpr int PP = SP * SP;
  constexpr int kRows = SPT == 1 ? 4 : 2;  // rows of P a step
  Op op = load_op(a, blockIdx.y);
  if constexpr (TRIALS) resolve(op, a, blockIdx.z);
  const int s = EXACT ? SP : a.states;
  const int RS = a.rates * s;
  const int TY = blockDim.y, ty = threadIdx.y;
  const int w = blockDim.x * SPT;  // sites a tile
  const size_t S = a.sites;
  const float* left = child_row<TRIALS>(a, op.c1, (size_t)RS * S);
  const float* right = child_row<TRIALS>(a, op.c2, (size_t)RS * S);
  float* dst = a.clv + (size_t)op.parent * RS * S;
  const float* pl = a.pmat + (size_t)op.m1 * RS * s;
  const float* pr = a.pmat + (size_t)op.m2 * RS * s;
  float* smax = reinterpret_cast<float*>(stage + (size_t)rc * (PP / 2));
  int staged = -1;  // the first rate of the chunk in `stage`
  // One tile of w sites; `it` counts the block's tiles.
  const auto run_tile = [&](int tile, int it) {
    size_t site[SPT];
    bool in[SPT];
    float m[SPT];
    tile_sites<SPT>(site, in, tile, S);
#pragma unroll
    for (int k = 0; k < SPT; ++k) m[k] = 0.0f;
    // The thread's rates are ty, ty + TY, ...: a rate's child columns are
    // all read before any of its rows is stored, and the next rate's as
    // soon as its last row is; the first tile's first rate is in flight
    // while P is staged.
    float cl[SPT][SP], cr[SPT][SP];
    if (ty < a.rates)
      load_children<SP, SPT, EXACT>(cl, cr, left, right, site, in, ty, s, S);
    for (int r0 = 0; r0 < a.rates; r0 += rc) {
      const int nr = min(rc, a.rates - r0);
      if (staged != r0) {
        if (staged >= 0) __syncthreads();  // every thread is done with it
        stage_p<SP, EXACT>(stage, pl, pr, s, r0, nr);
        __syncthreads();
        staged = r0;
      }
      // the thread's first rate in this chunk: the next of ty, ty + TY, ...
      for (int r = r0 + ((ty - r0) % TY + TY) % TY; r < r0 + nr; r += TY) {
        const float4* p = stage + (size_t)(r - r0) * (PP / 4);
        const float4* q = stage + (size_t)(nr + r - r0) * (PP / 4);
        float mr[SPT];
#pragma unroll
        for (int k = 0; k < SPT; ++k) mr[k] = 0.0f;
        // kRows rows at a time: each step of 4 columns loads 2 * kRows
        // float4 of P and feeds 8 * kRows * SPT independent FMAs
#pragma unroll 1
        for (int i0 = 0; i0 < SP; i0 += kRows) {
          if (!EXACT && i0 >= s) break;
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
            if (!EXACT && i0 + i >= s) break;  // a padded row: not stored
#pragma unroll
            for (int k = 0; k < SPT; ++k) {
              const float x = ta[i][k] * tb[i][k];
              mr[k] = x > mr[k] ? x : mr[k];
              if (in[k]) dst[(size_t)(r * s + i0 + i) * S + site[k]] = x;
            }
          }
        }
        if (r + TY < a.rates)
          load_children<SP, SPT, EXACT>(cl, cr, left, right, site, in, r + TY, s, S);
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          if (!a.rate_scalers) {
            m[k] = mr[k] > m[k] ? mr[k] : m[k];
          } else if (in[k]) {  // this rate's count and rescale
            const int rescale = op.has && mr[k] < a.threshold;
            if (rescale) rescale_rows(dst, S, site[k], r * s, (r + 1) * s, a.factor);
            write_scaler(a, op, r, site[k], rescale);
          }
        }
      }
    }
    if (a.rate_scalers) return;
    if (TY > 1) {  // the site's maximum over the threads of its rates
      // two buffers by tile parity: a thread writes one only after the
      // barrier of the tile between, which every reader of it has passed
      float* mx = smax + (it & 1) * TY * w;
#pragma unroll
      for (int k = 0; k < SPT; ++k) mx[ty * w + k * blockDim.x + threadIdx.x] = m[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        for (int y = 0; y < TY; ++y) {
          const float v = mx[y * w + k * blockDim.x + threadIdx.x];
          m[k] = v > m[k] ? v : m[k];
        }
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (!in[k]) continue;
      const int rescale = op.has && m[k] < a.threshold;
      if (rescale)
        for (int r = ty; r < a.rates; r += TY) rescale_rows(dst, S, site[k], r * s, (r + 1) * s, a.factor);
      if (ty == 0) write_scaler(a, op, 0, site[k], rescale);
    }
  };
  // At one site a thread a block takes tiles blockIdx.x, + gridDim.x, ...:
  // with all rates in one chunk P is staged once for all of them. At two
  // (wide levels, blocks enough) a block takes one tile, and keeps no loop
  // state in its registers.
  if constexpr (SPT == 1) {
    for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it)
      run_tile(tile, it);
  } else {
    run_tile(blockIdx.x, 0);
  }
}

// One launch of the runtime-size variant: blocks of `tx` x `ty` threads,
// `tx` over sites (SPT each), `ty` over rates, as many per op (and trial:
// `trials` of them, blockIdx.z) as fill the card once (kBlocksPerSm blocks
// an SM, `sms` SMs), each over one or more tiles of tx * SPT sites.
template <int SP, int SPT, bool EXACT, bool TRIALS>
void launch_generic(const Args& a, int n_ops, int trials, int tx, int ty,
                    int sms, cudaStream_t st) {
  constexpr int per_rate = 2 * SP * SP * (int)sizeof(float);
  constexpr int maxima = 2 * kBlock * SPT * (int)sizeof(float);
  const int rc = min(a.rates, (kStageBytes - maxima) / per_rate);
  const int w = tx * SPT;
  const int tiles = (a.sites + w - 1) / w;
  const long long fill = (long long)kBlocksPerSm * (sms > 0 ? sms : 1);
  const long long per_block =
      SPT == 1 ? ((long long)tiles * n_ops * trials + fill - 1) / fill : 1;
  const int blocks = (int)((tiles + per_block - 1) / per_block);
  const size_t smem = (size_t)rc * per_rate + 2 * (size_t)ty * w * sizeof(float);
  level_generic<SP, SPT, EXACT, TRIALS>
      <<<dim3(blocks, n_ops, trials), dim3(tx, ty), smem, st>>>(a, rc, tiles);
}

// 33 to 64 states (states64.cuh): one rate of one op a block, over a run
// of 64-site tiles of the level's flat (trial, op, tile) list, the rates of
// a tile in one thread block cluster (ops/_kernels.py:level64_plan).
template <bool TRIALS>
struct Dense64 {
  Args a;
  long long tiles_per_op;
  int n_ops;
  bool vec;  // rows start on 16 bytes and S % 4 == 0: 16-byte copies, stores
  struct Ref {
    Op op;
    long long w;  // the op of the flat list (trial and op)
    int site0;
  };
  __device__ __forceinline__ Ref ref(long long t) const {
    Ref f;
    f.w = t / tiles_per_op;
    f.op = load_op_of<TRIALS>(a, f.w, n_ops);
    f.site0 = (int)(t % tiles_per_op) * states64::kTile;
    return f;
  }
  __device__ __forceinline__ Ref next(const Ref& cur, long long t) const {
    if (t / tiles_per_op != cur.w) return ref(t);
    Ref f = cur;
    f.site0 = (int)(t % tiles_per_op) * states64::kTile;
    return f;
  }
  __device__ __forceinline__ bool same_p(const Ref& x, const Ref& y) const {
    return x.op.m1 == y.op.m1 && x.op.m2 == y.op.m2;
  }
  __device__ __forceinline__ const float* p(const Ref& f, int m, int q) const {
    const int s = a.states;
    return a.pmat + ((size_t)(m ? f.op.m2 : f.op.m1) * a.rates + q) * s * s;
  }
  __device__ __forceinline__ bool has(const Ref& f) const { return f.op.has; }
  // rate q's rows of both children at the tile's sites; plain copies, not
  // the read-only path: the op may write its own child
  __device__ __forceinline__ void children(float* dst, const Ref& f, int q) const {
    using namespace states64;
    const size_t S = a.sites, RS = (size_t)a.rates * a.states;
    const int s = a.states, tid = threadIdx.x;
    const float* src[2] = {child_row<TRIALS>(a, f.op.c1, RS * S),
                           child_row<TRIALS>(a, f.op.c2, RS * S)};
    if (vec) {
      const int c4 = tid % (kTile / 4), site = f.site0 + 4 * c4;
      const bool ok = site < (int)S;
      for (int c = 0; c < 2; ++c) {
        const float* base = src[c] + (size_t)q * s * S + (ok ? site : 0);
        for (int j = tid / (kTile / 4); j < s; j += kThreads / (kTile / 4))
          copy16(dst + c * kChildFloats + j * kTile + 4 * c4, base + j * S, ok);
      }
    } else {
      const int c1 = tid % kTile, site = f.site0 + c1;
      const bool ok = site < (int)S;
      for (int c = 0; c < 2; ++c) {
        const float* base = src[c] + (size_t)q * s * S + (ok ? site : 0);
        for (int j = tid / kTile; j < s; j += kThreads / kTile)
          copy4(dst + c * kChildFloats + j * kTile + c1, base + j * S, ok);
      }
    }
  }
  __device__ __forceinline__ float* row(const Ref& f, int q, int i) const {
    const size_t S = a.sites;
    return a.clv + ((size_t)f.op.parent * a.rates * a.states +
                    (size_t)q * a.states + i) * S;
  }
  __device__ __forceinline__ void store(
      const Ref& f, int q, int rg, int sg, int s,
      const float (&x)[states64::kRows][states64::kCols]) const {
    using namespace states64;
    const int site = f.site0 + sg * kCols, S = a.sites;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (rg * kRows + i >= s) break;
      float* dst = row(f, q, rg * kRows + i) + site;
      if (vec && site < S) {
        *reinterpret_cast<float4*>(dst) = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (site + k < S) dst[k] = x[i][k];
      }
    }
  }
  __device__ __forceinline__ void rescale(const Ref& f, int q, int rg, int sg,
                                          int s, const bool (&d)[states64::kCols]) const {
    using namespace states64;
    const int site = f.site0 + sg * kCols, S = a.sites;
    for (int i = 0; i < kRows && rg * kRows + i < s; ++i) {
      float* dst = row(f, q, rg * kRows + i) + site;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (d[k] && site + k < S) dst[k] *= a.factor;
    }
  }
  // count group q's rows (a rate's in per-rate mode) of scaler row `row`
  __device__ __forceinline__ int* counts(int row, int q) const {
    return a.scaler + ((size_t)row * (a.rate_scalers ? a.rates : 1) + q) * a.sites;
  }
  __device__ __forceinline__ void child_counts(const Ref& f, int q, int sg,
                                               int (&k)[states64::kCols]) const {
    const int site = f.site0 + sg * states64::kCols;
    const int* k1 = counts(f.op.s1, q) + site;
    const int* k2 = counts(f.op.s2, q) + site;
#pragma unroll
    for (int j = 0; j < states64::kCols; ++j)
      k[j] = site + j < a.sites ? k1[j] + k2[j] : 0;
  }
  __device__ __forceinline__ void count(const Ref& f, int q, int sg,
                                        const int (&k)[states64::kCols],
                                        const bool (&d)[states64::kCols]) const {
    const int site = f.site0 + sg * states64::kCols;
    int* dst = counts(f.op.psc, q) + site;
#pragma unroll
    for (int j = 0; j < states64::kCols; ++j)
      if (site + j < a.sites) dst[j] = k[j] + d[j];
  }
};

template <bool TRIALS>
__global__ void __launch_bounds__(states64::kThreads, states64::kBlocksPerSm)
    level_generic64(Dense64<TRIALS> src, long long n_tiles, long long per_block) {
  const long long t0 = (long long)(blockIdx.x / cooperative_groups::this_cluster()
                                                    .num_blocks()) * per_block;
  const long long t1 = min(t0 + per_block, n_tiles);
  states64::run(src, t0, t1, src.a.rates, src.a.states, src.a.threshold,
                src.a.factor, src.a.rate_scalers != 0);
}

// The clusters of level_generic64 the current device keeps resident.
int resident64(int cluster) {
  return states64::resident(level_generic64<false>, 0, cluster);
}

// One launch of the 64-state variant: ops/_kernels.py:level64_plan's
// layout, recomputed here; a launch whose cluster or run length differs,
// or whose tiles pass an int's sites, is refused.
template <bool TRIALS>
int launch_generic64(const Args& a, int n_ops, int trials, int cluster,
                     int tiles_per_block, cudaStream_t st) {
  const long long tiles_per_op =
      ((long long)a.sites + states64::kTile - 1) / states64::kTile;
  const long long n_tiles = tiles_per_op * n_ops * trials;
  const int c = a.rates < states64::kMaxCluster ? a.rates : states64::kMaxCluster;
  const int resident = resident64(c);
  if (resident < 0) return -resident;
  const states64::Plan p = states64::plan(n_tiles, a.rates, resident);
  if (p.cluster != cluster || p.per_block != tiles_per_block ||
      p.runs * p.cluster > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t ptrs = reinterpret_cast<size_t>(a.clv);
  if (TRIALS && a.base > 0) ptrs |= reinterpret_cast<size_t>(a.tips);
  Dense64<TRIALS> src{a, tiles_per_op, n_ops,
                      a.sites % 4 == 0 && (ptrs & 15) == 0};
  return static_cast<int>(states64::launch(level_generic64<TRIALS>, p.runs,
                                           p.cluster, st, src, n_tiles,
                                           p.per_block));
}

// The current device's SM count, asked of the driver once per device (the
// launches of a traversal are host-bound; every call writes the same value).
int sm_count() {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && cached[dev] > 0) return cached[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < kDevices) cached[dev] = sms;
  return sms;
}

// The 4x4 variant's layout of one level, as ops/_kernels.py:level_fixed_plan
// computes it: the most sites a lane that S and the buffers' alignment
// allow (4: 16-byte accesses; 2; 1), fewer while the level would have fewer
// than kFixedMinTilesPerSm tiles an SM; then runs of tiles a block, as many
// blocks as the instantiation keeps resident fill the card once.
struct FixedPlan {
  int v;
  long long tiles_per_op, tiles;
  int per_block, blocks;
};

FixedPlan fixed_plan(long long n_ops, int sites, int sms, bool aligned,
                     bool per_rate) {
  FixedPlan p{};
  p.v = !aligned ? 1 : sites % 4 == 0 ? 4 : sites % 2 == 0 ? 2 : 1;
  const long long want = (long long)kFixedMinTilesPerSm * (sms > 0 ? sms : 1);
  const auto per_op = [&](int v) {
    const int tile = kFixedThreads / 4 * v;
    return ((long long)sites + tile - 1) / tile;
  };
  while (p.v > 1 && n_ops * per_op(p.v) < want) p.v /= 2;
  p.tiles_per_op = per_op(p.v);
  p.tiles = n_ops * p.tiles_per_op;
  const long long fill = (long long)fixed_blocks_per_sm(p.v, per_rate) *
                         (sms > 0 ? sms : 1);
  p.per_block = (int)((p.tiles + fill - 1) / fill);
  p.blocks = (int)((p.tiles + p.per_block - 1) / p.per_block);
  return p;
}

template <int V, bool PER_RATE, bool TRIALS>
void launch_fixed(const Args& a, const FixedPlan& p, int n_ops,
                  cudaStream_t st) {
  level_fixed<V, PER_RATE, TRIALS><<<p.blocks, kFixedThreads, 0, st>>>(
      a, p.tiles_per_op, p.tiles, p.per_block, n_ops);
}

// One level of `n_ops` ops, `trials` trials (1 in the one-topology form).
template <bool TRIALS>
int launch_level(const Args& a, int n_ops, int trials, int sites_per_lane,
                 int tiles_per_block, int cluster, cudaStream_t st) {
  const int sites = a.sites, rates = a.rates, states = a.states;
  if (states == 4 && rates == 4) {
    size_t ptrs = reinterpret_cast<size_t>(a.clv) |
                  reinterpret_cast<size_t>(a.scaler);
    if (TRIALS && a.base > 0) ptrs |= reinterpret_cast<size_t>(a.tips);
    const FixedPlan p = fixed_plan((long long)n_ops * trials, sites, sm_count(),
                                   (ptrs & 15) == 0, a.rate_scalers != 0);
    if (p.v != sites_per_lane || p.per_block != tiles_per_block ||
        (reinterpret_cast<size_t>(a.pmat) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool pr = a.rate_scalers != 0;
    if (p.v == 4) {
      pr ? launch_fixed<4, true, TRIALS>(a, p, n_ops, st)
         : launch_fixed<4, false, TRIALS>(a, p, n_ops, st);
    } else if (p.v == 2) {
      pr ? launch_fixed<2, true, TRIALS>(a, p, n_ops, st)
         : launch_fixed<2, false, TRIALS>(a, p, n_ops, st);
    } else {
      pr ? launch_fixed<1, true, TRIALS>(a, p, n_ops, st)
         : launch_fixed<1, false, TRIALS>(a, p, n_ops, st);
    }
  } else {
    // Threads from the level's width (its ops times the trials): two sites
    // a thread where the level has 1536 sites an SM (20 states only), else
    // one; where one site a thread leaves an SM fewer than 2048 threads, a
    // site's rates are split over up to four threads (blockDim.y), so that
    // a narrow level has more, shorter threads.
    const int sms = sm_count();
    const long long threads = (long long)sites * n_ops * trials;  // one site each
    int ty = 1;
    while (ty < 4 && 2 * ty <= rates && threads * ty < 16LL * kBlock * sms) ty *= 2;
    const int tx = kBlock / ty;
    if (states == 20 && threads >= 12LL * kBlock * sms) {
      launch_generic<20, 2, true, TRIALS>(a, n_ops, trials, kBlock, 1, sms, st);
    } else if (states == 20) {
      launch_generic<20, 1, true, TRIALS>(a, n_ops, trials, tx, ty, sms, st);
    } else if (states <= 4) {
      launch_generic<4, 1, false, TRIALS>(a, n_ops, trials, tx, ty, sms, st);
    } else if (states <= 8) {
      launch_generic<8, 1, false, TRIALS>(a, n_ops, trials, tx, ty, sms, st);
    } else if (states <= 16) {
      launch_generic<16, 1, false, TRIALS>(a, n_ops, trials, tx, ty, sms, st);
    } else if (states <= 32) {
      launch_generic<32, 1, false, TRIALS>(a, n_ops, trials, tx, ty, sms, st);
    } else {
      const int err = launch_generic64<TRIALS>(a, n_ops, trials, cluster,
                                               tiles_per_block, st);
      if (err != 0) return err;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one level of `n_ops` ops on `stream` and returns
// cudaGetLastError() (0 on success). 4 states x 4 rates take the layout of
// ops/_kernels.py:level_fixed_plan, which the caller passes
// (`sites_per_lane`, `tiles_per_block`); 33-64 states that of
// level64_plan (`cluster`, the blocks of a cluster, and `tiles_per_block`);
// 0 for other sizes. A launch whose layout differs from the one recomputed
// here, or whose P is not 16-byte aligned at 4x4, is refused with
// cudaErrorInvalidValue. `trials` 0 is the
// one-topology form; trials > 0 the trial form over that many trials, with
// the shared rows `tips` below `base` and a trial's `clv_rows` CLV rows,
// `sc_rows` scaler rows and `n_mats` P-matrices (trials x each below
// 2^31).
extern "C" int pll_level_update(float* clv, int* scaler, const float* pmat,
                                const int* table, int ld, int n_ops, int sites,
                                int rates, int states, float threshold,
                                float factor, int rate_scalers,
                                int sites_per_lane, int tiles_per_block,
                                const float* tips, int base, int trials,
                                int clv_rows, int sc_rows, int n_mats,
                                int cluster, void* stream) {
  const long long most = (long long)trials *
                         (clv_rows > sc_rows ? (clv_rows > n_mats ? clv_rows : n_mats)
                                             : (sc_rows > n_mats ? sc_rows : n_mats));
  if (trials < 0 || base < 0 || (base > 0 && tips == nullptr) ||
      (trials == 0 && base != 0) || most > 2147483647LL || states < 1 ||
      states > states64::kSP || rates < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{clv, scaler, pmat, table, ld, sites, rates, states, threshold, factor,
         rate_scalers, tips, base, clv_rows, sc_rows, n_mats};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return trials > 0 ? launch_level<true>(a, n_ops, trials, sites_per_lane,
                                         tiles_per_block, cluster, st)
                    : launch_level<false>(a, n_ops, 1, sites_per_lane,
                                          tiles_per_block, cluster, st);
}

// The clusters of `cluster` blocks of the 64-state variant that the current
// device keeps resident at once (ops/_kernels.py:level64_plan's `resident`),
// or a negative CUDA error.
extern "C" int pll_level64_resident(int cluster) { return resident64(cluster); }
