// Site-repeats pruning ops over the pooled class columns, parent columns
// written in place: the 4x4 size (DNA) runs a whole plan in one launch,
// other sizes one dependency level a launch.
//
// Replaces the TPU kernel libpll2_tpu/ops/pallas_repeats.py:45 `_run_kernel`
// (reached through `pool_pallas`). That kernel runs one call per (width
// bucket, identity profile) run of ops and leans on the TPU's grid steps
// running in order, since a bucket may hold a parent and its own child
// (pallas_repeats.py:13-15). CUDA blocks run in no order. The 4x4 kernel
// restores the TPU kernel's shape with counters in device memory: tiles
// are claimed in the host's level order from an atomic ticket, and a tile
// waits until the ops it depends on have finished, which is what the TPU's
// in-order grid gave for free. The runtime-size kernel runs one level of
// ops/levels.py:schedule_levels a launch. The TPU kernel's block-band
// tables, 128-lane gather loop, float scaler rows and identity-profile
// split have no counterpart: a lane reads its child column gl[c]
// directly. The plain PyTorch version both must agree with is
// ops/pool.py:pool_update_reference.
//
// What they compute. A table [11, ld] int64 (column k is op k):
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
// in its pool kernel and runs XLA; these kernels have the mode.
// Padding columns (W past the parent's class count) gather class 0 and are
// computed like the others: the plain version writes them too.
//
// The trial form (B-3b: libpll2_tpu/optimize.py:366 would vmap the TPU
// kernel over model trials). K trials run one plan in one launch, each with
// its own P-matrices [K][E, R, s, s], its own pool [K][R * s, T] and its own
// scaler pool (trials > 0; `pool_trial`, `sc_trial` and `p_trial` are the
// elements between two trials', 64-bit). The pooled buffers are small
// (14.8 MB at 246 x 4465), so the host copies the partition's pool into
// every trial's once a chunk, one broadcast copy (ops/pool.py), and a
// trial's tips are its own copy of the tips' class columns. The
// runtime-size kernel puts the trial on blockIdx.y; the 4x4 kernel draws K
// times the tickets (below). Each form is its own instantiation (TRIALS), so
// the one-topology form is compiled as it was; the 4x4 kernel's trial form
// moves a tile's offsets to its trial's once, when it loads the op, and so
// holds no pointers of its own. Measured on an H100 (PERF.md §6): 19
// trials at 246 x 4465 take 325-338 us in one launch (17 us a trial, against
// a 56 us byte bound for all 19 that reads the tips' columns once, and 38-39
// us for one trial alone): the trials' pools (282 MB) no longer fit in L2,
// and a block still works one tile at a time, each a chain of a ticket, the
// waits, gathers and a release; 34 conserved-protein trials take 5.21-5.23
// ms a chunk (153-154 us a trial, against a 0.75 ms bound for the chunk and
// 232-235 us for one traversal alone).
//
// Why in place is safe. Every node and every scaler index owns its own
// pooled region. An op whose parent is its own child is refused on the
// host (ops/pool.py:pack_pool_levels): one lane's child column is another
// lane's parent column. The runtime-size kernel runs one level, whose ops
// neither read nor write a region another writes (schedule_levels), so no
// child column changes during its launch and it reads children through
// the read-only cache. The 4x4 kernel's ops do write what later ops of the
// same launch read; its ordering is below. In the trial form a trial reads
// and writes only its own pools, so all of this holds for each trial on
// its own.
//
// The 4x4 kernel (pool_traversal), one launch a traversal:
// - The host lays every level's tiles out in one ticket list, in level
//   order, and each op's wait list in CSR arrays
//   (ops/pool.py:traversal_arrays): the last earlier writer of each region
//   it reads (read after write), the last earlier writer and every reader
//   since of the regions it writes (write after write, write after read);
//   the trash and zero scaler regions make none. A block takes its next
//   tile from an atomic ticket counter, never from blockIdx. Before it
//   reads a child, one lane of warp 0 a listed op spins (ld.acquire.gpu,
//   __nanosleep backoff of 16-64 ns) until that op's finished-tile count
//   reaches its tile count; a barrier releases the block. After its
//   stores, the block meets at a barrier and one thread adds one to its
//   op's count with a release reduction (red.release.gpu). Each count, and
//   the ticket counter, has a 128-byte line of its own. An op starts as
//   soon as its own inputs are done, not when a whole level is.
// - It cannot deadlock, whatever the grid: tickets are drawn in order, a
//   block draws only while resident and keeps its tile until it is done,
//   and a tile waits only on ops before it in the list, whose tiles hold
//   smaller tickets. So the smallest unfinished ticket has nothing left to
//   wait on. A grid larger than the card's resident blocks is safe too.
// - The trial form draws K tickets a tile, interleaved: ticket j * K + k is
//   tile j of trial k, so the trials' dependency chains run side by side
//   rather than one after another. Each trial has its own finished-tile
//   count for each op (op e of trial k at (1 + k * ops + e) lines), all
//   zeroed by the one memset: a count shared by the trials would release a
//   tile before its own trial's op was done. A tile of trial k waits only
//   on trial k's counts of ops before its op in the list, whose tiles j' <
//   j hold tickets j' * K + k, smaller than its own; so the argument above
//   holds unchanged.
// - The counters are zeroed by a cudaMemsetAsync that the C entry enqueues
//   on the launch's stream just before the kernel, so every launch starts
//   from zero whatever the last one left; one plan must not run on two
//   streams at once. (A reset inside the kernel, by the block of the last
//   ticket once every op's count was complete, saved ~2 us of host
//   enqueue and nothing in the call, and its first form hung on the card:
//   PERF.md, Findings.)
// - Reads: the tickets, wait lists, table, gather maps and P are read-only
//   for the launch and go through the read-only path (ld.global.nc). Child
//   columns and counts, which a block of the same launch may have written,
//   are never read through it: they are plain cached loads (ld.global.ca)
//   after the acquire and the barrier, which order them after the writer's
//   release (a gpu-scope acquire leaves no stale L1 line behind it). A
//   tile with an empty wait list reads only regions no op of the launch
//   wrote before it. Cached, the gathers of one class column by many
//   parent columns hit L1: 39.6-40.0 us against 44.9-46.5 through L2
//   (ld.global.cg), whose traffic slowed the tiles at work on one SM.
// - Four neighbouring lanes hold the 4 rates of one class column, as in
//   level_update.cu's 4x4 variant: a lane keeps its rate's two 4x4
//   P-matrices in 32 registers, loaded once a tile (a tile is one op) in 8
//   16-byte loads, and the per-site rescale test is one warp vote over the
//   4 lanes; per rate none is needed. A block of 128 lanes computes a tile
//   of 64 class columns in 2 passes of 32 whose loads are in flight
//   together, and the grid fills the card once (6 blocks an SM:
//   ops/_kernels.py:pool_fixed_plan).
// - A block draws its next ticket as soon as it starts a tile and loads
//   what is read-only (op, gather entries, P) before it waits, so that the
//   chain from one op's last store to the next op's first load is the
//   release, the acquire and the child loads.
// - Timed on an H100 against copies of this kernel (PERF.md, Findings):
//   tiles of 64 columns beat 32 and 128; counters on lines of their own
//   and the release reduction beat packed counters and a fence; cached
//   child loads beat L2-only ones; P in shared memory at 10-16 blocks an
//   SM, spinning without a backoff, and relaxed polls with one acquire
//   fence were no faster. Per-tile timestamps (with L2-only child loads)
//   show each level costing ~3 us on the critical path: ~0.9 us from an
//   op's last store until a waiting tile sees its count, then 1.3 us
//   (median) to 2.3 us (the op's slowest tile) of child loads, FMAs and
//   stores, longer the more tiles are at work on the same SM.
//
// What bounds them on an H100. Per parent class column an op gathers two
// child columns and writes one (3 * R * s floats, 4 bytes each), and reads
// and writes 3 scaler and 2 gather int32s, against 4 * R * s * s + R * s
// FLOP: 1.3 FLOP per byte for DNA (R = s = 4), 6.6 for 20 states, below
// the card's 20 FLOP per byte (67 TFLOP/s float32 over 3.35 TB/s). The
// total is set by the data's class counts: chip_smoke.py computes it from
// them (3.3 us for the 246 x 4465 repeats DNA traversal, 6.0 us its
// levels' own bounds summed). But the levels are narrow and the whole pool
// fits in L2 (14.8 MB there), so the 4x4 kernel is bound by latency: the
// chain of 14 dependent ops, each a release, an acquire, a child load from
// L2, the FMAs and the stores. One launch a level paid a launch's ramp and
// drain at every level instead (62 us for that traversal, ~4.4 us a
// level).
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
// level's latency chain (~4 us), the stores, the scattered child gathers
// of the top levels and the FMA loop at 8-16 warps an SM.
//
// 33 to 64 states: the 64-state body of states64.cuh (one rate of one op a
// block over a run of 64-column tiles, two a tile-map granule, of the
// level's flat (trial, tile) list, the tile's rates in a thread block
// cluster), laid out by ops/_kernels.py:pool_plan.
//
// Offsets into the pool are 64-bit (the table is int64): the pool holds
// R * s * T floats, past 2^31 at 80 rows and 27M columns.
//
// Numerics: built without --use_fast_math (IEEE, no flush to zero). nvcc
// contracts a*b+c into FMAs, which rounds differently from PyTorch's einsum;
// the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

#include "states64.cuh"

namespace {

// 4x4 traversal kernel: threads a block (4 lanes a column, 32 columns a
// pass), passes a tile (a tile is 64 columns), the ints between two
// counters (one 128-byte line each), and its blocks resident on an SM, as
// ops/_kernels.py:pool_fixed_plan counts them
constexpr int kTravThreads = 128;
constexpr int kTravPasses = 2;
constexpr int kCounterStride = 32;
constexpr int kTravBlocksPerSm = 6;
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
  long long pool_trial, sc_trial, p_trial;  // trial form: elements between
                                            // two trials' buffers
};

struct Op {
  long long p, psc, c1, m1, s1, c2, m2, s2, w, g, has;
};

// trial k's buffer `p` (`stride` elements a trial) in the trial form
template <bool TRIALS, class T>
__device__ __forceinline__ T* trial_buf(T* p, long long stride, int k) {
  if constexpr (TRIALS) return p + (size_t)k * stride;
  else return p;
}

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

// count group q (a rate in per-rate mode, else 0) of parent column c in
// scaler pool `sc_all`
__device__ __forceinline__ void write_count(const Args& a, int* sc_all,
                                            const Op& op, int q, long long c,
                                            int gl, int gr, int rescale) {
  int* sc = sc_all + q * a.T2;
  sc[op.psc + c] = sc[op.s1 + gl] + sc[op.s2 + gr] + rescale;
}

// ---------------------------------------------------------------------------
// 4 states x 4 rates (DNA): a whole plan in one launch. Four neighbouring
// lanes hold the 4 rates of one class column; a block of kTravThreads
// lanes computes one ticket's tile of 32 * V columns of one op at a time,
// V passes of 32 columns, their loads all in flight at once.
struct Trav {
  const int4* tickets;  // [n_tiles]: op, first column, its wait range [z, w)
  int n_tiles;
  const int2* waits;    // (op, its tile count); null: no waits (one level)
  int* ticket;          // the next ticket
  int* done;            // op e's finished tiles at done[e * kCounterStride];
                        // trial form: trial k's at done[(k * n_ops + e) * ..]
  int trials;           // trial form: the trials (tickets n_tiles * trials)
  int n_ops;            // trial form: the ops a trial's counts cover
};

// a count another block publishes: from L2, ordered before what follows
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one more finished tile of an op, ordered after the block's stores (the
// barrier before it makes them the thread's to release)
__device__ __forceinline__ void add_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

__device__ __forceinline__ void wait_count(const int* p, int need) {
  unsigned ns = 16;
  while (load_acquire(p) < need) {
    __nanosleep(ns);
    ns = ns < 64 ? 2 * ns : 64;
  }
}

// rate q's P[m] (16 floats, 16-byte aligned: the wrapper passes P so)
__device__ __forceinline__ void load_p4(float (&p)[16], const float* pmat,
                                        long long m, int q) {
  const float4* g = reinterpret_cast<const float4*>(pmat + (m * 4 + q) * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = __ldg(g + i);
    p[4 * i] = u.x, p[4 * i + 1] = u.y, p[4 * i + 2] = u.z, p[4 * i + 3] = u.w;
  }
}

template <bool PER_RATE, bool TRIALS>
__global__ void __launch_bounds__(kTravThreads, kTravBlocksPerSm)
    pool_traversal(Args a, Trav tv) {
  constexpr int V = kTravPasses;
  __shared__ int s_ticket[2];
  const int q = threadIdx.x & 3;  // the lane's rate
  const int lane = threadIdx.x & 31;
  const bool lead = threadIdx.x == 0;
  const size_t T = a.T;
  const int n_draws = TRIALS ? tv.n_tiles * tv.trials : tv.n_tiles;
  if (lead) s_ticket[0] = atomicAdd(tv.ticket, 1);
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    const int t = s_ticket[buf];
    if (t >= n_draws) return;  // the list is exhausted
    // the next ticket, drawn now: its latency hides behind this tile
    int next = 0;
    if (lead) next = atomicAdd(tv.ticket, 1);
    // ticket t is tile t / K of trial t % K in the trial form
    const int tile = TRIALS ? t / tv.trials : t;
    const int k = TRIALS ? t - tile * tv.trials : 0;
    // what no op of the launch writes (tickets, table, gather maps, P)
    // is read before the wait, through the read-only path
    const int4 e = __ldg(tv.tickets + tile);
    Op op = load_op(a, e.x);
    // trial k's counts of the ops, and its columns, counts and P: the op's
    // offsets moved by the trial's (no pointer of its own to hold)
    const int kops = TRIALS ? k * tv.n_ops : 0;
    if constexpr (TRIALS) {
      const long long po = k * a.pool_trial, so = k * a.sc_trial,
                      mo = k * (a.p_trial / 64);  // P: 64 floats a matrix
      op.p += po, op.c1 += po, op.c2 += po;
      op.psc += so, op.s1 += so, op.s2 += so;
      op.m1 += mo, op.m2 += mo;
    }
    long long c[V];
    bool in[V];
    int gl[V], gr[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      c[v] = e.y + 32 * v + (threadIdx.x >> 2);
      in[v] = c[v] < op.w;
      gl[v] = in[v] ? __ldg(a.gl + op.g + c[v]) : 0;
      gr[v] = in[v] ? __ldg(a.gr + op.g + c[v]) : 0;
    }
    float pl[16], pr[16];
    load_p4(pl, a.pmat, op.m1, q);
    load_p4(pr, a.pmat, op.m2, q);
    // the ops this one waits on (its own trial's), one lane of warp 0 each
    if (tv.waits != nullptr && threadIdx.x < 32) {
      for (int i = e.z + lane; i < e.w; i += 32) {
        const int2 w = __ldg(tv.waits + i);
        wait_count(tv.done + (size_t)(kops + w.x) * kCounterStride, w.y);
      }
    }
    __syncthreads();
    // child columns and counts may have been written in this launch: plain
    // cached loads (ld.global.ca), ordered after the writers' release by
    // the acquire and the barrier; a tile without a wait list reads no
    // region that an op of this launch has written
    int* sc = a.sc + (PER_RATE ? (size_t)q * a.T2 : 0);
    float l[V][4], r[V][4];
    int k1[V], k2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* left = a.pool + op.c1 + gl[v] + (size_t)q * 4 * T;
      const float* right = a.pool + op.c2 + gr[v] + (size_t)q * 4 * T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[v][j] = in[v] ? __ldca(left + j * T) : 0.0f;
        r[v][j] = in[v] ? __ldca(right + j * T) : 0.0f;
      }
      const bool counts = in[v] && (PER_RATE || q == 0);
      k1[v] = counts ? __ldca(sc + op.s1 + gl[v]) : 0;
      k2[v] = counts ? __ldca(sc + op.s2 + gr[v]) : 0;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float x[4];
      float m = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ta = pl[4 * i] * l[v][0];
        float tb = pr[4 * i] * r[v][0];
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          ta = fmaf(pl[4 * i + j], l[v][j], ta);
          tb = fmaf(pr[4 * i + j], r[v][j], tb);
        }
        x[i] = ta * tb;
        m = x[i] > m ? x[i] : m;
      }
      // per site the column's 16 values are all below the threshold
      // exactly when its 4 lanes' maxima are (one warp vote); per rate,
      // the lane's 4
      bool below = m < a.threshold;
      if (!PER_RATE) {
        const unsigned votes = __ballot_sync(0xffffffffu, below);
        below = ((votes >> (lane & ~3)) & 0xFu) == 0xFu;
      }
      const int rescale = op.has && below;
      if (in[v]) {
        float* dst = a.pool + op.p + c[v] + (size_t)q * 4 * T;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[i * T] = rescale ? x[i] * a.factor : x[i];
        if (PER_RATE || q == 0) sc[op.psc + c[v]] = k1[v] + k2[v] + rescale;
      }
    }
    if (lead) s_ticket[buf ^ 1] = next;
    // every lane's stores, then one release of the op's count
    __syncthreads();
    if (lead) add_release(tv.done + (size_t)(kops + e.x) * kCounterStride);
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

template <int SP, bool EXACT, bool TRIALS>
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
  // the trial's buffers (blockIdx.y in the trial form)
  float* const pool = trial_buf<TRIALS>(a.pool, a.pool_trial, blockIdx.y);
  int* const sc_all = trial_buf<TRIALS>(a.sc, a.sc_trial, blockIdx.y);
  const float* const pmat = trial_buf<TRIALS>(a.pmat, a.p_trial, blockIdx.y);
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
    const float* left = pool + op.c1 + gl;
    const float* right = pool + op.c2 + gr;
    float* dst = pool + op.p + c;
    const float* pl = pmat + op.m1 * RS * s;
    const float* pr = pmat + op.m2 * RS * s;
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
          write_count(a, sc_all, op, r, c, gl, gr, rescale);
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
    if (ty == 0) write_count(a, sc_all, op, 0, c, gl, gr, rescale);
  }
}

// One launch of the runtime-size variant with `ty` rate warps: tiles of
// kBlock / ty columns, `per_block` of them a block, for each of `trials`
// trials (blockIdx.y).
template <int SP, bool EXACT, bool TRIALS>
void launch_generic(const Args& a, const int* map, int granules, int ty,
                    int per_block, int trials, cudaStream_t st) {
  constexpr int per_rate = 2 * SP * SP * (int)sizeof(float);
  constexpr int maxima = 2 * kBlock * (int)sizeof(float);
  const int w = kBlock / ty;
  Tiles tl{reinterpret_cast<const int2*>(map), kGranule / w, 0, per_block,
           min(a.rates, (kStageBytes - maxima) / per_rate)};
  tl.count = granules * tl.per_granule;
  const int blocks = (tl.count + per_block - 1) / per_block;
  const size_t smem = (size_t)tl.rc * per_rate + (size_t)maxima;
  pool_generic<SP, EXACT, TRIALS>
      <<<dim3(blocks, trials), dim3(w, ty), smem, st>>>(a, tl);
}

// 33 to 64 states (states64.cuh): one rate of one op a block, over a run
// of 64-column tiles (two a tile-map granule) of the level's flat (trial,
// tile) list, the rates of a tile in one thread block cluster
// (ops/_kernels.py:pool_plan). The counts are pool_generic's.
template <bool TRIALS>
struct Pooled64 {
  Args a;
  const int2* map;   // the level's tile map: (op, first column) a granule
  long long tiles;   // a trial's tiles: its granules x 2
  struct Ref {
    Op op;
    long long c0;    // the tile's first column
    int k;           // its trial
    int e;           // its op in the table
  };
  // tile t's trial, map entry and first column, and its op unless it is
  // `cur`'s
  __device__ __forceinline__ Ref locate(long long t, const Ref* cur) const {
    constexpr int per = kGranule / states64::kTile;
    Ref f;
    f.k = TRIALS ? (int)(t / tiles) : 0;
    const long long tile = TRIALS ? t - f.k * tiles : t;
    const int2 e = __ldg(map + tile / per);
    f.e = e.x;
    if (cur != nullptr && cur->k == f.k && cur->e == e.x) f.op = cur->op;
    else f.op = load_op(a, e.x);
    f.c0 = e.y + (tile % per) * states64::kTile;
    return f;
  }
  __device__ __forceinline__ Ref ref(long long t) const {
    return locate(t, nullptr);
  }
  __device__ __forceinline__ Ref next(const Ref& cur, long long t) const {
    return locate(t, &cur);
  }
  __device__ __forceinline__ bool same_p(const Ref& x, const Ref& y) const {
    return x.k == y.k && x.op.m1 == y.op.m1 && x.op.m2 == y.op.m2;
  }
  __device__ __forceinline__ const float* p(const Ref& f, int m, int q) const {
    const int s = a.states;
    return trial_buf<TRIALS>(a.pmat, a.p_trial, f.k) +
           ((m ? f.op.m2 : f.op.m1) * a.rates + q) * s * s;
  }
  __device__ __forceinline__ bool has(const Ref& f) const { return f.op.has; }
  __device__ __forceinline__ float* pool(const Ref& f) const {
    return trial_buf<TRIALS>(a.pool, a.pool_trial, f.k);
  }
  // rate q's entries of both children's gathered columns; no op of the
  // level writes a column another reads (schedule_levels), so they come
  // through L1
  __device__ __forceinline__ void children(float* dst, const Ref& f, int q) const {
    using namespace states64;
    const int s = a.states, tid = threadIdx.x, lx = tid % kTile;
    const long long c = f.c0 + lx;
    const bool in = c < f.op.w;
    const float* pl = pool(f);
    const float* base[2] = {
        pl + f.op.c1 + (in ? __ldg(a.gl + f.op.g + c) : 0) + (long long)q * s * a.T,
        pl + f.op.c2 + (in ? __ldg(a.gr + f.op.g + c) : 0) + (long long)q * s * a.T};
    for (int m = 0; m < 2; ++m)
      for (int j = tid / kTile; j < s; j += kThreads / kTile)
        copy4(dst + m * kChildFloats + j * kTile + lx, base[m] + j * a.T, in);
  }
  __device__ __forceinline__ float* row(const Ref& f, int q, int i) const {
    return pool(f) + f.op.p + ((long long)q * a.states + i) * a.T;
  }
  __device__ __forceinline__ void store(
      const Ref& f, int q, int rg, int sg, int s,
      const float (&x)[states64::kRows][states64::kCols]) const {
    using namespace states64;
    const long long c = f.c0 + sg * kCols;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (rg * kRows + i >= s) break;
      float* dst = row(f, q, rg * kRows + i) + c;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (c + k < f.op.w) dst[k] = x[i][k];
    }
  }
  __device__ __forceinline__ void rescale(const Ref& f, int q, int rg, int sg,
                                          int s, const bool (&d)[states64::kCols]) const {
    using namespace states64;
    const long long c = f.c0 + sg * kCols;
    for (int i = 0; i < kRows && rg * kRows + i < s; ++i) {
      float* dst = row(f, q, rg * kRows + i) + c;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (d[k] && c + k < f.op.w) dst[k] *= a.factor;
    }
  }
  // count group q (a rate's in per-rate mode) of the trial's scaler pool
  __device__ __forceinline__ int* counts(const Ref& f, int q) const {
    return trial_buf<TRIALS>(a.sc, a.sc_trial, f.k) + q * a.T2;
  }
  __device__ __forceinline__ void child_counts(const Ref& f, int q, int sg,
                                               int (&k)[states64::kCols]) const {
    const long long c = f.c0 + sg * states64::kCols;
    const int* sc = counts(f, q);
#pragma unroll
    for (int j = 0; j < states64::kCols; ++j)
      k[j] = c + j < f.op.w ? sc[f.op.s1 + __ldg(a.gl + f.op.g + c + j)] +
                                  sc[f.op.s2 + __ldg(a.gr + f.op.g + c + j)]
                            : 0;
  }
  __device__ __forceinline__ void count(const Ref& f, int q, int sg,
                                        const int (&k)[states64::kCols],
                                        const bool (&d)[states64::kCols]) const {
    const long long c = f.c0 + sg * states64::kCols;
    int* sc = counts(f, q) + f.op.psc + c;
#pragma unroll
    for (int j = 0; j < states64::kCols; ++j)
      if (c + j < f.op.w) sc[j] = k[j] + d[j];
  }
};

template <bool TRIALS>
__global__ void __launch_bounds__(states64::kThreads, states64::kBlocksPerSm)
    pool_generic64(Pooled64<TRIALS> src, long long n_tiles, long long per_block) {
  const long long t0 = (long long)(blockIdx.x / cooperative_groups::this_cluster()
                                                    .num_blocks()) * per_block;
  const long long t1 = min(t0 + per_block, n_tiles);
  states64::run(src, t0, t1, src.a.rates, src.a.states, src.a.threshold,
                src.a.factor, src.a.rate_scalers != 0);
}

// The clusters of pool_generic64 the current device keeps resident.
int resident64(int cluster) {
  return states64::resident(pool_generic64<false>, 1, cluster);
}

// One launch of the 64-state variant over the level's tile map (`granules`
// entries, each trial's), with ops/_kernels.py:pool_plan's layout
// recomputed here; a launch whose cluster or run length differs is
// refused.
template <bool TRIALS>
cudaError_t launch_generic64(const Args& a, const int* map, int granules,
                             int cluster, int per_block, int trials,
                             cudaStream_t st) {
  const long long tiles = (long long)granules * (kGranule / states64::kTile);
  const long long n_tiles = tiles * trials;
  const int c = a.rates < states64::kMaxCluster ? a.rates : states64::kMaxCluster;
  const int resident = resident64(c);
  if (resident < 0) return static_cast<cudaError_t>(-resident);
  const states64::Plan p = states64::plan(n_tiles, a.rates, resident);
  if (p.cluster != cluster || p.per_block != per_block ||
      p.runs * p.cluster > 2147483647LL)
    return cudaErrorInvalidValue;
  Pooled64<TRIALS> src{a, reinterpret_cast<const int2*>(map), tiles};
  return states64::launch(pool_generic64<TRIALS>, p.runs, p.cluster, st, src,
                          n_tiles, p.per_block);
}

template <bool TRIALS>
cudaError_t launch_update(const Args& a, const int* map, int granules, int ty,
                          int per_block, int trials, int cluster,
                          cudaStream_t st) {
  const int states = a.states;
  if (states > 32) {
    return launch_generic64<TRIALS>(a, map, granules, cluster, per_block,
                                    trials, st);
  } else if (states == 20) {
    launch_generic<20, true, TRIALS>(a, map, granules, ty, per_block, trials, st);
  } else if (states <= 4) {
    launch_generic<4, false, TRIALS>(a, map, granules, ty, per_block, trials, st);
  } else if (states <= 8) {
    launch_generic<8, false, TRIALS>(a, map, granules, ty, per_block, trials, st);
  } else if (states <= 16) {
    launch_generic<16, false, TRIALS>(a, map, granules, ty, per_block, trials, st);
  } else if (states <= 20) {
    launch_generic<20, false, TRIALS>(a, map, granules, ty, per_block, trials, st);
  } else {
    launch_generic<32, false, TRIALS>(a, map, granules, ty, per_block, trials, st);
  }
  return cudaSuccess;
}

template <bool TRIALS>
void launch_traversal(const Args& a, const Trav& tv, int blocks,
                      cudaStream_t st) {
  if (a.rate_scalers) {
    pool_traversal<true, TRIALS><<<blocks, kTravThreads, 0, st>>>(a, tv);
  } else {
    pool_traversal<false, TRIALS><<<blocks, kTravThreads, 0, st>>>(a, tv);
  }
}

}  // namespace

// Launches one level of the runtime-size variant on `stream` and returns
// cudaGetLastError() (0 on success). T2 is the scaler pool's column count
// (its row stride in per-rate mode). The grid covers the level's tile map
// (`map`, `granules` int32 pairs) with the layout of
// ops/_kernels.py:pool_plan: `rate_threads` warps over the rates and
// `per_block` tiles a block; from 33 states on (1 rate warp) `cluster`
// blocks a cluster, one rate a block, and `per_block` tiles a run over
// every trial's tiles. `trials` 0 is the one-topology form; trials > 0 the
// trial form over that many trials, the trials' strides in elements.
// The 4x4 size runs pll_pool_traversal.
extern "C" int pll_pool_update(float* pool, int* sc, const float* pmat,
                               const long long* table, int ld, long long T,
                               const int* gl, const int* gr, int rates,
                               int states, float threshold, float factor,
                               long long T2, int rate_scalers, const int* map,
                               int granules, int rate_threads, int per_block,
                               int trials, long long pool_trial,
                               long long sc_trial, long long p_trial,
                               int cluster, void* stream) {
  Args a{pool, sc, pmat, table, ld, T, gl, gr, rates, states, threshold,
         factor, T2, rate_scalers, pool_trial, sc_trial, p_trial};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ty = rate_threads;
  if ((states == 4 && rates == 4) || !(ty == 1 || ty == 2 || ty == 4) ||
      granules < 1 || per_block < 1 || map == nullptr || trials < 0 ||
      trials > 65535 || states < 1 || states > states64::kSP || rates < 1 ||
      (states > 32 && ty != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      trials > 0 ? launch_update<true>(a, map, granules, ty, per_block,
                                       trials, cluster, st)
                 : launch_update<false>(a, map, granules, ty, per_block, 1,
                                        cluster, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of `cluster` blocks of the 64-state variant that the current
// device keeps resident at once (ops/_kernels.py:pool_plan's `resident`),
// or a negative CUDA error.
extern "C" int pll_pool64_resident(int cluster) { return resident64(cluster); }

// Launches the 4x4 kernel over `n_tiles` tickets of 64 class columns on
// `stream` and returns the first CUDA error (0 on success). `tickets` are
// int4 rows (op, first column, wait range), `waits` int2 rows (op, its tile
// count) or null for one level, whose ops need none. `counters` holds
// `n_counters` ints: the ticket counter, then one count of finished tiles
// for each op of the table (`n_ops` of them; for each trial in the trial
// form), each on a 128-byte line of its own (kCounterStride ints); they are
// zeroed on the stream before the kernel. `blocks` comes from
// ops/_kernels.py:pool_fixed_plan; any grid is safe, since a tile waits
// only on tiles of smaller tickets. `trials` 0 is the one-topology form;
// trials > 0 draws n_tiles * trials tickets, ticket j * trials + k being
// tile j of trial k.
extern "C" int pll_pool_traversal(float* pool, int* sc, const float* pmat,
                                  const long long* table, int ld, long long T,
                                  const int* gl, const int* gr,
                                  float threshold, float factor, long long T2,
                                  int rate_scalers, const int* tickets,
                                  int n_tiles, const int* waits, int* counters,
                                  int n_counters, int blocks, int trials,
                                  int n_ops, long long pool_trial,
                                  long long sc_trial, long long p_trial,
                                  void* stream) {
  const long long k = trials > 0 ? trials : 1;
  if (blocks < 1 || n_tiles < 1 || tickets == nullptr ||
      counters == nullptr || trials < 0 || n_ops < 1 ||
      (long long)n_counters < (1 + k * n_ops) * kCounterStride ||
      (long long)n_tiles * k + blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{pool, sc, pmat, table, ld, T, gl, gr, 4, 4, threshold, factor, T2,
         rate_scalers, pool_trial, sc_trial, p_trial};
  Trav tv{reinterpret_cast<const int4*>(tickets), n_tiles,
          reinterpret_cast<const int2*>(waits), counters,
          counters + kCounterStride, (int)k, n_ops};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(counters, 0, (size_t)n_counters * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (trials > 0) {
    launch_traversal<true>(a, tv, blocks, st);
  } else {
    launch_traversal<false>(a, tv, blocks, st);
  }
  return static_cast<int>(cudaGetLastError());
}
