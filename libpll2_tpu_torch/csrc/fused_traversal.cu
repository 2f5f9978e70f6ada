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
// Candidates. One launch walks K tables at once (candidate scoring,
// TreeEngine.evaluate_topologies; libpll2_tpu/engine.py:_fused_multi_topology
// vmaps the Pallas kernel, which adds this grid dimension): the table
// [K, n_ops + 1, 8], P [K, E, R, s, s], the spill plan's slots and the
// outputs gain a leading K, the tip codes and raw tip rows are shared.
// Candidate k is blockIdx.y; its blocks offset every per-candidate pointer
// by k strides (`candidate`) and then run the one-topology walk unchanged.
// One topology is the case K = 1. A walk alone at 128 x 16384 fills under
// half of the card's block slots; a chunk of candidates fills them all, so
// a candidate costs less than a walk alone (PERF.md).
//
// Queries. Placement (libpll2_tpu/placement.py:_place_scores vmaps the
// kernel over Q queries' tip codes for each attachment edge) scores Q
// queries against K candidates, one per attachment edge, in one launch:
// query q is blockIdx.z, and every walk of the [Q, K] grid reads tip row
// `query_row` from the query's codes `qcodes + q * S` and every other tip
// row from the shared matrix (`tip_row`). No [Q, tips, S] copy of the codes
// is made. The outputs and the spill plan's slots are [Q, K, ...], walk
// (q, k) at flat index q * K + k (`walk_index`); the table and P stay
// per candidate. Without queries `query_row` is -1, no row is replaced and
// the grid's z is 1.
//
// Slot reuse. pack_fused_schedule frees a dying child's slot before it
// allocates the parent, so a parent may overwrite a child it reads. A thread
// reads every child entry its outputs need into registers before it stores
// any of them (a lane of the generic body writes only its own column, which
// needs only its own child columns), and a child's count of a rate is read
// before the parent's count of that rate is stored.
//
// What bounds it on an H100. Operations: 2 * R * s * s FMAs per op and site
// (128 for DNA GTR+G4) and the elementwise product; at 128 taxa x 16384
// sites, 126 ops, that is 0.56 GFLOP, 8.4 us at the 67 TFLOP/s float32 peak
// of the CUDA cores. Bytes: the tips' codes are read once (8.4 MB, 2.5 us at
// 3.35 TB/s), P is small (65 KB) and the root outputs are 8.4 MB. Every
// inner CLV is produced and consumed inside the walk, so a design that keeps
// them on chip is bound by operations and instruction issue, not by memory.
//
// Plans (ops/_kernels.py:fused_plan picks one from the bytes before the
// launch; the entry below recomputes the bytes and refuses a launch whose
// layout it does not share):
//
//   on-chip (fused_onchip, 4 states x 4 rates, per-site or per-rate counts):
//     four neighbouring lanes hold the 4 rates of one site, or of two sites
//     8 lanes apart (SPT = 2 sites a thread, where blocks of 64 sites still
//     reach half the SMs: P's rows, the table row and the op's bookkeeping
//     then serve two sites). A thread keeps its rate's child columns and
//     products in registers, 2 x 16 FMAs a site and op; the per-site
//     rescale test is one warp vote (__ballot_sync): the site's 16 values
//     are all below the threshold exactly when their max is, so the counts
//     stay the plain version's; per-rate mode needs no vote. A
//     block keeps its sites' slots in shared memory for the whole walk,
//     [slot][site][rate][4] floats, so a child column is one conflict-free
//     16-byte load, and each thread keeps its own copy of its sites' counts
//     ([slot][SPT][thread] ints, equal within a site's lanes in per-site
//     mode). No thread reads a word another compute thread wrote, and
//     children are read into registers before the parent is stored (slot
//     reuse). Nothing on an op's chain waits for device memory: a fifth,
//     producer warp stages each op's inputs (its table row, its rows of
//     P[m1] and P[m2], and the block's tip codes or raw tip rows) with
//     cp.async into a ring of kDepth entries, up to kDepth ops ahead; an
//     entry's full mbarrier completes when the copies have landed, its empty
//     mbarrier when all 128 compute threads have read it. A compute thread
//     waits on one mbarrier an op and arrives on another; there is no block
//     barrier after the barriers' initialisation. A rate's 4 x 4 block of P
//     is padded to 20 floats, so the 4 rates' rows fall in distinct banks.
//     DNA (7 slots) takes 48,848 bytes a block at two sites a thread.
//   on-chip in a thread block cluster (the same body, `cluster` blocks): a
//     walk's only parallelism is its sites, and its ops run one after
//     another, so a walk alone leaves most of the card's warps idle (at 128
//     x 16384, 256 blocks: 8 compute warps an SM). A walk's disjoint
//     subtrees are independent: ops/fused.py:split_fused_schedule splits
//     the table into one program a block, each with its own slots, and a
//     top stream (the ops above the subtree roots). The cluster's blocks
//     take the same block of sites, each walks its program side by side in
//     its own shared memory; a peer then arrives on block 0's join mbarrier
//     (release at cluster scope, one arrival a compute warp), block 0
//     walks the top stream after it (acquire), reading the roots from the
//     peers' shared memory (distributed shared memory: mapa and
//     ld.shared::cluster; the peer's thread of the same index wrote the
//     column and the count copy a thread reads), writes the root rows and
//     arrives on each peer's done mbarrier, which keeps the peer resident
//     until its roots have been read. Every op is the same row with other
//     slots, so each block computes what the whole walk computes, to the
//     bit. ops/_kernels.py:fused_plan picks the cluster from a model of
//     the waves and the issue limit; launches that fill the card's block
//     slots without it keep one block a walk.
//   spill (fused_fixed, 4 x 4): where the slots do not fit in a block's
//     shared memory, one thread owns one site and the slots stay in device
//     memory [K][n_slots][R * s][S], as the launcher allocates them.
//   other sizes: the runtime-size body, fused_generic, on its own plans
//     (ops/_kernels.py:generic_plan; below).
//
// float64 (pll_fused_traversal_f64): the runtime-size body is a template on
// its floating type. Its float64 instantiation is the certified final
// evaluation's walk (libpll2_tpu_torch/ops/df64.py), which on the TPU is
// XLA's double-single scan (libpll2_tpu/ops/df64.py), not a Pallas kernel:
// one topology, per-site counts, state codes or raw tip rows, float64's own
// scaling window.
//
// The on-chip walk is bound by instruction issue and latency, not by
// operations: its per-op bookkeeping (the row, the barriers, the vote and
// counts) costs more instructions than its 32 FMAs a site, and a warp's
// ops run one after another. PERF.md has the measurements.
//
// Numerics: build without --use_fast_math (IEEE division, no flush to zero,
// so 2^-64 stays a normal float). nvcc contracts a*b+c into FMAs, which
// rounds differently from PyTorch's CPU einsum; the tests allow for it.

#include <cuda_runtime.h>
#include <stddef.h>

// in fused_traversal_rows.cu: the opt-in limit of a block's dynamic shared
// memory on the current device, or a negative CUDA error code
extern "C" int pll_rows_smem_optin();

namespace {

constexpr int kRow = 8;      // op table row width
constexpr int kBlock = 64;   // 4 x 4 spill plan: threads (sites) per block
// on-chip plan: compute warps a block (4 threads hold the 4 rates of a site)
// and one producer warp; ops whose inputs are in flight (a ring of kDepth
// entries a block); a rate's 4 x 4 block of P padded to 20 floats (the 4
// rates' rows then fall in distinct banks)
constexpr int kComputeWarps = 4;
constexpr int kComputeThreads = 32 * kComputeWarps;
constexpr int kOnchipThreads = kComputeThreads + 32;
constexpr int kDepth = 4;
constexpr int kRateWords = 20;
constexpr int kSideWords = 4 * kRateWords;
// the split table of a cluster (ops/fused.py:split_fused_schedule): a
// child in a peer's shared memory (is_tip kRemote, index rank <<
// kRankShift | slot), the header's rows after the root row, the blocks a
// cluster at most (the portable limit)
constexpr int kRemote = 3;
constexpr int kRankShift = 16;
constexpr int kSplitHeader = 3;
constexpr int kMaxCluster = 8;

template <typename T>
struct ArgsT {
  const int* table;    // [n_ops + 1, 8]
  int n_ops;
  const T* pmat;       // [E, R, s, s]
  const int* tips;     // [n_tips, S]
  const T* ctips;      // [n_ctips, s, S] raw tip rows, or null
  const int* qcodes;   // [Q, S] the queries' tip codes, or null
  int query_row;       // the tip row a query's codes replace (-1: none)
  int sites;
  int rates, states;
  T* slots;            // [n_slots + 1, R * s, S]; the last is the spare
  int* slot_sc;        // [n_slots, SR, S], SR = R per rate, else 1
  int n_slots;
  T* out_p;            // [R * s, S]
  T* out_c;
  int* sc_p;           // [SR, S]
  int* sc_c;
  T threshold, factor;
  int rate_scalers;
  // the strides of the candidate axis (table, P) and of the walk axis
  // (slots, outputs), in elements (0 for the slots on chip)
  long long table_stride, pmat_stride, slot_stride, slot_sc_stride;
  long long out_stride, sc_stride;
  // the on-chip 4 x 4 body's thread block cluster: blocks that walk the
  // same sites, each its part of a split table (1: the packed table)
  int cluster;
};

// the float32 walks; the generic one is also instantiated in float64
// (pll_fused_traversal_f64, the certified evaluation)
using Args = ArgsT<float>;

// Candidate blockIdx.y's table and P, and walk (blockIdx.z, blockIdx.y)'s
// spilled slots. The on-chip walk
// computes them where it uses them: its producer warp holds the table's
// pointer and offsets each copy of P by the candidate there, its root
// epilogue reads the table's last row. Every kernel finds a candidate's
// outputs where it writes them (`out_clv`, `out_sc`). Held in registers
// from the kernel's start, these pointers cost the one-topology walk 3-8
// %, and a P pointer held over the producer's loop cost the all-raw-tip
// walk 4 % (PERF.md has the measurements).
template <typename T>
struct CandT {
  const int* table;
  const T* pmat;
  T* slots;
  int* slot_sc;
};
using Cand = CandT<float>;

// blockIdx.y, read where it is used: a volatile read keeps the compiler
// from computing the candidate's pointers at the kernel's start and holding
// them in registers over the walk
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

template <typename T>
__device__ __forceinline__ CandT<T> candidate(const ArgsT<T>& a) {
  const long long k = cand_index(), w = walk_index();
  return {a.table + k * a.table_stride, a.pmat + k * a.pmat_stride,
          a.slots + w * a.slot_stride, a.slot_sc + w * a.slot_sc_stride};
}

// the walk's root CLV rows of the parent (end 0) or child end
template <typename T>
__device__ __forceinline__ T* out_clv(const ArgsT<T>& a, int end) {
  return (end ? a.out_c : a.out_p) + walk_index() * a.out_stride;
}

// and their counts
template <typename T>
__device__ __forceinline__ int* out_sc(const ArgsT<T>& a, int end) {
  return (end ? a.sc_c : a.sc_p) + walk_index() * a.sc_stride;
}

// the state codes of tip row `idx`: the block's query's in place of row
// query_row
template <typename T>
__device__ __forceinline__ const int* tip_row(const ArgsT<T>& a, int idx) {
  if (idx == a.query_row) return a.qcodes + (size_t)query_index() * a.sites;
  return a.tips + (size_t)idx * a.sites;
}

template <typename T = float>
__device__ __forceinline__ T tip_bit(unsigned code, int j) {
  return static_cast<T>((code >> j) & 1u);
}

// ---------------------------------------------------------------------------
// The on-chip plan (4 states x 4 rates), SPT sites a compute thread: a
// block holds SPB = 32 * SPT sites. Shared memory layout, in 4-byte words
// (every part a multiple of 16 bytes):
//   barriers [2][kDepth] uint64: full (the producer's copies of an entry
//            landed) and empty (the compute threads are done with it);
//            then [2] uint64 of a cluster: join (block 0: the peers' streams
//            are done) and done (a peer: block 0 has read its roots)
//   ring     [kDepth][ring_words(SPT)]: one op's inputs,
//            [row 8 int][P 2 sides x 4 rates x kRateWords]
//            [raw tips 2 x SPB sites x 4 float][tip codes 2 x SPB int]
//   slots    [n_slots][SPB][4 rates][4] float
//   counts   [n_slots][SPT][kComputeThreads] int, one copy a thread
// ops/_kernels.py:fused_plan computes the same bytes.
__host__ __device__ constexpr int ring_words(int spt) {
  return kRow + 2 * kSideWords + 2 * 32 * spt * 5;
}

__host__ __device__ inline size_t onchip_smem_words(int n_slots, int spt) {
  const size_t spb = 32 * spt;
  return 4 * kDepth + 4 + (size_t)kDepth * ring_words(spt) +
         (size_t)n_slots * (spb * 16 + (size_t)spt * kComputeThreads);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of `bar` with this parity has completed; a lost arrival
// traps (the launch fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned n = 0; !mbar_try_wait(bar, parity); ++n) {
    if (n == (1u << 24)) __trap();
  }
}

// Distributed shared memory. `addr` (a shared::cta address of this block)
// as the same place in the cluster's block `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 peer_load4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ int peer_load(unsigned addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// one arrival on a peer's mbarrier, ordered after this thread's earlier
// shared-memory accesses for the cluster
__device__ __forceinline__ void peer_arrive(unsigned addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// mbar_wait whose reads after it see the peers' writes before their
// arrivals (peer_arrive)
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// The cluster barrier, split: every thread of the cluster arrives once its
// block's mbarriers are initialised (fence.mbarrier_init by the thread that
// initialised them), and waits before its first access to a peer's shared
// memory, so that the barrier's latency hides behind the walk.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The column `col` of the slot that `idx` (rank << kRankShift | slot)
// names in the cluster's block `rank`, and in `sc` the count copy
// `count_at` there (the same place in the peer's shared memory as this
// block's slot and count of that index)
template <int SPT>
__device__ __forceinline__ float4 peer_slot(const float4* slots, const int* cnt, int idx,
                                            int col, int count_at, int& sc) {
  const unsigned peer = static_cast<unsigned>(idx) >> kRankShift;
  const int sl = idx & ((1 << kRankShift) - 1);
  sc = peer_load(peer_addr(smem_addr(cnt + sl * SPT * kComputeThreads + count_at), peer));
  return peer_load4(peer_addr(smem_addr(slots + sl * 32 * SPT * 4 + col), peer));
}

// The rows [begin, begin + n) of the candidate's table that this block
// walks, and for block 0 of a cluster the op `join` (counted from begin)
// from which it reads its peers' subtree roots: after the top stream's
// first op, or after its last op when the top stream is empty (n). Without
// a cluster the whole table, no join (-1).
struct Program {
  int begin, n, join;
};

template <bool CLUSTER>
__device__ __forceinline__ Program program(const Args& a, const int* table) {
  if (!CLUSTER) return {0, a.n_ops, -1};
  const int rank = blockIdx.x % a.cluster;
  const int* const head = table + (size_t)(a.n_ops + 1) * kRow;
  const int begin = __ldg(head + rank);
  return {begin, __ldg(head + kRow + rank) - begin,
          rank == 0 ? __ldg(head + 2 * kRow) - begin : -1};
}

// The producer warp: op k's inputs into ring entry k % kDepth once the
// compute threads are done with it, as one arrival a lane on its full
// barrier: its table row, its rows of P[m1] and P[m2] (4 rates x 4 rows x 16
// bytes each, one 16-byte copy a lane) and, for the block's SPB sites (past
// the last site: the last), its tip codes or its raw tips' rows. Table rows
// are read one op ahead.
template <int SPT, bool CLUSTER>
__device__ __forceinline__ void produce(const Args& a, const Program& pg, float* ring,
                                        unsigned long long* full,
                                        unsigned long long* empty, int lane) {
  constexpr int SPB = 32 * SPT;
  constexpr int E = ring_words(SPT);
  const size_t S = a.sites;
  const size_t site0 = (size_t)(CLUSTER ? blockIdx.x / a.cluster : blockIdx.x) * SPB;
  size_t sites[SPT];
#pragma unroll
  for (int t = 0; t < SPT; ++t) sites[t] = min(site0 + lane + 32 * t, S - 1);
  // the block's rows of the candidate's table (two int4 a row); P is
  // offset at each copy
  const int4* const table =
      reinterpret_cast<const int4*>(a.table + cand_index() * a.table_stride) + 2 * pg.begin;
  int4 r0 = make_int4(0, 0, 0, 0), r1 = r0;
  if (pg.n > 0) {
    r0 = __ldg(table);
    r1 = __ldg(table + 1);
  }
  for (int k = 0; k < pg.n; ++k) {
    const int4 c0 = r0, c1 = r1;
    if (k + 1 < pg.n) {
      r0 = __ldg(table + 2 * (k + 1));
      r1 = __ldg(table + 2 * (k + 1) + 1);
    }
    const int s = k % kDepth;
    mbar_wait(empty + s, ((k / kDepth) & 1) ^ 1);
    float* const e = ring + s * E;
    if (lane < 2) cp_async16(e + 4 * lane, reinterpret_cast<const int*>(table + 2 * k) + 4 * lane);
    const int side = lane >> 4;
    cp_async16(e + kRow + side * kSideWords + ((lane >> 2) & 3) * kRateWords + (lane & 3) * 4,
               a.pmat + (cand_index() * a.pmat_stride + (size_t)(side ? c1.z : c0.w) * 64) + (lane & 15) * 4);
    float* const raw = e + kRow + 2 * kSideWords;
    int* const codes = reinterpret_cast<int*>(raw + 2 * SPB * 4);
    const int is_tip[2] = {c0.y, c1.x}, idx[2] = {c0.z, c1.y};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (is_tip[c] == 1) {
        const int* const row = tip_row(a, idx[c]);
#pragma unroll
        for (int t = 0; t < SPT; ++t) {
          cp_async4(codes + c * SPB + lane + 32 * t, row + sites[t]);
        }
      } else if (is_tip[c] == 2) {
#pragma unroll
        for (int t = 0; t < SPT; ++t) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cp_async4(raw + (c * SPB + lane + 32 * t) * 4 + j,
                      a.ctips + ((size_t)idx[c] * 4 + j) * S + sites[t]);
          }
        }
      }
    }
    mbar_arrive_copies(full + s);
  }
  cp_async_wait_all();
}

// SPT sites a compute thread (8 apart), one rate; PER_RATE: one count per
// rate. Warps 0 .. kComputeWarps - 1 compute, the last one produces.
// CLUSTER: the block is one of a cluster of a.cluster blocks (consecutive
// blockIdx.x, one block of sites) and walks its program of the split
// table; each compute warp of a peer then arrives on block 0's join
// barrier (one lane, after the warp's __syncwarp: the warp's slot stores
// come before the arrival's release) and keeps the block's shared memory
// until each compute warp of block 0, which walks the top stream after its
// join and writes the root rows, has arrived on its done barrier. Without
// CLUSTER the body walks the packed table with none of the cluster's code,
// which cost the one-block walk 7 % (PERF.md).
template <int SPT, bool PER_RATE, bool CLUSTER>
__global__ void __launch_bounds__(kOnchipThreads) fused_onchip(Args a) {
  constexpr int SW = 8 * SPT;                   // sites a compute warp
  constexpr int SPB = 32 * SPT;                 // sites a block
  constexpr int E = ring_words(SPT);
  extern __shared__ float4 smem4[];
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(smem4);
  unsigned long long* const empty = full + kDepth;
  unsigned long long* const join = empty + kDepth;
  unsigned long long* const done = join + 1;
  float* const ring = reinterpret_cast<float*>(smem4) + 4 * kDepth + 4;
  float4* const slots = reinterpret_cast<float4*>(ring + kDepth * E);
  int* const cnt = reinterpret_cast<int*>(slots + (size_t)a.n_slots * SPB * 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kDepth) {
    mbar_init(full + tid, 32);                 // the producer's lanes
    mbar_init(empty + tid, kComputeThreads);
  }
  if (CLUSTER && tid == 0) {
    mbar_init(join, (a.cluster - 1) * kComputeWarps);
    mbar_init(done, kComputeWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (CLUSTER) cluster_arrive();
  const Program pg = program<CLUSTER>(a, a.table + cand_index() * a.table_stride);
  if (warp == kComputeWarps) {
    produce<SPT, CLUSTER>(a, pg, ring, full, empty, lane);
    if (CLUSTER) cluster_wait();
    return;
  }

  const int rate = lane & 3, q = lane >> 2;
  const size_t S = a.sites;
  const size_t wsite0 =
      (size_t)(CLUSTER ? blockIdx.x / a.cluster : blockIdx.x) * SPB + warp * SW;
  // the thread's sites wsite0 + q + 8 k; threads past the last site run on
  // a copy of it (every lane of a warp takes part in its votes) and write
  // nothing out
  size_t site[SPT];
  int col[SPT];   // float4 column of (site, rate) in a slot
  int bcol[SPT];  // the site in the block
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    site[k] = min(wsite0 + q + 8 * k, S - 1);
    bcol[k] = warp * SW + q + 8 * k;
    col[k] = bcol[k] * 4 + rate;
  }

  for (int op = 0; op < pg.n; ++op) {
    if (CLUSTER && op == pg.join) {   // the peers' roots are stored
      mbar_wait_cluster(join, 0);
      cluster_wait();
    }
    const int s = op % kDepth;
    mbar_wait(full + s, (op / kDepth) & 1);
    const float* const e = ring + s * E;
    const int4 r0 = *reinterpret_cast<const int4*>(e);
    const int4 r1 = *reinterpret_cast<const int4*>(e + 4);
    const int pslot = r0.x, has = r1.w;
    const int is_tip[2] = {r0.y, r1.x}, idx[2] = {r0.z, r1.y};
    // this rate's rows of P[m1] and P[m2], shared by the thread's sites
    const float4* const p1 = reinterpret_cast<const float4*>(e + kRow + rate * kRateWords);
    const float4* const p2 = p1 + kSideWords / 4;
    float4 u[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = p1[i];
      v[i] = p2[i];
    }
    const float* const raw = e + kRow + 2 * kSideWords;
    const int* const codes = reinterpret_cast<const int*>(raw + 2 * SPB * 4);
    // the children's columns of this thread's rate, and their counts
    float c[SPT][2][4];
    int csc[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) csc[k] = 0;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      if (is_tip[ch] == 1) {   // a tip's bit is selected, not converted
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const unsigned code = static_cast<unsigned>(codes[ch * SPB + bcol[k]]);
#pragma unroll
          for (int j = 0; j < 4; ++j) c[k][ch][j] = (code >> j) & 1u ? 1.0f : 0.0f;
        }
      } else if (is_tip[ch] == 2) {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(raw + (ch * SPB + bcol[k]) * 4);
          c[k][ch][0] = w.x; c[k][ch][1] = w.y; c[k][ch][2] = w.z; c[k][ch][3] = w.w;
        }
      } else if (CLUSTER && is_tip[ch] == kRemote) {   // a subtree root in a peer
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          int sc;
          const float4 w =
              peer_slot<SPT>(slots, cnt, idx[ch], col[k], k * kComputeThreads + tid, sc);
          c[k][ch][0] = w.x; c[k][ch][1] = w.y; c[k][ch][2] = w.z; c[k][ch][3] = w.w;
          csc[k] += sc;
        }
      } else {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float4 w = slots[idx[ch] * SPB * 4 + col[k]];
          c[k][ch][0] = w.x; c[k][ch][1] = w.y; c[k][ch][2] = w.z; c[k][ch][3] = w.w;
          csc[k] += cnt[(idx[ch] * SPT + k) * kComputeThreads + tid];
        }
      }
    }
    mbar_arrive(empty + s);   // done with the entry
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      float x[4];
      float m = 0.0f;   // x is non-negative
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ta = u[i].x * c[k][0][0];
        ta = fmaf(u[i].y, c[k][0][1], ta);
        ta = fmaf(u[i].z, c[k][0][2], ta);
        ta = fmaf(u[i].w, c[k][0][3], ta);
        float tb = v[i].x * c[k][1][0];
        tb = fmaf(v[i].y, c[k][1][1], tb);
        tb = fmaf(v[i].z, c[k][1][2], tb);
        tb = fmaf(v[i].w, c[k][1][3], tb);
        x[i] = ta * tb;
        m = fmaxf(m, x[i]);
      }
      bool below = m < a.threshold;
      if (!PER_RATE) {   // all 4 rates of the site: 4 neighbouring lanes
        const unsigned votes = __ballot_sync(0xffffffffu, below);
        below = ((votes >> (lane & ~3)) & 0xFu) == 0xFu;
      }
      if (has && below) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] *= a.factor;
        csc[k] += 1;
      }
      slots[pslot * SPB * 4 + col[k]] = make_float4(x[0], x[1], x[2], x[3]);
      cnt[(pslot * SPT + k) * kComputeThreads + tid] = csc[k];
    }
  }

  if (CLUSTER) {
    if (blockIdx.x % a.cluster != 0) {   // block 0 reads this block's roots
      cluster_wait();
      __syncwarp();
      if (lane == 0) peer_arrive(peer_addr(smem_addr(join), 0));
      mbar_wait(done, 0);
      return;
    }
    if (pg.join == pg.n) {   // no top stream
      mbar_wait_cluster(join, 0);
      cluster_wait();
    }
  }

  // the root edge: each thread writes its rate's rows of its sites, which it
  // stored itself (a slot end), a peer stored (a remote end) or it decodes
  // (a tip end)
  const int* root = candidate(a).table + (size_t)a.n_ops * kRow;
#pragma unroll
  for (int end = 0; end < 2; ++end) {
    const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
    float* const out = out_clv(a, end);
    int* const osc = out_sc(a, end);
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      float v[4];
      int sc = 0;
      if (is_tip == 1) {
        const unsigned cd = static_cast<unsigned>(__ldg(tip_row(a, idx) + site[k]));
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (cd >> j) & 1u ? 1.0f : 0.0f;
      } else if (is_tip == 2) {
        const float* src = a.ctips + (size_t)idx * 4 * S + site[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldg(src + (size_t)j * S);
      } else if (CLUSTER && is_tip == kRemote) {
        const float4 w = peer_slot<SPT>(slots, cnt, idx, col[k], k * kComputeThreads + tid, sc);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
        const float4 w = slots[idx * SPB * 4 + col[k]];
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        sc = cnt[(idx * SPT + k) * kComputeThreads + tid];
      }
      if (wsite0 + q + 8 * k >= S) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(size_t)(rate * 4 + j) * S + site[k]] = v[j];
      if (PER_RATE) {
        osc[rate * S + site[k]] = sc;
      } else if (rate == 0) {
        osc[site[k]] = sc;
      }
    }
  }
  if (CLUSTER) {   // the peers may leave: the warp has read their roots
    __syncwarp();
    if (lane == 0) {
      for (int r = 1; r < a.cluster; ++r) peer_arrive(peer_addr(smem_addr(done), r));
    }
  }
}

// ---------------------------------------------------------------------------
// Sizes known at compile time: the CLVs of one op live in registers. NSC is
// the number of counts per site: 1, or R_ in per-rate mode.
template <int S_, int R_, int NSC>
__device__ __forceinline__ void matvec_child(const Args& a, const Cand& cand,
                                             int is_tip, int idx,
                                             int mat, size_t site,
                                             float (&out)[R_ * S_],
                                             int (&sc)[NSC]) {
  constexpr int RS = R_ * S_;
  const float* __restrict__ P = cand.pmat + (size_t)mat * RS * S_;
  const size_t S = a.sites;
  if (is_tip != 0) {  // a tip, the same for every rate; it counts 0
    float c[S_];
    if (is_tip == 1) {
      const unsigned code = static_cast<unsigned>(__ldg(tip_row(a, idx) + site));
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
  const float* src = cand.slots + (size_t)idx * RS * S + site;
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
  for (int q = 0; q < NSC; ++q) sc[q] += cand.slot_sc[((size_t)idx * NSC + q) * S + site];
}

template <int S_, int R_, int NSC>
__device__ __forceinline__ void write_root_fixed(const Args& a, const Cand& cand,
                                                 int is_tip,
                                                 int idx, size_t site,
                                                 float* out, int* sc) {
  constexpr int RS = R_ * S_;
  const size_t S = a.sites;
  if (is_tip != 0) {
    float c[S_];
    if (is_tip == 1) {
      const unsigned code = static_cast<unsigned>(__ldg(tip_row(a, idx) + site));
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
  const float* src = cand.slots + (size_t)idx * RS * S + site;
#pragma unroll
  for (int k = 0; k < RS; ++k) out[k * S + site] = src[k * S];
#pragma unroll
  for (int q = 0; q < NSC; ++q) {
    sc[q * S + site] = cand.slot_sc[((size_t)idx * NSC + q) * S + site];
  }
}

template <int S_, int R_, int NSC>
__global__ void __launch_bounds__(kBlock) fused_fixed(Args a) {
  const Cand cand = candidate(a);
  constexpr int RS = R_ * S_;
  constexpr int G = RS / NSC;  // rows per count: all of them, or one rate's
  const size_t site = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= (size_t)a.sites) return;
  const size_t S = a.sites;
  for (int op = 0; op < a.n_ops; ++op) {
    const int* row = cand.table + op * kRow;
    float x[RS], y[RS];
    int sc[NSC];
#pragma unroll
    for (int q = 0; q < NSC; ++q) sc[q] = 0;
    matvec_child<S_, R_, NSC>(a, cand, __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
                              site, x, sc);
    matvec_child<S_, R_, NSC>(a, cand, __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),
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
    float* dst = cand.slots + (size_t)pslot * RS * S + site;
#pragma unroll
    for (int k = 0; k < RS; ++k) dst[k * S] = x[k];
#pragma unroll
    for (int q = 0; q < NSC; ++q) cand.slot_sc[((size_t)pslot * NSC + q) * S + site] = sc[q];
  }
  const int* root = cand.table + a.n_ops * kRow;
  write_root_fixed<S_, R_, NSC>(a, cand, __ldg(root), __ldg(root + 1), site,
                                out_clv(a, 0), out_sc(a, 0));
  write_root_fixed<S_, R_, NSC>(a, cand, __ldg(root + 2), __ldg(root + 3), site,
                                out_clv(a, 1), out_sc(a, 1));
}

// ---------------------------------------------------------------------------
// Sizes known at run time: the runtime-size body, fused_generic, for every
// float32 shape but 4 states x 4 rates (1 to 16 states, any rates) and, in
// float64, for the certified evaluation's walk (pll_fused_traversal_f64: 2
// to 32 states, any rates, float64's own scaling window).
//
// A rate a lane: the R rates of a site sit on G neighbouring lanes of one
// warp (G the power of two from min(R, 32); lanes past R idle, and above 32
// rates a lane takes rates r, r + 32, ... one after another), so a warp
// holds 32 / G sites and a block of W compute warps 32 W / G. The state
// count is the template's SP, the width it is built for (4, 8, 16 and, in
// float64, 20 and 32); a smaller count runs on the next width with P's
// padding rows and columns zero (the launcher pads P) and the child's
// padding entries zero. A lane keeps its rate's two child columns in
// registers, forms the parent's entries as products of the two sides' dot
// products, all of them (4 at a time at width 32) before it stores any, and
// stores them to its own column: both child columns are in registers before
// the first store, so a parent that overwrites its child's slot is safe.
// The per-site rescale test is a vote (__ballot_sync) over the site's G
// lanes on "every value below the threshold", which is exact against the
// plain version's max; the rare rescale multiplies the stored column again.
// Per-rate counts need no vote.
//
// Plans (ops/_kernels.py:generic_plan, whose bytes the entry recomputes):
//   on-chip: the block's slots [n_slots][rates a lane][s][lanes] and counts
//     [n_slots][1 or rates a lane][lanes] stay in shared memory for the
//     whole walk, one copy a lane (so no lane reads what another wrote), a
//     column load conflict-free (consecutive lanes, consecutive words). A
//     producer warp stages each op's inputs up to `depth` ops ahead, as the
//     4 x 4 on-chip walk does: its table row, P of both sides and all rates
//     (a rate's SP x SP block padded by 4 words, so that the rates of a
//     warp fall on distinct 16-byte bank groups) and the block's tip codes
//     or raw tip rows, by bulk copies (cp.async.bulk, element copies where
//     a run is not aligned) on a ring of `depth` entries with full and
//     empty mbarriers.
//   spill: the same mapping with the slots [n_slots][R * s][S] and counts
//     [n_slots][SR][S] in device memory, where the on-chip slots do not fit
//     a block's shared memory (or P's two sides do not fit beside them): P
//     is then read through L1 (__ldg), the ring holds the table rows and
//     tips only.
// Sites a block: W from 4 down to 1 until the launch's blocks reach every
// SM (the flagship's 3581 sites at 4 rates: 2 warps, 224 blocks).
//
// What bounds it (PERF.md has the measurements, from clock64 stamps of one
// block in an instrumented copy): an op's chain of dependent shared-memory
// loads, FMAs and stores, 800-1000 cycles at 4 states, with few warps a
// block to hide it at one rate (DNA without +G: 4 compute warps an SM) and
// instruction issue at 8 rates; at float64's width 20 the loads of P (200
// 16-byte loads a side and lane an op). A bulk copy takes ~200 cycles to
// issue, so the producer keeps up only with ops of ~4 of them or more.

// compute warps a block, at most
constexpr int kGenericWarps = 4;
constexpr int kGenericThreads = 32 * (kGenericWarps + 1);

// The generic body's shared-memory layout, in 4-byte words (every part a
// multiple of 16 bytes); ops/_kernels.py:generic_bytes computes the same.
struct GenLayout {
  int g;          // lanes a site
  int rpl;        // rates a lane
  int warps;      // compute warps a block
  int depth;      // ring entries
  int lanes;      // compute lanes a block, 32 * warps
  int spb;        // sites a block, lanes / g
  int prw;        // words of a rate's padded SP x SP block of P
  int code_off;   // an entry's tip codes [2][spb, rounded to 4]
  int raw_off;    // an entry's raw tip rows [2][s][spb] (or none)
  int entry;      // words an entry
  long long slot_off, cnt_off, words;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline GenLayout generic_layout(bool onchip, int rates, int states,
                                                    int sp, int itemsize, int n_slots,
                                                    bool rate_scalers, int warps,
                                                    int depth, bool raw) {
  GenLayout L;
  int g = 1;
  while (g < rates && g < 32) g <<= 1;
  L.g = g;
  L.rpl = (rates + g - 1) / g;
  L.warps = warps;
  L.depth = depth;
  L.lanes = 32 * warps;
  L.spb = L.lanes / g;
  L.prw = sp * sp * itemsize / 4 + 4;
  L.code_off = kRow + (onchip ? 2 * rates * L.prw : 0);
  L.raw_off = L.code_off + 2 * round4(L.spb);
  L.entry = L.raw_off + (raw ? round4(2 * states * L.spb * itemsize / 4) : 0);
  L.slot_off = 4LL * depth + (long long)depth * L.entry;
  const long long nsl = rate_scalers ? L.rpl : 1;
  L.cnt_off = L.slot_off +
              (onchip ? (long long)n_slots * L.rpl * states * L.lanes * itemsize / 4 : 0);
  L.words = L.cnt_off + (onchip ? (long long)n_slots * nsl * L.lanes : 0);
  return L;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

template <typename T>
__device__ __forceinline__ void cp_async_item(T* dst, const T* src) {
  if (sizeof(T) == 8) {
    cp_async8(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

// `bytes` more to land on `bar` (by bulk copies) before its phase completes
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A bulk copy (the tensor memory accelerator): `bytes` (a multiple of 16,
// both ends 16-byte aligned) from device memory, its arrival counted on
// `bar`'s transaction count. One instruction a run, however long: a lane's
// element copies (cp.async) stall its issue once a few are in flight (the
// float64 protein's P, 50 copies a lane, took ~7,300 cycles an op to issue;
// as two bulk copies, ~800 with the rest).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the barriers' initialisation, visible to the bulk copies' arrivals
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// 16 bytes of P: from shared memory, or through L1
__device__ __forceinline__ void load16(const float* p, bool ldg, float (&v)[4]) {
  const float4 w = ldg ? __ldg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load16(const double* p, bool ldg, double (&v)[2]) {
  const double2 w = ldg ? __ldg(reinterpret_cast<const double2*>(p))
                        : *reinterpret_cast<const double2*>(p);
  v[0] = w.x; v[1] = w.y;
}

__device__ __forceinline__ float fma_t(float x, float y, float z) { return fmaf(x, y, z); }
__device__ __forceinline__ double fma_t(double x, double y, double z) { return fma(x, y, z); }

// row i of a rate's P (SP values, 16-byte aligned) times the child column
template <typename T, int SP, bool LDG>
__device__ __forceinline__ T row_dot(const T* p, const T (&c)[SP]) {
  constexpr int N = 16 / sizeof(T);
  T acc = 0;
#pragma unroll
  for (int j = 0; j < SP; j += N) {
    T v[N];
    load16(p + j, LDG, v);
#pragma unroll
    for (int t = 0; t < N; ++t) acc = j + t == 0 ? v[0] * c[0] : fma_t(v[t], c[j + t], acc);
  }
  return acc;
}

// The producer warp of the generic body: op k's table row, its P for both
// sides (on chip), and the block's tip codes or raw tip rows (past the last
// site: the last) into ring entry k % depth, once the compute lanes are done
// with the entry. Runs that are contiguous and 16-byte aligned in device
// memory go by bulk copy (the table row; each side's P, all rates, whose
// blocks the launcher pads as the ring does; the block's run of a tip row's
// codes or of a raw row where the row length allows), their bytes announced
// on the entry's full barrier first; what is left (a ragged last block,
// rows not aligned) goes by element copies, and each lane arrives once its
// element copies have landed. The table's rows come 32 at a time, a row a
// lane, the next 32 loaded while these are used, and reach every lane by
// shuffles: a row read when it is needed would put a device-memory latency
// on every op.
template <typename T, int SP, bool ONCHIP>
__device__ __forceinline__ void produce_generic(const ArgsT<T>& a, const GenLayout& L,
                                                float* ring, unsigned long long* full,
                                                unsigned long long* empty, int lane) {
  const size_t S = a.sites;
  const size_t site0 = (size_t)blockIdx.x * L.spb;
  const int R = a.rates, s = a.states, spb4 = round4(L.spb);
  const unsigned side_bytes = R * L.prw * 4;   // one side's P, all rates
  // the block's sites as one aligned run of every tip row
  const bool run = site0 + L.spb <= S;
  const bool codes_bulk = run && S % 4 == 0 && L.spb % 4 == 0 &&
                          (reinterpret_cast<size_t>(a.tips) & 15) == 0 &&
                          (reinterpret_cast<size_t>(a.qcodes) & 15) == 0;
  const bool raw_bulk = run && (S * sizeof(T)) % 16 == 0 && (L.spb * sizeof(T)) % 16 == 0 &&
                        (reinterpret_cast<size_t>(a.ctips) & 15) == 0;
  const int4* const table = reinterpret_cast<const int4*>(a.table + cand_index() * a.table_stride);
  // rows k0 + lane (this chunk) and k0 + 32 + lane (the next), two int4 a row
  int4 cur0 = make_int4(0, 0, 0, 0), cur1 = cur0, nxt0 = cur0, nxt1 = cur0;
  int e = 0;                                   // the ring entry, and its phase
  unsigned phase = 0;
  if (lane < a.n_ops) {
    nxt0 = __ldg(table + 2 * lane);
    nxt1 = __ldg(table + 2 * lane + 1);
  }
  for (int k = 0; k < a.n_ops; ++k) {
    if ((k & 31) == 0) {
      cur0 = nxt0;
      cur1 = nxt1;
      if (k + 32 + lane < a.n_ops) {
        nxt0 = __ldg(table + 2 * (k + 32 + lane));
        nxt1 = __ldg(table + 2 * (k + 32 + lane) + 1);
      }
    }
    const int from = k & 31;
    const int is_tip[2] = {__shfl_sync(0xffffffffu, cur0.y, from),
                           __shfl_sync(0xffffffffu, cur1.x, from)};
    const int idx[2] = {__shfl_sync(0xffffffffu, cur0.z, from),
                        __shfl_sync(0xffffffffu, cur1.y, from)};
    const int mat[2] = {__shfl_sync(0xffffffffu, cur0.w, from),
                        __shfl_sync(0xffffffffu, cur1.z, from)};
    unsigned long long* const bar = full + e;
    mbar_wait(empty + e, phase ^ 1);
    float* const ent = ring + e * L.entry;
    int* const codes = reinterpret_cast<int*>(ent + L.code_off);
    T* const raw = reinterpret_cast<T*>(ent + L.raw_off);
    unsigned tx = kRow * 4 + (ONCHIP ? 2 * side_bytes : 0u);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (is_tip[c] == 1 && codes_bulk) tx += L.spb * 4;
      if (is_tip[c] == 2 && raw_bulk) tx += (unsigned)(s * L.spb * sizeof(T));
    }
    if (lane == 0) mbar_expect_tx(bar, tx);
    __syncwarp();
    if (lane == 0) bulk_copy(ent, table + 2 * k, kRow * 4, bar);
    if (ONCHIP && lane < 2) {
      const float* const pm = reinterpret_cast<const float*>(a.pmat + cand_index() * a.pmat_stride);
      bulk_copy(ent + kRow + lane * R * L.prw, pm + (size_t)mat[lane] * R * L.prw, side_bytes,
                bar);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (is_tip[c] == 1) {
        const int* const row = tip_row(a, idx[c]);
        if (codes_bulk) {
          if (lane == 2 + c) bulk_copy(codes + c * spb4, row + site0, L.spb * 4, bar);
        } else {
          for (int t = lane; t < L.spb; t += 32) {
            cp_async4(codes + c * spb4 + t, row + min(site0 + t, S - 1));
          }
        }
      } else if (is_tip[c] == 2) {
        const T* const rows = a.ctips + (size_t)idx[c] * s * S;
        if (raw_bulk) {
          for (int j = lane; j < s; j += 32) {
            bulk_copy(raw + (c * s + j) * L.spb, rows + j * S + site0,
                      (unsigned)(L.spb * sizeof(T)), bar);
          }
        } else {
          for (int q = lane; q < s * L.spb; q += 32) {
            const int j = q / L.spb, t = q - j * L.spb;
            cp_async_item(raw + (c * s + j) * L.spb + t, rows + j * S + min(site0 + t, S - 1));
          }
        }
      }
    }
    mbar_arrive_copies(bar);
    if (++e == L.depth) {
      e = 0;
      phase ^= 1;
    }
  }
  cp_async_wait_all();
}

template <typename T, int SP, bool ONCHIP>
__global__ void __launch_bounds__(kGenericThreads) fused_generic(ArgsT<T> a, GenLayout L) {
  // the parent's rows are made UI at a time, all of a group in registers
  // before any is stored: a store between two rows' loads of P would keep
  // the compiler from issuing the second row's loads early (the two could
  // alias), and each row would wait out a shared-memory load. Whole at
  // widths up to 20; 4 at a time at 32, whose child columns already take
  // 128 registers in float64
  constexpr int UI = SP <= 20 ? SP : 4;
  extern __shared__ float4 smem4[];
  float* const words = reinterpret_cast<float*>(smem4);
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(smem4);
  unsigned long long* const empty = full + L.depth;
  float* const ring = words + 4 * L.depth;
  T* const sm_slots = reinterpret_cast<T*>(words + L.slot_off);
  int* const sm_cnt = reinterpret_cast<int*>(words + L.cnt_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < L.depth) {
    mbar_init(full + tid, 32);                 // the producer's lanes
    mbar_init(empty + tid, L.lanes);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == L.warps) {
    produce_generic<T, SP, ONCHIP>(a, L, ring, full, empty, lane);
    return;
  }

  const int R = a.rates, s = a.states, g = L.g, lanes = L.lanes;
  const int gl = lane & (g - 1);               // the lane's first rate
  const int bs = tid / g;                      // its site in the block
  const size_t S = a.sites;
  const size_t site_at = (size_t)blockIdx.x * L.spb + bs;
  // lanes past the last site run on a copy of it (every lane takes part in
  // the votes and barriers) and store nothing to device memory
  const bool live = site_at < S;
  const size_t site = live ? site_at : S - 1;
  const bool per_rate = a.rate_scalers != 0;
  const unsigned group = g == 32 ? 0xffffffffu : ((1u << g) - 1) << (lane & ~(g - 1));
  const int spb4 = round4(L.spb), nsl = per_rate ? L.rpl : 1;
  const T threshold = a.threshold, factor = a.factor;
  // the spilled slots and counts of this walk
  T* const gl_slots = ONCHIP ? nullptr : a.slots + walk_index() * a.slot_stride;
  int* const gl_cnt = ONCHIP ? nullptr : a.slot_sc + walk_index() * a.slot_sc_stride;

  // the lane's column of its rate r = gl + rr * g in a slot, entry j at
  // at(column, j), and its count q of a slot; on chip in 32-bit offsets
  // (the address arithmetic is most of an op's instructions otherwise)
  const int slab = s * lanes;                  // a slot's rows of one rr, on chip
  auto column = [&](int slot, int rr) -> T* {
    if (ONCHIP) return sm_slots + (slot * L.rpl + rr) * slab + tid;
    return gl_slots + ((size_t)slot * R + gl + rr * g) * s * S + site;
  };
  auto at = [&](T* col, int j) -> T& {
    if (ONCHIP) return col[j * lanes];
    return col[(size_t)j * S];
  };
  auto cnt_at = [&](int slot, int q) -> int* {
    if (ONCHIP) return sm_cnt + (slot * nsl + q) * lanes + tid;
    return gl_cnt + ((size_t)slot * (per_rate ? R : 1) + (per_rate ? gl + q * g : 0)) * S + site;
  };

  int e = 0;                                   // the ring entry, and its phase
  unsigned phase = 0;
  for (int op = 0; op < a.n_ops; ++op) {
    mbar_wait(full + e, phase);
    const float* const ent = ring + e * L.entry;
    const int4 r0 = *reinterpret_cast<const int4*>(ent);
    const int4 r1 = *reinterpret_cast<const int4*>(ent + 4);
    const int pslot = r0.x, has = r1.w;
    const int is_tip[2] = {r0.y, r1.x}, idx[2] = {r0.z, r1.y}, mat[2] = {r0.w, r1.z};
    const int* const codes = reinterpret_cast<const int*>(ent + L.code_off);
    const T* const raw = reinterpret_cast<const T*>(ent + L.raw_off);
    // per site: the children's counts, read before the parent's is stored
    int csc = 0;
    if (!per_rate) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (is_tip[ch] == 0) csc += *cnt_at(idx[ch], 0);
      }
    }
    bool below_all = true;
    for (int rr = 0; rr < L.rpl; ++rr) {
      const int r = gl + rr * g;
      if (r >= R) continue;                    // an idle lane votes "below"
      T c[2][SP];
      int rsc = 0;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        if (is_tip[ch] == 1) {   // a tip's bits, the same for every rate
          const unsigned code = static_cast<unsigned>(codes[ch * spb4 + bs]);
#pragma unroll
          for (int j = 0; j < SP; ++j) c[ch][j] = j < s ? tip_bit<T>(code, j) : T(0);
        } else if (is_tip[ch] == 2) {
#pragma unroll
          for (int j = 0; j < SP; ++j) c[ch][j] = j < s ? raw[(ch * s + j) * L.spb + bs] : T(0);
        } else {
          T* const col = column(idx[ch], rr);
#pragma unroll
          for (int j = 0; j < SP; ++j) c[ch][j] = j < s ? at(col, j) : T(0);
          if (per_rate) rsc += *cnt_at(idx[ch], rr);
        }
      }
      // this rate's P of both sides: staged in the entry, or through L1
      const T* p[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        p[ch] = ONCHIP ? reinterpret_cast<const T*>(ent + kRow + (ch * R + r) * L.prw)
                       : reinterpret_cast<const T*>(
                             reinterpret_cast<const float*>(a.pmat + cand_index() * a.pmat_stride) +
                             ((size_t)mat[ch] * R + r) * L.prw);
      }
      bool below = true;
      T* const dst = column(pslot, rr);
#pragma unroll 1
      for (int i0 = 0; i0 < SP; i0 += UI) {
        T x[UI];
#pragma unroll
        for (int u = 0; u < UI; ++u) {
          x[u] = row_dot<T, SP, !ONCHIP>(p[0] + (i0 + u) * SP, c[0]) *
                 row_dot<T, SP, !ONCHIP>(p[1] + (i0 + u) * SP, c[1]);
        }
#pragma unroll
        for (int u = 0; u < UI; ++u) {
          if (i0 + u < s) {
            below = below && x[u] < threshold;
            if (ONCHIP || live) at(dst, i0 + u) = x[u];
          }
        }
      }
      if (per_rate) {   // each rate on its own
        if (has && below) {
          for (int i = 0; i < s; ++i) {
            if (ONCHIP || live) at(dst, i) *= factor;
          }
          rsc += 1;
        }
        if (ONCHIP || live) *cnt_at(pslot, rr) = rsc;
      }
      below_all = below_all && below;
    }
    if (!per_rate) {   // all rates of the site: its g lanes' votes
      const unsigned votes = __ballot_sync(0xffffffffu, below_all);
      if (has && (votes & group) == group) {
        for (int rr = 0; rr < L.rpl; ++rr) {
          if (gl + rr * g >= R) continue;
          T* const col = column(pslot, rr);
          for (int i = 0; i < s; ++i) {
            if (ONCHIP || live) at(col, i) *= factor;
          }
        }
        csc += 1;
      }
      if (ONCHIP) {
        *cnt_at(pslot, 0) = csc;
      } else {
        __syncwarp();   // the site's lanes have read the children's counts
        if (live && gl == 0) *cnt_at(pslot, 0) = csc;
      }
    }
    mbar_arrive(empty + e);   // done with the entry
    if (++e == L.depth) {
      e = 0;
      phase ^= 1;
    }
  }

  // the root edge: each lane writes its rates' rows of its site, which it
  // stored itself (a slot end) or decodes (a tip end)
  const int* const root = a.table + cand_index() * a.table_stride + (size_t)a.n_ops * kRow;
#pragma unroll 1
  for (int end = 0; end < 2; ++end) {
    const int is_tip = __ldg(root + 2 * end), idx = __ldg(root + 2 * end + 1);
    T* const out = out_clv(a, end);
    int* const osc = out_sc(a, end);
    const unsigned code = is_tip == 1 ? static_cast<unsigned>(__ldg(tip_row(a, idx) + site)) : 0u;
    for (int rr = 0; rr < L.rpl; ++rr) {
      const int r = gl + rr * g;
      if (r >= R || !live) continue;
      T* const col = is_tip ? nullptr : column(idx, rr);
      for (int j = 0; j < s; ++j) {
        const T v = is_tip == 1   ? tip_bit<T>(code, j)
                    : is_tip == 2 ? __ldg(a.ctips + ((size_t)idx * s + j) * S + site)
                                  : at(col, j);
        out[(size_t)(r * s + j) * S + site] = v;
      }
      if (per_rate) osc[(size_t)r * S + site] = is_tip ? 0 : *cnt_at(idx, rr);
    }
    if (!per_rate && live && gl == 0) osc[site] = is_tip ? 0 : *cnt_at(idx, 0);
  }
}

// the width the generic body is built for at `states` states: float32 4, 8
// and 16; float64 also 20 and 32 (0: none)
template <typename T>
int generic_width(int states) {
  const int widths[] = {4, 8, 16, 20, 32};
  const int n = sizeof(T) == 8 ? 5 : 3;
  for (int i = 0; i < n; ++i) {
    if (states <= widths[i]) return widths[i];
  }
  return 0;
}

template <typename T, int SP>
int launch_generic_sp(const ArgsT<T>& a, const GenLayout& L, bool onchip, dim3 grid,
                      size_t bytes, cudaStream_t st) {
  auto kernel = onchip ? fused_generic<T, SP, true> : fused_generic<T, SP, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, 32 * (L.warps + 1), bytes, st>>>(a, L);
  return static_cast<int>(cudaGetLastError());
}

// The generic body's launch with the launcher's plan (ops/_kernels.py:
// generic_plan): on chip or spilled, lanes a site, sites a block, the
// shared-memory bytes, the width SP and the ring's depth. Refuses a plan
// whose layout this file does not share.
template <typename T>
int launch_generic(const ArgsT<T>& a, int n_cand, int n_query, int onchip, int g, int spb,
                   long long smem_bytes, int sp, int depth, cudaStream_t st) {
  constexpr int kAlign = 16 / sizeof(T);
  const int warps = spb * g / 32;
  const GenLayout L = generic_layout(onchip != 0, a.rates, a.states, sp, sizeof(T), a.n_slots,
                                     a.rate_scalers != 0, warps, depth, a.ctips != nullptr);
  if (g != L.g || spb < 1 || spb * g != 32 * warps ||
      (warps != 1 && warps != 2 && warps != kGenericWarps) || (depth != 2 && depth != 4) ||
      sp == 0 || sp != generic_width<T>(a.states) ||
      (reinterpret_cast<size_t>(a.pmat) & 15) != 0 ||
      (reinterpret_cast<size_t>(a.table) & 15) != 0 || a.table_stride % 4 != 0 ||
      a.pmat_stride % kAlign != 0 ||
      (!onchip && (a.slots == nullptr || a.slot_sc == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_smem = pll_rows_smem_optin();
  if (max_smem < 0) return -max_smem;
  const size_t bytes = (size_t)L.words * 4;
  if (bytes != static_cast<size_t>(smem_bytes) || bytes > (size_t)max_smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((a.sites + spb - 1) / spb, n_cand, n_query);
  switch (sp) {
    case 4: return launch_generic_sp<T, 4>(a, L, onchip, grid, bytes, st);
    case 8: return launch_generic_sp<T, 8>(a, L, onchip, grid, bytes, st);
    case 16: return launch_generic_sp<T, 16>(a, L, onchip, grid, bytes, st);
    default: break;
  }
  if constexpr (sizeof(T) == 8) {
    if (sp == 20) return launch_generic_sp<T, 20>(a, L, onchip, grid, bytes, st);
    if (sp == 32) return launch_generic_sp<T, 32>(a, L, onchip, grid, bytes, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Whether the current device keeps at least one cluster of `cfg`'s size of
// `kernel` resident (cudaOccupancyMaxActiveClusters), asked once per device,
// kernel, cluster size and bytes; a CUDA error on failure, and
// cudaErrorInvalidConfiguration where none fits.
template <class K>
cudaError_t cluster_fits(K kernel, const cudaLaunchConfig_t& cfg, int cluster) {
  struct Seen {
    int dev, cluster;
    const void* kernel;
    size_t bytes;
  };
  constexpr int kSeen = 64;
  static Seen seen[kSeen];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* k = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_seen && i < kSeen; ++i) {
    const Seen& e = seen[i];
    if (e.dev == dev && e.cluster == cluster && e.kernel == k && e.bytes == cfg.dynamicSmemBytes)
      return cudaSuccess;
  }
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  seen[n_seen++ % kSeen] = {dev, cluster, k, cfg.dynamicSmemBytes};
  return cudaSuccess;
}

template <int SPT>
int launch_onchip(const Args& a, int n_cand, int n_query, bool per_rate,
                  size_t bytes, cudaStream_t st) {
  const bool cluster = a.cluster > 1;
  auto kernel = per_rate ? (cluster ? fused_onchip<SPT, true, true> : fused_onchip<SPT, true, false>)
                         : (cluster ? fused_onchip<SPT, false, true> : fused_onchip<SPT, false, false>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int spb = 32 * SPT;
  // a cluster's blocks are consecutive along x, one block of sites
  const dim3 grid((a.sites + spb - 1) / spb * a.cluster, n_cand, n_query);
  if (!cluster) {
    kernel<<<grid, kOnchipThreads, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kOnchipThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cluster_fits(kernel, cfg, a.cluster);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or an
// error code without launching when the shapes or the plan do not fit.
// `n_cand` candidates (1 to 65,535, the grid's y) each have a table and P,
// `table_stride` and `pmat_stride` elements apart. `n_query` queries (1 to
// 65,535, the grid's z) replace tip row `query_row` by their codes `qcodes`
// [n_query, S]; without queries `qcodes` is null, `query_row` -1 and
// `n_query` 1. The outputs are [n_query, n_cand, R * s, S] and [n_query,
// n_cand, SR, S]. The trailing arguments are the launcher's
// plan (ops/_kernels.py:fused_plan): on chip or spilled, threads (lanes) a
// site, sites a block and the shared-memory bytes, which must equal this
// file's own count, then the generic body's width SP and ring depth (0 and
// 0 for the 4 x 4 bodies, fused_onchip and fused_fixed). The on-chip plans
// and the generic body take a 16-byte aligned table and P for every
// candidate, the generic body P [E, R, SP * SP + 16 bytes] (each rate's
// block padded with zeros from s x s, then by 16 bytes:
// ops/_kernels.py:generic_pmatrix); the on-chip plans take no slots;
// the spill plans take the slots [n_query * n_cand, n_slots, R * s, S] and
// their counts [n_query * n_cand, n_slots, SR, S] in device memory.
extern "C" int pll_fused_traversal(const int* table, int n_ops,
                                   const float* pmat, int n_cand,
                                   long long table_stride,
                                   long long pmat_stride, const int* tips,
                                   const float* ctips, const int* qcodes,
                                   int query_row, int n_query, int sites,
                                   int rates,
                                   int states, float* slots, int* slot_sc,
                                   int n_slots, float* out_p, float* out_c,
                                   int* sc_p, int* sc_c, float threshold,
                                   float factor, int rate_scalers,
                                   void* stream, int onchip,
                                   int threads_per_site, int sites_per_block,
                                   long long smem_bytes, int padded_states,
                                   int depth, int cluster) {
  const long long S = sites, RS = (long long)rates * states;
  const long long SR = rate_scalers ? rates : 1;
  const bool spill = !onchip;
  Args a{table, n_ops, pmat, tips, ctips, qcodes, query_row, sites, rates, states, slots, slot_sc,
         n_slots, out_p, out_c, sc_p, sc_c, threshold, factor, rate_scalers,
         table_stride, pmat_stride, spill ? n_slots * RS * S : 0,
         spill ? n_slots * SR * S : 0, RS * S, SR * S, cluster};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int head = cluster > 1 ? kSplitHeader : 0;   // the split table's
  if (sites < 1 || n_ops < 0 || n_slots < 1 || rates < 1 || states < 1 ||
      states > 32 || n_cand < 1 || n_cand > 65535 || n_query < 1 ||
      n_query > 65535 || (qcodes == nullptr) != (query_row < 0) ||
      (qcodes == nullptr && n_query != 1) || cluster < 1 || cluster > kMaxCluster ||
      (cluster > 1 && (!onchip || states != 4 || rates != 4 || padded_states != 0)) ||
      table_stride < (long long)(n_ops + 1 + head) * kRow || pmat_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (padded_states != 0) {
    return launch_generic<float>(a, n_cand, n_query, onchip, threads_per_site,
                                 sites_per_block, smem_bytes, padded_states, depth, st);
  }
  if (states != 4 || rates != 4 || depth != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (onchip) {
    // 4 threads hold the 4 rates of one site (threads_per_site 4) or of two
    // sites (2)
    const int spt = threads_per_site == 4 ? 1 : threads_per_site == 2 ? 2 : 0;
    if (spt == 0 || sites_per_block != 32 * spt ||
        (reinterpret_cast<size_t>(pmat) & 15) != 0 ||
        (reinterpret_cast<size_t>(table) & 15) != 0 || table_stride % 4 != 0 ||
        pmat_stride % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t bytes = onchip_smem_words(n_slots, spt) * 4;
    const int max_smem = pll_rows_smem_optin();
    if (max_smem < 0) return -max_smem;
    if (bytes != static_cast<size_t>(smem_bytes) || bytes > (size_t)max_smem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool per_rate = rate_scalers != 0;
    return spt == 1 ? launch_onchip<1>(a, n_cand, n_query, per_rate, bytes, st)
                    : launch_onchip<2>(a, n_cand, n_query, per_rate, bytes, st);
  }
  if (threads_per_site != 1 || sites_per_block != kBlock || smem_bytes != 0 ||
      slots == nullptr || slot_sc == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sites + kBlock - 1) / kBlock, n_cand, n_query);
  if (rate_scalers) {
    fused_fixed<4, 4, 4><<<grid, kBlock, 0, st>>>(a);
  } else {
    fused_fixed<4, 4, 1><<<grid, kBlock, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The certified evaluation's walk (libpll2_tpu_torch/ops/df64.py through
// ops/fused.py:fused_traversal_f64), which takes the place of the XLA
// double-single scan libpll2_tpu/ops/df64.py:_df64_edge_logl: the generic
// body in float64, one topology, per-site counts, any rates, 2 to 32
// states, raw tip rows allowed, with the launcher's plan
// (ops/_kernels.py:generic_plan) as pll_fused_traversal takes it. P [E, R,
// SP * SP + 2] (as pll_fused_traversal's), the raw tip rows, the spill plan's
// slots [n_slots, R * s, S] and the root CLVs [R * s, S] are double; the
// counts [n_slots, 1, S] and [S] int32. Bound by float64 operations (2 * R
// * s * s FMAs an op and site at the card's float64 rate outside the tensor
// cores): a site's rates on neighbouring lanes, its slots on chip and P
// staged one op ahead keep device memory off each op's chain. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or an error code
// without launching when the shapes or the plan do not fit.
extern "C" int pll_fused_traversal_f64(const int* table, int n_ops,
                                       const double* pmat, const int* tips,
                                       const double* ctips, int sites,
                                       int rates, int states, double* slots,
                                       int* slot_sc, int n_slots,
                                       double* out_p, double* out_c,
                                       int* sc_p, int* sc_c, double threshold,
                                       double factor, void* stream, int onchip,
                                       int threads_per_site,
                                       int sites_per_block,
                                       long long smem_bytes,
                                       int padded_states, int depth) {
  const long long S = sites, RS = (long long)rates * states;
  if (sites < 1 || n_ops < 0 || n_slots < 1 || rates < 1 || states < 2 ||
      states > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ArgsT<double> a{table, n_ops, pmat, tips, ctips, nullptr, -1, sites, rates, states,
                  slots, slot_sc, n_slots, out_p, out_c, sc_p, sc_c, threshold, factor,
                  0, (long long)(n_ops + 1) * kRow, 0, onchip ? 0 : n_slots * RS * S,
                  onchip ? 0 : n_slots * S, RS * S, S, 1};
  return launch_generic<double>(a, 1, 1, onchip, threads_per_site, sites_per_block,
                                smem_bytes, padded_states, depth,
                                static_cast<cudaStream_t>(stream));
}
