// The 64-state body of the runtime-size level and pool kernels
// (level_update.cu's level_generic64, pool_update.cu's pool_generic64):
// alphabets of 33 to 64 states (codons: 61 sense codons), padded to 64.
//
// The TPU kernels it stands for: libpll2_tpu/ops/pallas_partials.py:48
// `_kernel` (and `_inplace_kernel` :170, one level of CLV updates) and
// ops/pallas_repeats.py:45 `_run_kernel` (site-repeats class columns, the
// children gathered). For one op and rate r the parent tile is
//   x[i, c] = (sum_j P1[r,i,j] L[r,j,c]) * (sum_j P2[r,i,j] R[r,j,c])
// over 64 padded rows i and a tile of sites or class columns c.
//
// What bounds it on an H100. At 61 states an op, site and rate reads 2 x 61
// child entries, writes 61 and does 2 x 61 x 61 FMAs: 30 FLOP a byte,
// above the card's 20 (67 TFLOP/s float32 over 3.35 TB/s). The 61-state
// problem at 128 x 4096 with 4 rates is bound by operations at 0.46 ms a
// traversal, by bytes at ~0.45 ms: both, so the design feeds the FMA pipes.
// Float32 FMAs on the CUDA cores, not the tensor cores: TF32 could gain
// little where the bytes bound as much, and its accumulation is ~1e-5 off
// (PERF.md §6, PR 5).
//
// The design (ops/_kernels.py:states64_plan lays a launch out; the C
// entries recompute it and refuse another):
// - One rate a block. The block of rate r stages only rate r's P1 and P2,
//   transposed ([j][i], rows kPStride floats apart: 34.8 KB), and keeps
//   them over a run of tiles (rates one after another only above
//   kMaxCluster rates: a block then takes ceil(rates / kMaxCluster)). A new
//   op's P is copied as soon as the contraction before it is done, beside
//   the epilogue.
// - A register-tiled contraction. A thread makes kRows rows x kCols sites
//   of both products (64 accumulators). For each j < s it loads its rows
//   of P1 and P2 as 2 + 2 float4 and its sites of both children as 1 + 1
//   float4 from shared memory: 6 loads for 64 FMAs (the body it replaced
//   made a site a thread and loaded 24), column j + 1's while column j's
//   FMAs run; j ascending as before, so the numbers are the same to the
//   last bit.
// - Children sit as [64][kTile] floats a child, two buffers: the next
//   step's are copied by cp.async (16 bytes where the rows allow it; one
//   entry a copy where the pool kernel gathers them by gl/gr) while this
//   step is computed, and so are the children's counts that the step
//   writes.
// - The rates of one (op, tile) run in one thread block cluster of
//   min(rates, kMaxCluster) blocks. Per site the block reduces its rows'
//   maximum (shared memory) and writes it into every block of the cluster
//   (distributed shared memory: remote stores, which do not wait); after
//   one cluster barrier a tile every block reads the maxima locally,
//   reaches the same rescale decision and scales its own rows in registers
//   before it stores them once; rank 0 writes the counts. Per-rate counts
//   need no exchange. A block with several rates stores the earlier ones
//   unscaled and, on a rescale, multiplies the rows it stored itself.
// - In place: a block reads only its own rates' child rows, each into
//   shared memory before it stores any parent row of that rate, and a
//   prefetch covers other sites (or, between rates, other rows); so an op
//   that writes its own child stays right.
// - Shared memory: 34.8 KB of P, 64 KB of children, 6 KB of maxima; 104 KB
//   a block, two blocks an SM; 167 (level) and 201-209 (pool) registers.
// Measured on an H100 at 61 states, 128 x 4096, 4 rates (PERF.md, Findings):
// a level traversal ~1.33 ms, 2.9x its bound; the 42-op level runs at about
// half the FMA issue rate; a one-op level (64 tiles, 64 clusters of 4 on
// the card's 62 resident: runs of 2 tiles) ~23 us. Deciding a tile after
// the next one's contraction (the barrier's latency hidden) was slower:
// the registers it held rose past 220.
// Padded child entries and P's padded rows and columns are not read or are
// zero, and padded rows are neither stored nor counted in a maximum: 40
// states give the same numbers as any other width would.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace states64 {

namespace cg = cooperative_groups;

constexpr int kSP = 64;           // padded states
constexpr int kThreads = 128;     // a block
constexpr int kBlocksPerSm = 2;   // resident blocks an SM (shared memory)
constexpr int kTile = 64;         // sites (class columns) a tile
constexpr int kMaxCluster = 8;    // blocks a cluster at most (portable)
constexpr int kRows = 8;          // parent rows a thread
constexpr int kCols = 4;          // sites a thread
constexpr int kSiteGroups = kTile / kCols;   // 16: thread t's sites t % 16
constexpr int kPStride = kSP + 4;            // a transposed row of P
constexpr int kPFloats = 2 * kSP * kPStride;
constexpr int kChildFloats = kSP * kTile;    // one child of one buffer
constexpr int kRedFloats = kSP / kRows * kTile;
constexpr int kMaxFloats = 2 * kMaxCluster * kTile;  // [parity][rank][kTile]
constexpr int kSmemFloats = kPFloats + 4 * kChildFloats + kRedFloats + kMaxFloats;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
static_assert(kThreads == kSiteGroups * (kSP / kRows), "a thread a row group "
              "x site group");

// The layout of one launch (ops/_kernels.py:states64_plan): `items` tiles
// (all trials', ops' or granules'), a cluster of min(rates, kMaxCluster)
// blocks for each run of `per_block` consecutive tiles, as many runs as
// `resident` clusters (cudaOccupancyMaxActiveClusters) fill the card once.
struct Plan {
  int cluster;
  long long per_block, runs;
};

inline Plan plan(long long items, int rates, int resident) {
  Plan p{};
  p.cluster = rates < kMaxCluster ? rates : kMaxCluster;
  const long long fill = resident > 0 ? resident : 1;
  p.per_block = (items + fill - 1) / fill;
  p.runs = (items + p.per_block - 1) / p.per_block;
  return p;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from device to shared memory without waiting for them;
// zeros where `ok` is false (`src` is then not read)
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One rate of P1 and P2 (s x s each, row-major) into `pt` transposed:
// pt[m][j][i] = Pm[i][j] for i, j < s. A warp copies a row of P (coalesced);
// the padded entries were zeroed once and are never written.
__device__ __forceinline__ void stage_p(float* pt, const float* p1,
                                        const float* p2, int s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < 2 * s; row += kThreads / 32) {
    const int m = row >= s, i = row - m * s;
    const float* src = (m ? p2 : p1) + i * s;
    float* dst = pt + m * kSP * kPStride + i;
    for (int j = lane; j < s; j += 32) copy4(dst + j * kPStride, src + j, true);
  }
}

// The thread's kRows x kCols tile of both products over j < s, x = product
// of the two.
// `pt` is the transposed P of the rate, `cl` and `cr` the children [j][c].
// Column j + 1's operands are loaded while column j's FMAs run, so a warp
// does not wait on shared memory between columns (the load past the last
// column reads the next row and is not used).
struct Operands {
  float4 u0, u1, v0, v1, l, r;
};

__device__ __forceinline__ Operands operands(const float* p, const float* q,
                                             const float* cl, const float* cr,
                                             int j) {
  Operands o;
  o.u0 = *reinterpret_cast<const float4*>(p + j * kPStride);
  o.u1 = *reinterpret_cast<const float4*>(p + j * kPStride + 4);
  o.v0 = *reinterpret_cast<const float4*>(q + j * kPStride);
  o.v1 = *reinterpret_cast<const float4*>(q + j * kPStride + 4);
  o.l = *reinterpret_cast<const float4*>(cl + j * kTile);
  o.r = *reinterpret_cast<const float4*>(cr + j * kTile);
  return o;
}

__device__ __forceinline__ void contract(const float* pt, const float* cl,
                                         const float* cr, int s, int rg,
                                         int sg, float (&x)[kRows][kCols]) {
  float ta[kRows][kCols], tb[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k) ta[i][k] = tb[i][k] = 0.0f;
  const float* p = pt + rg * kRows;
  const float* q = p + kSP * kPStride;
  cl += sg * kCols;
  cr += sg * kCols;
  Operands o = operands(p, q, cl, cr, 0);
#pragma unroll 4
  for (int j = 0; j < s; ++j) {
    const Operands n = operands(p, q, cl, cr, j + 1);
    const float u[kRows] = {o.u0.x, o.u0.y, o.u0.z, o.u0.w,
                            o.u1.x, o.u1.y, o.u1.z, o.u1.w};
    const float v[kRows] = {o.v0.x, o.v0.y, o.v0.z, o.v0.w,
                            o.v1.x, o.v1.y, o.v1.z, o.v1.w};
    const float l[kCols] = {o.l.x, o.l.y, o.l.z, o.l.w};
    const float r[kCols] = {o.r.x, o.r.y, o.r.z, o.r.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        ta[i][k] = fmaf(u[i], l[k], ta[i][k]);
        tb[i][k] = fmaf(v[i], r[k], tb[i][k]);
      }
    o = n;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k) x[i][k] = ta[i][k] * tb[i][k];
}

// A source of tiles: the level kernel's dense rows or the pool kernel's
// gathered class columns. Each provides
//   Ref ref(long long t)             tile t of the launch's flat list
//   Ref next(Ref, long long tn)      tile tn after the given one (its op
//                                    reused where it is the same)
//   bool same_p(Ref, Ref)            whether two tiles read the same P
//   const float* p(Ref, int m, int q)   P_m (m = 0, 1) of rate q, row-major
//   bool has(Ref)                    whether the op may rescale
//   void children(float*, Ref, int q)   copies rate q's children [2][64][kTile]
//   void store(Ref, int q, int rg, int sg, int s, const float (&x)[..][..])
//   void rescale(Ref, int q, int rg, int sg, int s, const bool (&d)[kCols])
//   void child_counts(Ref, int q, int sg, int (&k)[kCols])
//                                    the sums of the children's counts
//   void count(Ref, int q, int sg, const int (&k)[kCols],
//              const bool (&d)[kCols])   the parent's counts, k + d
// and runs on every thread of the block.
//
// The block's run: tiles t0 .. t1 - 1, for each the block's rates rank,
// rank + cluster, ... (a step each). Per step: wait for this step's
// copies, start the next step's children (and, where this step writes
// counts, load the children's counts), contract, reduce each site's
// maximum over the block's rows, then decide, scale and store (per rate
// now; per site once the tile's last rate is done, the cluster's maxima
// exchanged).
template <class Src>
__device__ __forceinline__ void run(const Src& src, long long t0, long long t1,
                                    int rates, int s, float threshold,
                                    float factor, bool per_rate) {
  extern __shared__ float4 smem4[];
  float* const pt = reinterpret_cast<float*>(smem4);
  float* const ch = pt + kPFloats;           // [2 buffers][2 children][64][kTile]
  float* const red = ch + 4 * kChildFloats;  // [row groups][kTile]
  // each cluster block's maxima [parity][rank][kTile], written here by
  // that block
  float* const smax = red + kRedFloats;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, sg = tid % kSiteGroups, rg = tid / kSiteGroups;
  const bool active = rg * kRows < s;  // a row group with a state row
  const int nrb = (rates - rank + C - 1) / C;  // the block's rates
  const bool exchange = !per_rate && C > 1;
  // P's padded entries (rows i >= s of the last row group) are zero: never
  // written after this
  for (int k = tid; k < kPFloats / 4; k += kThreads)
    smem4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  typename Src::Ref cur = src.ref(t0);
  long long t = t0;
  int k = 0, buf = 0, parity = 0;
  int q = rank;
  stage_p(pt, src.p(cur, 0, q), src.p(cur, 1, q), s);
  src.children(ch, cur, q);
  float macc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (;;) {
    wait_copies();
    __syncthreads();  // this step's copies landed; the other buffer is free
    const bool last = k + 1 == nrb;  // the tile's last rate in this block
    const long long tn = last ? t + 1 : t;
    const int kn = last ? 0 : k + 1;
    const bool more = tn < t1;
    typename Src::Ref nxt = cur;
    if (more) {
      if (last) nxt = src.next(cur, tn);
      src.children(ch + (buf ^ 1) * 2 * kChildFloats, nxt, rank + kn * C);
    }
    // the counts this step writes: their children's, loaded now, used after
    // the contraction
    const bool counts = rg == 0 && (per_rate || (last && rank == 0));
    int kin[kCols] = {0, 0, 0, 0};
    if (counts) src.child_counts(cur, per_rate ? q : 0, sg, kin);
    float x[kRows][kCols];
    if (active) {
      const float* c = ch + buf * 2 * kChildFloats;
      contract(pt, c, c + kChildFloats, s, rg, sg, x);
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) x[i][j] = 0.0f;
    }
    // each site's maximum over the block's rows of this rate
    float m[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (rg * kRows + i >= s) break;  // a padded row
#pragma unroll
      for (int j = 0; j < kCols; ++j) m[j] = x[i][j] > m[j] ? x[i][j] : m[j];
    }
    *reinterpret_cast<float4*>(red + rg * kTile + sg * kCols) =
        make_float4(m[0], m[1], m[2], m[3]);
    __syncthreads();  // also: every thread is done reading P and this buffer
#pragma unroll
    for (int g = 0; g < kSP / kRows; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(red + g * kTile + sg * kCols);
      m[0] = v.x > m[0] ? v.x : m[0];
      m[1] = v.y > m[1] ? v.y : m[1];
      m[2] = v.z > m[2] ? v.z : m[2];
      m[3] = v.w > m[3] ? v.w : m[3];
    }
    // a new rate or op: P after every thread has read this one (the
    // barrier above), landing with the next step's children
    if (more && (kn != k || !src.same_p(cur, nxt)))
      stage_p(pt, src.p(nxt, 0, rank + kn * C), src.p(nxt, 1, rank + kn * C), s);
    bool d[kCols] = {false, false, false, false};
    bool decide = per_rate;
    if (!per_rate) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) macc[j] = m[j] > macc[j] ? m[j] : macc[j];
      if (last) {
        if (exchange) {  // the site's maximum over the cluster's rates
          // each block writes its maxima into every block of the cluster
          // (remote stores do not wait), then reads them all locally
          float* mine = smax + parity * kMaxCluster * kTile;
          if (rg == 0)
            for (int b = 0; b < C; ++b)
              *reinterpret_cast<float4*>(cluster.map_shared_rank(mine, b) +
                                         rank * kTile + sg * kCols) =
                  make_float4(macc[0], macc[1], macc[2], macc[3]);
          cluster.sync();
          for (int b = 0; b < C; ++b) {
            const float4 v =
                *reinterpret_cast<const float4*>(mine + b * kTile + sg * kCols);
            macc[0] = v.x > macc[0] ? v.x : macc[0];
            macc[1] = v.y > macc[1] ? v.y : macc[1];
            macc[2] = v.z > macc[2] ? v.z : macc[2];
            macc[3] = v.w > macc[3] ? v.w : macc[3];
          }
          parity ^= 1;
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) m[j] = macc[j], macc[j] = 0.0f;
        decide = true;
      }
    }
    if (decide && src.has(cur)) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) d[j] = m[j] < threshold;
    }
    if (decide) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (d[j]) x[i][j] *= factor;
    }
    if (active) src.store(cur, q, rg, sg, s, x);
    if (decide && !per_rate && (d[0] || d[1] || d[2] || d[3]) && active)
      for (int e = 0; e < k; ++e)  // this tile's earlier rates, stored unscaled
        src.rescale(cur, rank + e * C, rg, sg, s, d);
    if (counts) src.count(cur, per_rate ? q : 0, sg, kin, d);
    if (!more) break;
    cur = nxt;
    t = tn;
    k = kn;
    q = rank + k * C;
    buf ^= 1;
  }
}

// Launches `kernel` over `runs` clusters of `cluster` blocks with the
// body's shared memory, on `st`.
template <class... K, class... A>
cudaError_t launch(void (*kernel)(K...), long long runs, int cluster,
                   cudaStream_t st, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(runs * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The clusters of `cluster` blocks of `kernel` that the current device
// keeps resident at once (cudaOccupancyMaxActiveClusters), asked once per
// device, kernel and cluster size; a negative CUDA error on failure.
template <class... K>
int resident(void (*kernel)(K...), int slot, int cluster) {
  constexpr int kDevices = 64;
  static int cached[kDevices][2][kMaxCluster + 1] = {};
  int dev = 0;
  if (cluster < 1 || cluster > kMaxCluster || slot < 0 || slot > 1 ||
      cudaGetDevice(&dev) != cudaSuccess)
    return -static_cast<int>(cudaErrorInvalidValue);
  const bool keep = dev >= 0 && dev < kDevices;
  if (keep && cached[dev][slot][cluster] > 0) return cached[dev][slot][cluster];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 1024);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (n < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  if (keep) cached[dev][slot][cluster] = n;
  return n;
}

}  // namespace states64
