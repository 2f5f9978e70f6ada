// wgmma.mma_async on bf16 operands with float32 accumulators, one
// specialization a width N = 8, 16, ..., 128, each generated by WG_MMA: the
// instruction names N and lists its N / 2 accumulator registers a thread;
// and the helpers around it (the 128-byte swizzled layout of a K-major
// operand in shared memory and its descriptor, the fences and the group
// waits). Used by mxu_probe.cu and fused_traversal_rows.cu.
//
// Mma<N>::rs(d, a, b) and Mma<N>::ss(d, a, b) issue
//   D[64, N] += A[64, 16] . B[16, N]
// for the executing warpgroup, asynchronously. In `rs` A is this thread's
// fragment (4 registers of two bf16 each, mma.sync's m16n8k16 A layout,
// warp w of the warpgroup holding rows 16 w .. 16 w + 15), in `ss` a
// shared-memory descriptor; B is a shared-memory descriptor; both
// matrices K-major (k contiguous) bf16. d is this thread's
// N / 2 accumulators (row 16 w + lane / 4 + 8 h, columns 8 j + 2 (lane %
// 4) + e in d[4 j + 2 h + e]). The caller brackets a run of them with
// wgmma.fence, wgmma.commit_group and wgmma.wait_group (sm_90a only).
#pragma once

#include <stdint.h>

template <int N>
struct Mma;

// The asm operands of R accumulators: their numbers in the instruction's
// register list (WG_ACC_R) and their constraints (WG_D_R), four at a time.
#define WG_ACC_4 "%0, %1, %2, %3"
#define WG_ACC_8 WG_ACC_4 ", %4, %5, %6, %7"
#define WG_ACC_12 WG_ACC_8 ", %8, %9, %10, %11"
#define WG_ACC_16 WG_ACC_12 ", %12, %13, %14, %15"
#define WG_ACC_20 WG_ACC_16 ", %16, %17, %18, %19"
#define WG_ACC_24 WG_ACC_20 ", %20, %21, %22, %23"
#define WG_ACC_28 WG_ACC_24 ", %24, %25, %26, %27"
#define WG_ACC_32 WG_ACC_28 ", %28, %29, %30, %31"
#define WG_ACC_36 WG_ACC_32 ", %32, %33, %34, %35"
#define WG_ACC_40 WG_ACC_36 ", %36, %37, %38, %39"
#define WG_ACC_44 WG_ACC_40 ", %40, %41, %42, %43"
#define WG_ACC_48 WG_ACC_44 ", %44, %45, %46, %47"
#define WG_ACC_52 WG_ACC_48 ", %48, %49, %50, %51"
#define WG_ACC_56 WG_ACC_52 ", %52, %53, %54, %55"
#define WG_ACC_60 WG_ACC_56 ", %56, %57, %58, %59"
#define WG_ACC_64 WG_ACC_60 ", %60, %61, %62, %63"
#define WG_D_4 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define WG_D_8 WG_D_4, "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define WG_D_12 WG_D_8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
#define WG_D_16 WG_D_12, "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D_20 WG_D_16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
#define WG_D_24 WG_D_20, "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define WG_D_28 WG_D_24, "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define WG_D_32 WG_D_28, "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_D_36 WG_D_32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
#define WG_D_40 WG_D_36, "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define WG_D_44 WG_D_40, "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
#define WG_D_48 WG_D_44, "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define WG_D_52 WG_D_48, "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
#define WG_D_56 WG_D_52, "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
#define WG_D_60 WG_D_56, "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
#define WG_D_64 WG_D_60, "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// Mma<N> with R = N / 2 accumulators; o0 .. o5 are R .. R + 5, the numbers
// of the operands after them: in `rs` A's four registers, B and the scale
// predicate's source, in `ss` A, B and the predicate's (o0 .. o2).
#define WG_MMA(N, R, o0, o1, o2, o3, o4, o5)                                        \
  template <>                                                                       \
  struct Mma<N> {                                                                   \
    __device__ static __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4], \
                                              uint64_t b) {                         \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #o5 ", 0;\n"                \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
                   WG_ACC_##R "}, {%" #o0 ", %" #o1 ", %" #o2 ", %" #o3 "}, %" #o4  \
                   ", p, 1, 1, 0;\n}\n"                                             \
                   : WG_D_##R                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));   \
    }                                                                               \
    __device__ static __forceinline__ void ss(float (&d)[R], uint64_t a, uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #o2 ", 0;\n"                \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
                   WG_ACC_##R "}, %" #o0 ", %" #o1 ", p, 1, 1, 0, 0;\n}\n"          \
                   : WG_D_##R                                                       \
                   : "l"(a), "l"(b), "r"(1));                                       \
    }                                                                               \
  };

WG_MMA(8, 4, 4, 5, 6, 7, 8, 9)
WG_MMA(16, 8, 8, 9, 10, 11, 12, 13)
WG_MMA(24, 12, 12, 13, 14, 15, 16, 17)
WG_MMA(32, 16, 16, 17, 18, 19, 20, 21)
WG_MMA(40, 20, 20, 21, 22, 23, 24, 25)
WG_MMA(48, 24, 24, 25, 26, 27, 28, 29)
WG_MMA(56, 28, 28, 29, 30, 31, 32, 33)
WG_MMA(64, 32, 32, 33, 34, 35, 36, 37)
WG_MMA(72, 36, 36, 37, 38, 39, 40, 41)
WG_MMA(80, 40, 40, 41, 42, 43, 44, 45)
WG_MMA(88, 44, 44, 45, 46, 47, 48, 49)
WG_MMA(96, 48, 48, 49, 50, 51, 52, 53)
WG_MMA(104, 52, 52, 53, 54, 55, 56, 57)
WG_MMA(112, 56, 56, 57, 58, 59, 60, 61)
WG_MMA(120, 60, 60, 61, 62, 63, 64, 65)
WG_MMA(128, 64, 64, 65, 66, 67, 68, 69)

// A shared memory address as the instructions take it
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Byte of (row r, k value kk) in a K-major bf16 matrix of `rows` rows in
// 128-byte swizzled rows, the layout wgmma's descriptors name (sw128_desc):
// a 64-k atom after another, row r at byte 128 r of its atom, its 16-byte
// chunk q (k values 8 q ..) at chunk index q ^ (r % 8).
// ops/_kernels.py:probe_layout lays a slice out the same way.
__device__ __forceinline__ int sw128_byte(int r, int kk, int rows) {
  return (kk / 64) * rows * 128 + r * 128 + (((kk % 64) / 8) ^ (r % 8)) * 16 + (kk % 8) * 2;
}

// A shared-memory operand's descriptor (sw128_byte's layout): start
// address, leading byte offset 16 (unused in K-major swizzled layouts),
// stride byte offset 1024 (8 rows of 128 bytes), 128-byte swizzle; the
// layout's atoms start 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most K of this warpgroup's committed groups are pending
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// keeps the compiler from moving the accumulators' reads and writes across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
