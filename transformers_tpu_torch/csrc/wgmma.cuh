// Hopper (sm_90a) building blocks of the flash kernels' head_dim-256 routes
// (flash_fwd.cu: K1; flash_bwd.cu: K4, K5): warpgroup matrix products
// (wgmma) whose operands are read from shared memory by descriptor, TMA tile
// loads from a tensor map into shared memory (and the maps, encoded on the
// host), mbarriers that count arrivals and the bytes a TMA load delivers,
// named barriers and the proxy fence for operands that threads write, and
// register reallocation between warpgroups (setmaxnreg).
//
// Shared tiles use the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B), which
// TMA writes and wgmma reads: a tile of 16-bit values is stored as boxes of
// R rows x 64 elements (R x 128 bytes, 1024-byte aligned; R is 64 or 32
// here), the 16-byte chunks of row r at chunk ^ (r % 8). In the descriptors'
// terms (PTX ISA, "matrix descriptor"; lengths in bytes):
// - K-major operand (the reduction dimension contiguous: Q and K in S = Q K^T):
//   8-row groups 1024 apart (SBO); the 16 elements of a k-step are 32 bytes
//   further into the row, so the start address moves by 32 bytes a step
//   inside a box and by a box every 4 steps; LBO is unused. An operand of
//   fewer rows than the box starts 1024-aligned inside it.
// - MN-major operand (V in O += P V: its rows are the reduction dimension,
//   its columns contiguous), read transposed: 64-column boxes R x 128 apart
//   (LBO), 8-row groups 1024 apart (SBO); a k-step of 16 rows moves the start
//   address by 2 KB.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <dlfcn.h>

#include "mma.cuh"

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, of parity 1, as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// --------------------------------------------------------------------- TMA
// One box of a 4-d tensor map, at coordinates (c0 innermost .. c3), into
// shared memory at dst; completion is counted in bytes on `bar`. Boxes
// reaching past the tensor's bounds are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- registers
// The warpgroup's register budget a thread, lowered or raised (a multiple of
// 8 in [24, 256]); every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------ between warpgroups
// Named barrier ID (1-15; 0 is __syncthreads) of N threads, whole warps.
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

// Makes this thread's shared-memory stores visible to the async proxy (the
// wgmma that read them as operands, after a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- a block's query positions
// For a block of NC consumer warpgroups of BM query rows each (consumer c:
// rows row0 + c BM .. row0 + c BM + BM - 1 of its batch row, positions in
// qpos_s, NC * BM of them): the smallest and largest position of the
// block's rows below Sq into range_s[0..1] (warp 0), and of consumer c's
// into range_s[2 + 2 c .. 3 + 2 c] (warp 1 + c). Run by every thread of the
// block; the caller synchronises before reading range_s.
template <int NC, int BM>
__device__ __forceinline__ void wg_row_ranges(const int* qpos_s, int row0, int Sq, int* range_s) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid >= 32 * (NC + 1)) return;
  const int w = tid >> 5;
  int lo = 0x7fffffff, hi = -0x7fffffff;
  for (int i = lane; i < NC * BM; i += 32) {
    const int c = i / BM;
    if ((w == 0 || c == w - 1) && row0 + i < Sq) {
      lo = min(lo, qpos_s[i]);
      hi = max(hi, qpos_s[i]);
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    range_s[2 * w] = lo;
    range_s[2 * w + 1] = hi;
  }
}

// -------------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled shared operand starting at p.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Orders the warpgroup's register and shared-memory writes before the
// wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An accumulator tile the compiler must treat as written here: placed after
// wgmma_wait, it keeps reads of the tile from moving above the wait; before
// wgmma_fence, it keeps writes to it from moving below the products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Accumulator fragments (f32): as mma.sync's m16n8 tiles side by side, warp
// w of the warpgroup holding rows 16 w .. 16 w + 15: d[j][e] is row
// 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
// The operand lists of the products (m64n16 .. m64n256).
#define TTPU_WG_ACC8(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3])
#define TTPU_WG_ACC16(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
#define TTPU_WG_ACC32(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
  "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
  "+f"(d[7][2]), "+f"(d[7][3])
#define TTPU_WG_ACC64(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
  "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
  "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), \
  "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), \
  "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), \
  "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), \
  "+f"(d[15][2]), "+f"(d[15][3])
#define TTPU_WG_ACC128(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
  "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
  "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
  "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), \
  "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), \
  "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), \
  "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), \
  "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), \
  "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), \
  "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), \
  "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]), \
  "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]), "+f"(d[25][0]), "+f"(d[25][1]), \
  "+f"(d[25][2]), "+f"(d[25][3]), "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]), \
  "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]), "+f"(d[28][0]), "+f"(d[28][1]), \
  "+f"(d[28][2]), "+f"(d[28][3]), "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]), \
  "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]), "+f"(d[31][0]), "+f"(d[31][1]), \
  "+f"(d[31][2]), "+f"(d[31][3])
#define TTPU_WG_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TTPU_WG_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TTPU_WG_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TTPU_WG_REGS64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define TTPU_WG_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// One wgmma.mma_async with A and B read from shared memory by descriptor
// (desc_a, desc_b; A K-major): SHAPE "m64n<N>k16", TY "bf16" or "f16", REGS
// the accumulators' operand numbers, A / B / P the operand numbers of the two
// descriptors and the accumulate flag, TB "1" where B is MN-major (read
// transposed), ACC the accumulators' operand list.
#define TTPU_WG_SS(SHAPE, TY, REGS, A, B, P, TB, ACC)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                                 \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {" REGS "}, %" A      \
               ", %" B ", p, 1, 1, 0, " TB ";\n}\n"                                            \
               : ACC                                                                          \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))

// d[NT][4] (+)= A B for a 64 x 8 NT tile over 16 of the reduction (NT 2, 4 or
// 8: m64n16, m64n32, m64n64): A (64 x 16) and B (16 x 8 NT) K-major in shared
// memory.
template <typename T, int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(NT == 2 || NT == 4 || NT == 8, "m64n16, m64n32 or m64n64");
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (NT == 2) {
    if constexpr (bf)
      TTPU_WG_SS("m64n16k16", "bf16", TTPU_WG_REGS8, "8", "9", "10", "0", TTPU_WG_ACC8(d));
    else
      TTPU_WG_SS("m64n16k16", "f16", TTPU_WG_REGS8, "8", "9", "10", "0", TTPU_WG_ACC8(d));
  } else if constexpr (NT == 4) {
    if constexpr (bf)
      TTPU_WG_SS("m64n32k16", "bf16", TTPU_WG_REGS16, "16", "17", "18", "0", TTPU_WG_ACC16(d));
    else
      TTPU_WG_SS("m64n32k16", "f16", TTPU_WG_REGS16, "16", "17", "18", "0", TTPU_WG_ACC16(d));
  } else {
    if constexpr (bf)
      TTPU_WG_SS("m64n64k16", "bf16", TTPU_WG_REGS32, "32", "33", "34", "0", TTPU_WG_ACC32(d));
    else
      TTPU_WG_SS("m64n64k16", "f16", TTPU_WG_REGS32, "32", "33", "34", "0", TTPU_WG_ACC32(d));
  }
}

// d[16][4] (+)= A B for a 64 x 128 tile over 16 of the reduction: A (64 x 16)
// K-major and B (16 x 128) MN-major in shared memory, B read transposed.
template <typename T>
__device__ __forceinline__ void wgmma_ss_bt(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    TTPU_WG_SS("m64n128k16", "bf16", TTPU_WG_REGS64, "64", "65", "66", "1", TTPU_WG_ACC64(d));
  else
    TTPU_WG_SS("m64n128k16", "f16", TTPU_WG_REGS64, "64", "65", "66", "1", TTPU_WG_ACC64(d));
}

// d[32][4] (+)= A B for a 64 x 256 tile over 16 of the reduction: A (64 x 16)
// from registers (mma.sync's A fragment, per warp its 16 rows), B (16 x 256)
// MN-major in shared memory, read transposed.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" TTPU_WG_REGS128 "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : TTPU_WG_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" TTPU_WG_REGS128 "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : TTPU_WG_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
}

// ---------------------------------------------------------- tensor maps (host)
// cuTensorMapEncodeTiled, a driver function, from the driver library the
// CUDA runtime has loaded (these libraries link the runtime only).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A BSHD tensor [B, S, NH, D] of T (bf16 or fp16) as a 4-d map (D, NH, S, B)
// read in 128-byte-swizzled boxes of 64 elements x 1 head x `rows` rows.
// False when the map cannot be encoded (the caller returns an error).
template <typename T>
bool bshd_map(CUtensorMap* map, const void* p, int B, int S, int NH, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr cuuint64_t E = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * E, NH * D * E, (cuuint64_t)S * NH * D * E};  // bytes
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
