// Weight-only quantized linear layers: y[M, N] = round((sum_k x[m, k] * code[n, k]) * scale[n])
// with the codes stored int8, packed int4 or fp8 e4m3 and one f32 scale per output row.
//
// No TPU kernel is replaced here. The JAX package's quantized_dot
// (transformers_tpu/quantizers/weight_only.py) hands the codes straight to
// dot_general and XLA fuses the widening into the product's operand read, so
// the weight streams from memory at its stored width. PyTorch on CUDA has no
// int8 x bf16 product: widening the codes with .to() per call reads 1 byte a
// weight, writes 2 and reads 2 again. These kernels are the port's
// counterpart of that fusion.
//
// Q1, quantized_linear_tc_kernel: the rows of a decode step or a short
// prefill chunk (M <= 128), bf16 and f16 activations. Bound on the H100: the
// codes' bytes (N * K, or N * K / 2 for int4: 58.7 MB at 14336 x 4096 int8,
// 17.5 us at 3.35 TB/s). The products are M * N * K multiply-adds, which the
// CUDA cores' f32 FMAs cannot do in that time (quantized_linear_kernel below
// took ~0.10 ms at 16 rows of 14336 x 4096 with bf16 activations, against a
// 0.0177 ms bound), and the tensor cores do in a few microseconds. What the
// design does:
//
// - Products on the tensor cores, A and B swapped. mma.sync m16n8k16 with f32
//   accumulators (mma.cuh): 16 weight rows are the A operand, the activation
//   rows are B's n8 columns (ceil(M / 8) tiles, all of a call's rows in one
//   block, so every code is read from memory once). int8, int4 and fp8 e4m3
//   codes are exact in bf16 and f16 and their products with x are exact in
//   f32, so only the order of the f32 sums differs from quantized_dot.
// - Codes widened in registers straight into A fragments, two values an
//   instruction or so. The order of k inside a sum is free, so a lane
//   (g = lane / 4, t = lane % 4) loads 16 contiguous code bytes of rows g and
//   g + 8 (its 64-byte step of a row: lanes t = 0..3 cover it) and places
//   the four codes of each 32-bit group at its fragment columns {2t, 2t + 1,
//   2t + 8, 2t + 9}; it reads the matching x values (16 or 32 contiguous
//   ones) from shared memory with 16-byte loads. Widening: f16 takes the
//   code into the mantissa of 1024 (0x6400 | code ^ 0x80, then one packed
//   subtract; int4 nibbles by one byte permute, one masked xor and one packed
//   fma a pair); bf16 takes int8 through f32 (the code in the mantissa of
//   2^23, one subtract, the upper halves of two floats packed by a byte
//   permute: exact, as the values have at most 8 significant bits) and int4
//   through the mantissa of 128; fp8 through the hardware's e4m3x2 -> f16x2
//   conversion (then f32 and a pack for bf16).
// - Bytes in flight. A block of 8 warps owns 128 weight rows; its K range
//   goes in chunks of 256 values. Each chunk's code rows (256 bytes a row,
//   int4 128) and x rows [MT, 256] are copied into shared memory by cp.async,
//   16 bytes a thread with neighbouring threads on neighbouring addresses, in
//   a ring of 4 stages (3 at MT = 64, 2 at MT = 128): three chunks, 96 KB of
//   codes, are in flight while one is computed, one block an SM. Code rows
//   are padded to 64 mod 128 bytes and x's 16-byte pieces swizzled, so the
//   lanes' fragment reads are free of bank conflicts. Row block b starts at
//   chunk b mod its range's length, so the blocks' reads spread over the
//   rows instead of marching through them in step. (Prefetching one chunk
//   of codes into registers instead reached 47-53% of the bound at 14336 x
//   4096 and 8-16 rows; the ring's depth, the chunk and the block shape
//   move it by a few percent, readings below.)
// - Split K where N alone cannot fill the card (1024 x 4096 gives 8 row
//   blocks on 132 SMs). The wrapper picks the K values per split
//   (ops/quantized_linear.py split_size, from a sweep on the card); each
//   split block writes f32 partials to scratch the wrapper keeps, and the
//   last block of a row block to finish (found by __threadfence() and an
//   atomic ticket, as in fused_decode.cu) sums them in split order, scales,
//   rounds and resets its ticket. No float atomics: the output is the same
//   bit for bit from run to run and in a captured graph's replays. One launch
//   per product.
// The sums are f32, the f32 scale multiplies the sum, and the output is
// rounded once to the activation type, as quantized_dot does. The kernel
// allocates nothing and reads nothing on the host, so a CUDA graph captures
// it.
//
// What the card shows (chip_smoke.py, H100 80GB HBM3, 700 W, int8 x bf16):
// 0.0261 / 0.0284 ms at 1 / 16 rows of 14336 x 4096, 0.67 / 0.62 of the byte
// bound (bf16 F.linear 0.0411), time growing with the rows only past ~16. So
// bytes bound it, at ~2.1-2.3 TB/s: that shape fills 112 of 132 SMs, and at
// 4096 x 4096 and 1024 x 4096 (0.34 and 0.12 of the bound at 16 rows) the
// fixed chain of a launch, the first chunk's load and the partials' round
// trip through the last block is most of the time.
//
// quantized_linear_kernel: Q1's route for f32 activations (TF32 would change
// the numbers). Exact f32 FMAs on the CUDA cores: a block of 4 warps owns 16
// output rows, 4 a warp; lane l reads code word (i * 32 + l) of each row's
// 512-value tile, x tiles double-buffered in shared memory by cp.async, the
// sums reduced across the warp and scaled in the epilogue. M above 16 takes
// several m-tiles (grid.y), each reading the codes again.
//
// Q2, widen_codes_kernel: the rows of a prefill or a longer prefill chunk
// (M large): the codes widened exactly to the activation type into a [N, K]
// buffer the wrapper reuses; the product then goes to cuBLAS, as the JAX
// package leaves it to XLA. Bound: bytes (N * K code bytes read, N * K *
// sizeof(T) written).
//
// K must be a multiple of 8 (the wrapper checks it): every Llama shape is.
//
// int4 codes are packed along K: byte j of row n holds code (n, 2j) in its low
// nibble and (n, 2j + 1) in its high nibble, each a 4-bit two's complement value.

#include <cuda_fp8.h>

#include <algorithm>

#include "mma.cuh"

// code types, kept in step with ops/quantized_linear.py CODE_TYPES
#define TTPU_CODE_INT8 0
#define TTPU_CODE_INT4 1
#define TTPU_CODE_FP8 2

namespace {

// K a multiple of 8: rows of whole 32-bit code words (int4 too) and x rows of
// whole 16-byte pieces (bf16, f16; f32 needs only 4)
constexpr int kKMultiple = 8;

// values per 32-bit code word
template <int CODE> struct CodeInfo {
  static constexpr int kValuesPerWord = CODE == TTPU_CODE_INT4 ? 8 : 4;
};

// The values of one 32-bit code word (its bytes in memory order) as floats.
template <int CODE>
__device__ __forceinline__ void widen_word(uint32_t w, float (&out)[CodeInfo<CODE>::kValuesPerWord]) {
  // Integer codes become floats exactly without a conversion instruction: the
  // code plus an offset (128 for int8, 8 for int4: the sign bit flipped) goes
  // into the low mantissa bits of 2^23, and 2^23 plus the offset is subtracted.
  if constexpr (CODE == TTPU_CODE_INT8) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388736.f;
  } else if constexpr (CODE == TTPU_CODE_INT4) {
    // nibble i (from the least significant) is code 2 * byte + (i & 1), in order
    const uint32_t u = w ^ 0x88888888u;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = __int_as_float(((u >> (4 * i)) & 0xFu) | 0x4B000000u) - 8388616.f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w >> (16 * i)) & 0xffffu), __NV_E4M3);
      float2 f = __half22float2(*reinterpret_cast<__half2*>(&h));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// ------------------------------------------------ Q1 on the tensor cores
// The block shape and pipeline depth; quantized_linear_sweep.py builds
// variants of them with -D flags and times each on the card. The defaults
// are its choice (ops/quantized_linear.py keeps CHUNK and TC_ROWS in step):
// a Llama-3-8B layer's seven int8 x bf16 projections, each at its fastest
// split, took 0.1184 / 0.1273 / 0.1416 / 0.2495 ms at 1 / 8 / 16 / 64 rows
// with these; 0.1199 / 0.1301 / 0.1497 / 0.3145 with 4 warps, 3 stages and
// no stagger; 0.1168 / 0.1263 / 0.1447 / 0.3133 with 4 warps, 3 stages and
// the stagger; 0.1240 / 0.1382 / 0.1583 / 0.2789 with 4 warps and 2 stages;
// 0.1475 / 0.1547 / 0.1678 / 0.3262 with 512-value chunks, 4 warps, 3
// stages; 0.1245 / 0.1364 / 0.1586 / 0.3256 with 512-value chunks and 2
// stages (H100 80GB HBM3, 700 W).
#ifndef TTPU_Q1_WARPS
#define TTPU_Q1_WARPS 8  // warps per block, 16 weight rows each
#endif
#ifndef TTPU_Q1_CHUNK
#define TTPU_Q1_CHUNK 256  // K values per pipeline chunk
#endif
#ifndef TTPU_Q1_STAGES
#define TTPU_Q1_STAGES 4  // chunks in the shared-memory ring
#endif
#ifndef TTPU_Q1_STAGGER
#define TTPU_Q1_STAGGER 1  // 1: row block b starts its K range at chunk b mod its length
#endif
constexpr int kTcWarps = TTPU_Q1_WARPS;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // weight rows per block, 16 a warp (one A tile)
constexpr int kChunk = TTPU_Q1_CHUNK;
constexpr int kXStride = kChunk + 8;  // x row stride in shared memory: 16 mod 128 bytes
// activation rows: 16 n8 tiles (8 with chunks past 256, whose x rows would
// not fit twice)
constexpr int kMaxTcRows = kChunk <= 256 ? 128 : 64;
constexpr int kSmemBytes = 226 * 1024;  // of the 227 KB a block may have on the H100

// A 16-byte load of a lane covers kValues codes of a row: 64 k values
// (int4: 128) per 64-byte step of the row's 4 lanes, kMma mma k16 steps.
template <int CODE> struct TcCode {
  static constexpr int kValues = CODE == TTPU_CODE_INT4 ? 32 : 16;
  static constexpr int kSteps = kChunk / (4 * kValues);  // steps per chunk: 4, int4 2
  static constexpr int kMma = kValues / 4;
};

// Element offset e (a multiple of 8) of a chunk row in shared memory: the
// 16-byte pieces of each 256-byte half swap in pairs in the upper 8 pieces,
// so that the 8 lanes of a 16-byte load phase (rows g, g + 1; t = 0..3) hit
// 8 different bank groups for every code type.
__device__ __forceinline__ int swz(int e) {
  const int c = e >> 3;
  return ((c ^ (((c >> 3) & 1) << 1)) << 3) | (e & 7);
}

template <typename T>
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c);

template <>
__device__ __forceinline__ uint32_t fma2<__half>(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <>
__device__ __forceinline__ uint32_t fma2<__nv_bfloat16>(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The upper halves of two floats that are exact in bf16, as a bf16 pair.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Codes 4q .. 4q + 3 of word w (in k order) as two pairs of T, exactly:
// lo = (4q, 4q + 1), hi = (4q + 2, 4q + 3). int8 and fp8 words hold one such
// group (q = 0), int4 words two.
template <typename T, int CODE, int Q>
__device__ __forceinline__ void widen_group(uint32_t w, uint32_t& lo, uint32_t& hi) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (CODE == TTPU_CODE_INT8) {
    const uint32_t u = w ^ 0x80808080u;  // code + 128
    if constexpr (kHalf) {
      // 0x6400 | u is 1024 + u; minus 1152 is the code
      lo = fma2<T>(__byte_perm(u, 0x64646464u, 0x4140), 0x3C003C00u, 0xE480E480u);
      hi = fma2<T>(__byte_perm(u, 0x64646464u, 0x4342), 0x3C003C00u, 0xE480E480u);
    } else {
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388736.f;
      lo = bf16_pair(f[0], f[1]);
      hi = bf16_pair(f[2], f[3]);
    }
  } else if constexpr (CODE == TTPU_CODE_INT4) {
    // byte j holds codes (2j, 2j + 1) in its low and high nibble
    uint32_t v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t j = 2 * Q + i;
      if constexpr (kHalf) {
        // byte j in both halves; low half: 0x6400 | (lo ^ 8) = 1032 + lo, high
        // half: 0x6400 | (hi ^ 8) << 4 = 1024 + 16 (hi + 8); times (1, 1/16)
        // minus (1032, 72)
        const uint32_t r = __byte_perm(w, 0u, 0x4040u | (j << 8) | j);
        v[i] = fma2<T>((r & 0x00F0000Fu) ^ 0x64806408u, 0x2C003C00u, 0xD480E408u);
      } else {
        // low nibble of byte j in the low half, high nibble in the high half:
        // 0x4300 | (nibble ^ 8) is 136 + nibble; minus 136
        const uint32_t r = __byte_perm(w, w >> 4, 0x4040u | ((4 + j) << 8) | j);
        v[i] = fma2<T>((r & 0x000F000Fu) ^ 0x43084308u, 0x3F803F80u, 0xC308C308u);
      }
    }
    lo = v[0];
    hi = v[1];
  } else {
    uint32_t p[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w >> (16 * i)) & 0xffffu), __NV_E4M3);
      if constexpr (kHalf) {
        p[i] = static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
      } else {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
        p[i] = bf16_pair(f.x, f.y);
      }
    }
    lo = p[0];
    hi = p[1];
  }
}

struct TcArgs {
  const void* x;          // [M, K] of T
  const uint8_t* w;       // [N, row_bytes] codes
  const float* scale;     // [N]
  void* y;                // [M, N] of T
  float* partials;        // [splits, M, N]: the splits' f32 sums (splits > 1)
  int* tickets;           // [row blocks], 0 between calls
  int M, N, K, row_bytes;
  int split_chunks;       // chunks of kChunk K values per split
};

// Shared memory of one pipeline stage: the block's code rows (a row's chunk
// padded to 64 mod 128 bytes, so the lanes' 16-byte reads of rows g and g + 1
// fall in different bank groups), then x's chunk rows.
template <typename T, int CODE, int MT>
struct TcStage {
  static constexpr int kCodeBytes = TcCode<CODE>::kSteps * 64;  // of a row per chunk
  static constexpr int kCodeStride = kCodeBytes + 64;
  static constexpr int kX = kTcRows * kCodeStride;  // byte offset of x
  static constexpr int kBytes = kX + MT * kXStride * static_cast<int>(sizeof(T));
  // stages in the ring: TTPU_Q1_STAGES, fewer where they would not fit
  static constexpr int kStages = TTPU_Q1_STAGES * kBytes <= kSmemBytes ? TTPU_Q1_STAGES
                                                                      : kSmemBytes / kBytes;
  static_assert(kStages >= 2, "two stages of the ring must fit in shared memory");
};

template <typename T, int CODE, int MT>
__global__ void __launch_bounds__(kTcThreads) quantized_linear_tc_kernel(const TcArgs a) {
  using C = TcCode<CODE>;
  using S = TcStage<T, CODE, MT>;
  constexpr int NT = MT / 8;  // n8 tiles of activation rows
  constexpr int STAGES = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // [STAGES] stages
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nb = blockIdx.x * kTcRows;  // the block's first weight row
  const int chunks = (a.K + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.y * a.split_chunks;
  const int c_end = min(c_begin + a.split_chunks, chunks);
  const T* x = static_cast<const T*>(a.x);
  const bool vec = (a.row_bytes & 15) == 0;

  // chunk c's code rows and x rows [0, MT) into stage slot, zero past N, the
  // rows' ends, M and K; one commit group per call (empty past the range)
  auto stage = [&](int c, int slot) {
    if (c < c_end) {
      unsigned char* cs = smem_raw + slot * S::kBytes;
      constexpr int CPIECES = kTcRows * S::kCodeBytes / 16;
#pragma unroll
      for (int i = 0; i < CPIECES / kTcThreads; ++i) {
        const int p = i * kTcThreads + tid;
        const int r = p / (S::kCodeBytes / 16), off = (p % (S::kCodeBytes / 16)) * 16;
        const int n = nb + r, byte = c * S::kCodeBytes + off;
        unsigned char* dst = cs + r * S::kCodeStride + off;
        const uint8_t* src = a.w + static_cast<size_t>(n < a.N ? n : 0) * a.row_bytes + byte;
        if (vec) {
          const bool ok = n < a.N && byte < a.row_bytes;
          cp_async16(dst, ok ? src : a.w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = n < a.N && byte + 4 * j < a.row_bytes;
            cp_async4(dst + 4 * j, ok ? src + 4 * j : a.w, ok);
          }
        }
      }
      T* xs = reinterpret_cast<T*>(cs + S::kX);
      constexpr int XPIECES = MT * kChunk / 8;
#pragma unroll
      for (int i = 0; i < (XPIECES + kTcThreads - 1) / kTcThreads; ++i) {
        const int p = i * kTcThreads + tid;
        if (XPIECES % kTcThreads == 0 || p < XPIECES) {
          const int m = p / (kChunk / 8), e = (p % (kChunk / 8)) * 8;
          const int k = c * kChunk + e;
          const bool ok = m < a.M && k < a.K;
          cp_async16(xs + m * kXStride + swz(e), ok ? x + static_cast<size_t>(m) * a.K + k : x,
                     ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // one chunk's products from stage slot: the warp's rows warp * 16 + g and
  // + 8, 16 code bytes a step at 64 s + 16 t
  auto compute = [&](int slot) {
    const unsigned char* cs = smem_raw + slot * S::kBytes;
    const unsigned char* crow = cs + (warp * 16 + g) * S::kCodeStride + 16 * t;
    const T* xt = reinterpret_cast<const T*>(cs + S::kX);
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
      const uint4 c0 = *reinterpret_cast<const uint4*>(crow + 64 * s);
      const uint4 c1 = *reinterpret_cast<const uint4*>(crow + 8 * S::kCodeStride + 64 * s);
      // A fragments of the step's kMma k16 steps: mma step j covers the
      // lane's values 4j .. 4j + 3 at columns 2t, 2t + 1 (lo) and 2t + 8,
      // 2t + 9 (hi); a0/a2 row g, a1/a3 row g + 8
      uint32_t af[C::kMma][4];
      const uint32_t w0[4] = {c0.x, c0.y, c0.z, c0.w};
      const uint32_t w1[4] = {c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (CODE == TTPU_CODE_INT4) {
          widen_group<T, CODE, 0>(w0[i], af[2 * i][0], af[2 * i][2]);
          widen_group<T, CODE, 0>(w1[i], af[2 * i][1], af[2 * i][3]);
          widen_group<T, CODE, 1>(w0[i], af[2 * i + 1][0], af[2 * i + 1][2]);
          widen_group<T, CODE, 1>(w1[i], af[2 * i + 1][1], af[2 * i + 1][3]);
        } else {
          widen_group<T, CODE, 0>(w0[i], af[i][0], af[i][2]);
          widen_group<T, CODE, 0>(w1[i], af[i][1], af[i][3]);
        }
      }
      // the lane's x values of activation row 8 nt + g: kValues from
      // element s * 4 kValues + t kValues, 8 a 16-byte load (two mma steps)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* xr = xt + (nt * 8 + g) * kXStride;
#pragma unroll
        for (int q = 0; q < C::kValues / 8; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              xr + swz(s * 4 * C::kValues + t * C::kValues + 8 * q));
          mma16816<T>(acc[nt], af[2 * q], v.x, v.y);
          mma16816<T>(acc[nt], af[2 * q + 1], v.z, v.w);
        }
      }
    }
  };

  // the ring: the range's chunks i .. i + STAGES - 2 in flight while chunk i
  // is computed (with TTPU_Q1_STAGGER, taken from a rotated start)
  const int n_chunks = c_end - c_begin;
  const int rot = TTPU_Q1_STAGGER ? static_cast<int>(blockIdx.x) % n_chunks : 0;
  auto chunk_at = [&](int i) {
    return i < n_chunks ? c_begin + (i + rot) % n_chunks : c_end;  // c_end: nothing
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) stage(chunk_at(i), i);
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i has landed, and every warp is done with chunk i - 1
    stage(chunk_at(i + STAGES - 1), (i + STAGES - 1) % STAGES);
    compute(i % STAGES);
  }
  cp_async_wait<0>();

  // accumulator (nt, i): weight row n0 + g + 8 (i >> 1), activation row 8 nt + 2t + (i & 1)
  T* y = static_cast<T*>(a.y);
  const bool split = gridDim.y > 1;
  const int n0 = nb + warp * 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + g + 8 * (i >> 1), m = nt * 8 + 2 * t + (i & 1);
      if (n < a.N && m < a.M) {
        if (split)
          a.partials[(static_cast<size_t>(blockIdx.y) * a.M + m) * a.N + n] = acc[nt][i];
        else
          y[static_cast<size_t>(m) * a.N + n] = from_f<T>(acc[nt][i] * a.scale[n]);
      }
    }
  }
  if (!split) return;

  // the last split block of this row block sums the splits in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + blockIdx.x;
    const bool last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.y) - 1;
    if (last) atomicExch(ticket, 0);  // clean for the next call or graph replay
    last_block = last;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < a.M * kTcRows; i += kTcThreads) {
    const int m = i / kTcRows, n = nb + i % kTcRows;
    if (n >= a.N) continue;
    float s = 0.f;
    for (int sp = 0; sp < static_cast<int>(gridDim.y); ++sp)
      s += __ldcg(a.partials + (static_cast<size_t>(sp) * a.M + m) * a.N + n);
    y[static_cast<size_t>(m) * a.N + n] = from_f<T>(s * a.scale[n]);
  }
}

template <typename T, int CODE, int MT>
cudaError_t launch_tc_mt(const TcArgs& a, int splits, cudaStream_t st) {
  using S = TcStage<T, CODE, MT>;
  constexpr int smem = S::kStages * S::kBytes;
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(quantized_linear_tc_kernel<T, CODE, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((a.N + kTcRows - 1) / kTcRows, splits);
  quantized_linear_tc_kernel<T, CODE, MT><<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int CODE>
cudaError_t launch_tc_code(const TcArgs& a, int splits, cudaStream_t st) {
  if (a.M <= 8) return launch_tc_mt<T, CODE, 8>(a, splits, st);
  if (a.M <= 16) return launch_tc_mt<T, CODE, 16>(a, splits, st);
  if (a.M <= 32) return launch_tc_mt<T, CODE, 32>(a, splits, st);
  if (a.M <= 64) return launch_tc_mt<T, CODE, 64>(a, splits, st);
  if constexpr (kMaxTcRows >= 128) return launch_tc_mt<T, CODE, 128>(a, splits, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tc(const TcArgs& a, int code, int splits, cudaStream_t st) {
  switch (code) {
    case TTPU_CODE_INT8:
      return launch_tc_code<T, TTPU_CODE_INT8>(a, splits, st);
    case TTPU_CODE_INT4:
      return launch_tc_code<T, TTPU_CODE_INT4>(a, splits, st);
    case TTPU_CODE_FP8:
      return launch_tc_code<T, TTPU_CODE_FP8>(a, splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------- Q1 for f32 activations
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileValues = 512;  // K values per tile: 4 code words a lane (int4: 2)
constexpr int kMaxMTile = 16;

// The warp's sums of rows n0 .. n0 + 3 and m-tile rows m0 .. m0 + MT - 1,
// reduced across its lanes, scaled and rounded once; each value is written by
// one lane.
template <typename T, int MT>
__device__ __forceinline__ void store_rows(float (&acc)[kRowsPerWarp][MT], const float* scale, T* y,
                                           int M, int N, int n0, int m0, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float s = warp_sum(acc[r][m]);
      const int n = n0 + r, mm = m0 + m;
      if (lane == (r * MT + m) % 32 && n < N && mm < M)
        y[static_cast<size_t>(mm) * N + n] = from_f<T>(s * scale[n]);
    }
  }
}

template <typename T, int CODE, int MT>
__global__ void __launch_bounds__(kThreads)
    quantized_linear_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
                            const float* __restrict__ scale, T* __restrict__ y, int M, int N,
                            int K, int row_words) {
  constexpr int VPW = CodeInfo<CODE>::kValuesPerWord;
  constexpr int WPL = kTileValues / VPW / 32;  // code words per lane per row and tile
  constexpr int PIECE = 16 / sizeof(T);         // x values per 16-byte copy
  constexpr int PIECES = MT * kTileValues / PIECE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [2][MT][kTileValues]: x tiles, double-buffered

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int m0 = blockIdx.y * MT;
  const int tiles = (K + kTileValues - 1) / kTileValues;

  float acc[kRowsPerWarp][MT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  // tile t's x rows m0 .. m0 + MT - 1 into buffer t & 1, zero past M and K
  auto stage_x = [&](int t) {
    T* dst = xs + (t & 1) * MT * kTileValues;
#pragma unroll
    for (int i = 0; i < (PIECES + kThreads - 1) / kThreads; ++i) {
      const int p = i * kThreads + threadIdx.x;
      if (PIECES % kThreads == 0 || p < PIECES) {
        const int m = p / (kTileValues / PIECE), c = (p % (kTileValues / PIECE)) * PIECE;
        const int k = t * kTileValues + c;
        const bool ok = m0 + m < M && k < K;
        cp_async16(dst + m * kTileValues + c, ok ? x + static_cast<size_t>(m0 + m) * K + k : x,
                   ok);
      }
    }
    cp_async_commit();
  };
  // lane l reads words (i * 32 + l) of each row's tile: warp-wide loads of 128
  // contiguous bytes, and x values contiguous across lanes
  uint32_t cur[kRowsPerWarp][WPL], nxt[kRowsPerWarp][WPL];
  auto load_codes = [&](uint32_t(&dst)[kRowsPerWarp][WPL], int t) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int n = n0 + r;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const int word = t * (kTileValues / VPW) + i * 32 + lane;
        dst[r][i] = (n < N && word < row_words)
                        ? __ldg(w + static_cast<size_t>(n) * row_words + word)
                        : 0u;
      }
    }
  };
  stage_x(0);
  load_codes(cur, 0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_x(t + 1);
      load_codes(nxt, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t's x is in shared memory
    const T* xt = xs + (t & 1) * MT * kTileValues;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      float c[kRowsPerWarp][VPW];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) widen_word<CODE>(cur[r][i], c[r]);
      const T* xl = xt + (i * 32 + lane) * VPW;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xv[VPW];
        load_f<T, VPW>(xl + m * kTileValues, xv);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int j = 0; j < VPW; ++j) acc[r][m] = fmaf(c[r][j], xv[j], acc[r][m]);
      }
    }
    __syncthreads();  // buffer t & 1 is read: tile t + 2 may go there
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < WPL; ++i) cur[r][i] = nxt[r][i];
  }
  store_rows<T, MT>(acc, scale, y, M, N, n0, m0, lane);
}

// Q2: codes [N, K * bits / 8] -> out [N, K] of type T, exactly: one thread per
// 32-bit code word; word i of the flat codes is values [i * VPW, (i + 1) * VPW)
// of the flat output.
template <typename T, int CODE>
__global__ void __launch_bounds__(256)
    widen_codes_kernel(const uint32_t* __restrict__ w, T* __restrict__ out, size_t words) {
  constexpr int VPW = CodeInfo<CODE>::kValuesPerWord;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
       i += stride) {
    float v[VPW];
    widen_word<CODE>(__ldg(w + i), v);
    store_f<T, VPW>(out + i * VPW, v);
  }
}

int row_words_of(int K, int code) { return (code == TTPU_CODE_INT4 ? K / 2 : K) / 4; }

template <int CODE, int MT>
cudaError_t launch_mt(const float* x, const void* w, const float* scale, float* y, int M, int N,
                      int K, cudaStream_t st) {
  constexpr int smem = 2 * MT * kTileValues * static_cast<int>(sizeof(float));
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(quantized_linear_kernel<float, CODE, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (M + MT - 1) / MT);
  quantized_linear_kernel<float, CODE, MT><<<grid, kThreads, smem, st>>>(
      x, static_cast<const uint32_t*>(w), scale, y, M, N, K, row_words_of(K, CODE));
  return cudaGetLastError();
}

template <int CODE>
cudaError_t launch_code(const float* x, const void* w, const float* scale, float* y, int M, int N,
                        int K, cudaStream_t st) {
  if (M <= 1) return launch_mt<CODE, 1>(x, w, scale, y, M, N, K, st);
  if (M <= 2) return launch_mt<CODE, 2>(x, w, scale, y, M, N, K, st);
  if (M <= 4) return launch_mt<CODE, 4>(x, w, scale, y, M, N, K, st);
  if (M <= 8) return launch_mt<CODE, 8>(x, w, scale, y, M, N, K, st);
  return launch_mt<CODE, kMaxMTile>(x, w, scale, y, M, N, K, st);
}

cudaError_t launch_f32(const void* x, const void* w, const float* scale, void* y, int M, int N,
                       int K, int code, cudaStream_t st) {
  const float* xt = static_cast<const float*>(x);
  float* yt = static_cast<float*>(y);
  switch (code) {
    case TTPU_CODE_INT8:
      return launch_code<TTPU_CODE_INT8>(xt, w, scale, yt, M, N, K, st);
    case TTPU_CODE_INT4:
      return launch_code<TTPU_CODE_INT4>(xt, w, scale, yt, M, N, K, st);
    case TTPU_CODE_FP8:
      return launch_code<TTPU_CODE_FP8>(xt, w, scale, yt, M, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int CODE>
cudaError_t launch_widen_code(const void* w, void* out, int N, int K, cudaStream_t st) {
  const size_t words = static_cast<size_t>(N) * row_words_of(K, CODE);
  const int blocks = static_cast<int>(std::min<size_t>((words + 255) / 256, 132 * 16));
  widen_codes_kernel<T, CODE><<<blocks, 256, 0, st>>>(static_cast<const uint32_t*>(w),
                                                      static_cast<T*>(out), words);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_widen(const void* w, void* out, int N, int K, int code, cudaStream_t st) {
  switch (code) {
    case TTPU_CODE_INT8:
      return launch_widen_code<T, TTPU_CODE_INT8>(w, out, N, K, st);
    case TTPU_CODE_INT4:
      return launch_widen_code<T, TTPU_CODE_INT4>(w, out, N, K, st);
    case TTPU_CODE_FP8:
      return launch_widen_code<T, TTPU_CODE_FP8>(w, out, N, K, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Q1: y [M, N] of the activation type from x [M, K], codes [N, K] (int8, fp8)
// or [N, K / 2] (int4) and scale [N] f32. bf16/f16 (M <= 128) take the
// tensor-core kernel with K cut into splits of `split` values (a multiple of
// 256; one split: partials and tickets are not read), f32 the CUDA-core
// kernel. Returns the launch error (0 on success).
extern "C" int ttpu_quantized_linear(const void* x, const void* w, const void* scale, void* y,
                                     void* partials, void* tickets, int M, int N, int K,
                                     int split, int code, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kKMultiple) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == TTPU_F32) return static_cast<int>(launch_f32(x, w, s, y, M, N, K, code, st));
  if (M > kMaxTcRows || split <= 0 || split % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a{x, static_cast<const uint8_t*>(w), s, y, static_cast<float*>(partials),
           static_cast<int*>(tickets), M, N, K, code == TTPU_CODE_INT4 ? K / 2 : K,
           split / kChunk};
  const int splits = (K + split - 1) / split;
  if (splits > 1 && (partials == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case TTPU_BF16:
      err = launch_tc<__nv_bfloat16>(a, code, splits, st);
      break;
    case TTPU_F16:
      err = launch_tc<__half>(a, code, splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Q2: out [N, K] of type dtype, the codes widened exactly (no scale).
extern "C" int ttpu_widen_codes(const void* w, void* out, int N, int K, int code, int dtype,
                                void* stream) {
  if (N <= 0 || K <= 0 || K % kKMultiple) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_widen<float>(w, out, N, K, code, st);
      break;
    case TTPU_BF16:
      err = launch_widen<__nv_bfloat16>(w, out, N, K, code, st);
      break;
    case TTPU_F16:
      err = launch_widen<__half>(w, out, N, K, code, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
