// Weight-only quantized linear layers: y[M, N] = round((sum_k x[m, k] * code[n, k]) * scale[n])
// with the codes stored int8, packed int4 or fp8 e4m3 and one f32 scale per output row.
//
// No TPU kernel is replaced here. The JAX package's quantized_dot
// (transformers_tpu/quantizers/weight_only.py) hands the codes straight to
// dot_general and XLA fuses the widening into the product's operand read, so
// the weight streams from memory at its stored width. PyTorch on CUDA has no
// int8 x bf16 product: widening the codes with .to() per call reads 1 byte a
// weight, writes 2 and reads 2 again. These two kernels are the port's
// counterpart of that fusion:
//
// - quantized_linear_kernel (Q1), the rows of a decode step (M small). Bound
//   on the H100: bytes at M <= ~8 (the codes, N * K bytes or N * K / 2 for
//   int4, dominate), the CUDA cores' f32 FMAs above (M * N * K of them,
//   at ~33.5 TFMA/s; the tensor cores are a later redesign). A block of 4
//   warps owns 16 output rows, 4 a warp. The K axis goes in tiles of 512
//   values: lane l reads code word (i * 32 + l) of each row's tile (i < 4,
//   int4 i < 2), so each warp-wide load is 128 contiguous bytes of one row
//   and the values a lane needs from x are contiguous across lanes (no
//   shared-memory bank conflicts). The tile's x values (MT rows) are copied
//   into shared memory by cp.async, double-buffered, once per block and
//   shared by its 16 output rows; the next tile's x and codes are in flight
//   while this one is computed. Each code is widened once in registers
//   (integers by a mantissa trick, no conversion instruction) and used for
//   all MT activation rows; the sums are f32 in
//   registers, reduced across the warp at the end and scaled in the epilogue,
//   then rounded once to the activation type. M above 16 takes several
//   m-tiles (grid.y), each reading the codes again. The kernel reads each code
//   byte once per m-tile, allocates nothing and reads nothing on the host, so
//   it can be captured in a CUDA graph.
// - widen_codes_kernel (Q2), the rows of a prefill or a continuous-batching
//   prefill chunk (M large): the codes widened exactly to the activation
//   type (int8, int4 and fp8 e4m3 are all exact in bf16, f16 and f32) into
//   a [N, K] buffer the wrapper reuses; the product then goes to cuBLAS, as
//   the JAX package leaves it to XLA. Bound: bytes (N * K code bytes read,
//   N * K * sizeof(T) written).
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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileValues = 512;  // K values per tile: 4 code words a lane (int4: 2)
constexpr int kMaxMTile = 16;
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

template <typename T, int CODE, int MT>
cudaError_t launch_mt(const T* x, const void* w, const float* scale, T* y, int M, int N, int K,
                      cudaStream_t st) {
  constexpr int smem = 2 * MT * kTileValues * static_cast<int>(sizeof(T));
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(quantized_linear_kernel<T, CODE, MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (M + MT - 1) / MT);
  quantized_linear_kernel<T, CODE, MT><<<grid, kThreads, smem, st>>>(
      x, static_cast<const uint32_t*>(w), scale, y, M, N, K, row_words_of(K, CODE));
  return cudaGetLastError();
}

template <typename T, int CODE>
cudaError_t launch_code(const T* x, const void* w, const float* scale, T* y, int M, int N, int K,
                        cudaStream_t st) {
  if (M <= 1) return launch_mt<T, CODE, 1>(x, w, scale, y, M, N, K, st);
  if (M <= 2) return launch_mt<T, CODE, 2>(x, w, scale, y, M, N, K, st);
  if (M <= 4) return launch_mt<T, CODE, 4>(x, w, scale, y, M, N, K, st);
  if (M <= 8) return launch_mt<T, CODE, 8>(x, w, scale, y, M, N, K, st);
  return launch_mt<T, CODE, kMaxMTile>(x, w, scale, y, M, N, K, st);
}

template <typename T>
cudaError_t launch_linear(const void* x, const void* w, const float* scale, void* y, int M, int N,
                          int K, int code, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (code) {
    case TTPU_CODE_INT8:
      return launch_code<T, TTPU_CODE_INT8>(xt, w, scale, yt, M, N, K, st);
    case TTPU_CODE_INT4:
      return launch_code<T, TTPU_CODE_INT4>(xt, w, scale, yt, M, N, K, st);
    case TTPU_CODE_FP8:
      return launch_code<T, TTPU_CODE_FP8>(xt, w, scale, yt, M, N, K, st);
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
// or [N, K / 2] (int4) and scale [N] f32. Returns the launch error (0 on success).
extern "C" int ttpu_quantized_linear(const void* x, const void* w, const void* scale, void* y,
                                     int M, int N, int K, int code, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kKMultiple) return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_linear<float>(x, w, s, y, M, N, K, code, st);
      break;
    case TTPU_BF16:
      err = launch_linear<__nv_bfloat16>(x, w, s, y, M, N, K, code, st);
      break;
    case TTPU_F16:
      err = launch_linear<__half>(x, w, s, y, M, N, K, code, st);
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
