// Shared helpers for the port's hand-written kernels: element conversion
// between the storage types (float, bf16, fp16) and float, and the dtype
// codes the Python wrappers pass through the plain C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// dtype codes, kept in step with ops/cuda_build.py DTYPE_CODES
#define TTPU_F32 0
#define TTPU_BF16 1
#define TTPU_F16 2

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// Round a float to the storage type and back: the value a tensor of type T
// would hold.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The alignment of N consecutive elements of `bytes` in all: the largest power
// of two that divides it, at most 16 (3 bf16 values at head_dim 96 align to 2).
constexpr size_t vec_align(size_t bytes) {
  return (bytes & (~bytes + 1)) < 16 ? (bytes & (~bytes + 1)) : 16;
}

// N consecutive elements moved as one aligned vector access (as element
// accesses where N * sizeof(T) is no power of two).
template <typename T, int N> struct alignas(vec_align(sizeof(T) * N)) Vec {
  T x[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&out)[N]) {
  Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(v.x[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&in)[N]) {
  Vec<T, N> v;
#pragma unroll
  for (int i = 0; i < N; ++i) v.x[i] = from_f<T>(in[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
