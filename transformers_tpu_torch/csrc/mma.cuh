// Building blocks of the flash kernels (flash_fwd.cu: K1; flash_bwd.cu: K4,
// K5): the sm_80 warp-level tensor-core instructions (mma.sync m16n8k16 with
// f32 accumulate, ldmatrix), cp.async tile copies (paged_decode.cu uses the
// copies too), the accumulator store, and the attention mask as data.
#pragma once

#include <type_traits>

#include "common.cuh"

// Fragment layouts (PTX ISA): with g = lane / 4 and t = lane % 4, an A
// fragment (16 x 16) holds rows g, g + 8 and column pairs 2t, 2t + 8; a B
// fragment (16 x 8) k pairs 2t, 2t + 8 of column g; the f32 accumulator
// (16 x 8) rows g, g + 8, column pair 2t.

constexpr int kPad = 8;  // elements of padding per shared row

// bf16 and fp16 at head_dim <= 128 take the tensor-core kernels; float32
// (TF32 would not hold its tolerance) and head_dim 256 (registers) do not.
template <typename T, int D>
constexpr bool use_tensor_cores() {
  return !std::is_same<T, float>::value && D <= 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns [16 kk, 16 kk + 16) of a 16 x (8 NT) f32 accumulator tile as an A
// fragment of T, each value rounded once (the flash forward's P).
template <typename T, int NT>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NT][4], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[2 * i] = pack2<T>(acc[2 * kk + i][0], acc[2 * kk + i][1]);
    a[2 * i + 1] = pack2<T>(acc[2 * kk + i][2], acc[2 * kk + i][3]);
  }
}

// The same fragment carried to ~16 bits as two (the flash backward's P and
// dS): hi = x rounded to T, lo = (x - hi) rounded to T.
template <typename T, int NT>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NT][4], int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float v[8] = {acc[2 * kk][0],     acc[2 * kk][1],     acc[2 * kk][2],
                      acc[2 * kk][3],     acc[2 * kk + 1][0], acc[2 * kk + 1][1],
                      acc[2 * kk + 1][2], acc[2 * kk + 1][3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = pack2<T>(v[2 * i], v[2 * i + 1]);
    lo[i] = pack2<T>(v[2 * i] - round_to<T>(v[2 * i]), v[2 * i + 1] - round_to<T>(v[2 * i + 1]));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) of a tile with row stride D + kPad in shared memory, copied
// asynchronously from global rows src + r * row_stride; rows at or past
// n_rows are zero-filled.
template <typename T, int D, int R, int NTHREADS>
__device__ __forceinline__ void cp_rows(T* dst, const T* __restrict__ src, size_t row_stride,
                                        int n_rows) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
  for (int idx = threadIdx.x; idx < R * CPR; idx += NTHREADS) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * EPC;
    const bool ok = r < n_rows;
    cp_async16(dst + r * (D + kPad) + c, ok ? src + (size_t)r * row_stride + c : src, ok);
  }
}

// 4-byte values [0, n) of a tile row, asynchronously; [n, R) zero-filled.
template <int R, typename V>
__device__ __forceinline__ void cp_vals(V* dst, const V* __restrict__ src, int n) {
  if (threadIdx.x < R) {
    const bool ok = (int)threadIdx.x < n;
    cp_async4(dst + threadIdx.x, ok ? src + threadIdx.x : src, ok);
  }
}

// Stores rows g and g + 8 of a warp's 16 x D f32 accumulator tile, rounded
// to T, to rows row(0) and row(1) (nullptr: not stored).
template <typename T, int D, typename Row>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4], Row row) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* dst = row(i);
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      Vec<T, 2> o;
      o.x[0] = from_f<T>(acc[j][2 * i]);
      o.x[1] = from_f<T>(acc[j][2 * i + 1]);
      *reinterpret_cast<Vec<T, 2>*>(dst + j * 8 + 2 * tg) = o;
    }
  }
}

// ---------------------------------------------------------------- the mask
// Query row at position qp sees kv slot `slot` (kv_valid value `valid`).
__device__ __forceinline__ bool visible(int slot, int qp, int valid, int causal, int window) {
  bool vis = valid != 0;
  if (causal) vis = vis && slot <= qp;
  if (window > 0) vis = vis && slot > qp - window;
  return vis;
}

// Smallest and largest q_position over the first n rows, by thread 0 into out[0..1].
__device__ __forceinline__ void row_range(const int* qpos_s, int n, int* out) {
  if (threadIdx.x == 0) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = 0; r < n; ++r) {
      lo = min(lo, qpos_s[r]);
      hi = max(hi, qpos_s[r]);
    }
    out[0] = lo;
    out[1] = hi;
  }
}
