// Flash attention forward (prefill): causal online-softmax attention with the
// mask given as data. Query row i of batch b sees kv slot j iff
// kv_valid[b, j] != 0, and (when causal) j <= q_positions[b, i], and (with a
// window) j > q_positions[b, i] - window. An optional tanh softcap bounds the
// scores first. GQA reads kv head h / (H / KVH) without replicating K/V. Also
// writes the per-row logsumexp [B, H, Sq] in f32 for the backward pass.
//
// Replaces transformers_tpu/ops/pallas/flash_attention.py (_flash_fwd /
// _flash_kernel). A row that sees no slot gives 0 and lse -inf here (in the
// Pallas kernel such a row averages the V of the blocks it computed); only
// left-pad query rows see no slot, and no valid row reads them.
//
// Bound on the H100: at the prefill shapes of the main path (8 prompts of
// 128 tokens, 32 heads, D = 128) the inputs and outputs are ~21 MB against
// ~1 GFLOP of the causal half, so the bound is bytes; at longer prompts the
// operations grow with Sq * Skv and take over. This first version does its
// products with float FMAs on CUDA cores, not tensor cores, so in practice
// it is bound by its own FMA and shared-memory rate; tensor cores (mma/wgmma)
// are later work. What the design does: one block of 256 threads per
// (batch, head, 64-row query tile) keeps Q, a 64-slot K tile and V tile in
// shared memory in the storage type (rows padded by two elements so the
// column-parallel reads of K hit distinct banks), each thread computes a
// 4 x 4 block of scores and a 4-row slice of the output from register
// tiles, and the f32 running max / sum live in shared memory per row. KV tiles
// that causality or the window mask for every row of the query tile are
// never loaded.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // kv slots per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid
constexpr int PS = BKV + 1;  // row stride of the score tile

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (D + 2) + BKV * D) * sizeof(T) +  // Q, K, V tiles
         (size_t)(BQ * PS + 3 * BQ) * sizeof(float) +        // P, m, l, alpha
         (size_t)(BQ + BKV + 2) * sizeof(int);               // qpos, valid, range
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q,     // [B, Sq, H, D]
                 const T* __restrict__ k,     // [B, Skv, KVH, D]
                 const T* __restrict__ v,     // [B, Skv, KVH, D]
                 const int* __restrict__ q_positions,  // [B, Sq]
                 const int* __restrict__ kv_valid,     // [B, Skv]
                 T* __restrict__ out,         // [B, Sq, H, D]
                 float* __restrict__ lse,     // [B, H, Sq]
                 int Sq, int Skv, int H, int KVH, float scale, int causal, int window,
                 float logit_cap) {
  constexpr int QS = D + 2;  // row stride of the Q and K tiles
  constexpr int DP = D / 32; // output column pairs per thread
  using V2 = Vec<T, 2>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * QS;
  T* Vs = Ks + BKV * QS;
  float* Ps = reinterpret_cast<float*>(Vs + BKV * D);
  float* m_s = Ps + BQ * PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(a_s + BQ);
  int* valid_s = qpos_s + BQ;
  int* range_s = valid_s + BKV;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float NEG_INF = -CUDART_INF_F;

  // ---- Q tile, positions, row state
  for (int idx = tid; idx < BQ * (D / 2); idx += NT) {
    const int r = idx / (D / 2);
    const int c = 2 * (idx % (D / 2));
    V2 val;
    if (q0 + r < Sq) {
      val = *reinterpret_cast<const V2*>(q + (((size_t)b * Sq + q0 + r) * H + h) * D + c);
    } else {
      val.x[0] = val.x[1] = from_f<T>(0.f);
    }
    *reinterpret_cast<V2*>(Qs + r * QS + c) = val;
  }
  if (tid < BQ) {
    qpos_s[tid] = q0 + tid < Sq ? q_positions[(size_t)b * Sq + q0 + tid] : -1;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = 0; r < BQ && q0 + r < Sq; ++r) {
      lo = min(lo, qpos_s[r]);
      hi = max(hi, qpos_s[r]);
    }
    // kv tiles outside [begin, end) are masked for every row of this tile
    int begin = 0;
    if (window > 0) begin = max(0, (lo - window + 1) / BKV) * BKV;
    range_s[0] = begin;
    range_s[1] = causal ? min(Skv, hi + 1) : Skv;
  }
  __syncthreads();
  const int kv_begin = range_s[0];
  const int kv_end = range_s[1];

  float2 acc[4][DP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) acc[i][jj] = make_float2(0.f, 0.f);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * (D / 2); idx += NT) {
      const int r = idx / (D / 2);
      const int c = 2 * (idx % (D / 2));
      V2 kv_k, kv_v;
      if (kv0 + r < Skv) {
        const size_t off = (((size_t)b * Skv + kv0 + r) * KVH + kvh) * D + c;
        kv_k = *reinterpret_cast<const V2*>(k + off);
        kv_v = *reinterpret_cast<const V2*>(v + off);
      } else {
        kv_k.x[0] = kv_k.x[1] = kv_v.x[0] = kv_v.x[1] = from_f<T>(0.f);
      }
      *reinterpret_cast<V2*>(Ks + r * QS + c) = kv_k;
      *reinterpret_cast<V2*>(Vs + r * D + c) = kv_v;
    }
    if (tid < BKV) valid_s[tid] = kv0 + tid < Skv ? kv_valid[(size_t)b * Skv + kv0 + tid] : 0;
    __syncthreads();

    // ---- scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float qa[4], qb[4], ka[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const V2 x = *reinterpret_cast<const V2*>(Qs + (ty + 16 * i) * QS + d);
        qa[i] = to_f(x.x[0]);
        qb[i] = to_f(x.x[1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const V2 x = *reinterpret_cast<const V2*>(Ks + (tx + 16 * j) * QS + d);
        ka[j] = to_f(x.x[0]);
        kb[j] = to_f(x.x[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qb[i], kb[j], fmaf(qa[i], ka[j], s[i][j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = qpos_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int slot = kv0 + c;
        float x = s[i][j] * scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        bool vis = valid_s[c] != 0;
        if (causal) vis = vis && slot <= qp;
        if (window > 0) vis = vis && slot > qp - window;
        Ps[r * PS + c] = vis ? x : NEG_INF;
      }
    }
    __syncthreads();

    // ---- online softmax: four threads per row, columns part + 4 k
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < BKV / 4; ++kk) mx = fmaxf(mx, Ps[r * PS + part + 4 * kk]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new == NEG_INF) {  // nothing visible to this row yet
#pragma unroll
        for (int kk = 0; kk < BKV / 4; ++kk) Ps[r * PS + part + 4 * kk] = 0.f;
      } else {
        alpha = expf(m_old - m_new);
#pragma unroll
        for (int kk = 0; kk < BKV / 4; ++kk) {
          const float p = expf(Ps[r * PS + part + 4 * kk] - m_new);
          Ps[r * PS + part + 4 * kk] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V: rows ty + 16 i, column pairs tx + 16 jj
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < DP; ++jj) {
        acc[i][jj].x *= a;
        acc[i][jj].y *= a;
      }
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int jj = 0; jj < DP; ++jj) {
        const V2 x = *reinterpret_cast<const V2*>(Vs + j * D + 2 * (tx + 16 * jj));
        const float va = to_f(x.x[0]);
        const float vb = to_f(x.x[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj].x = fmaf(p[i], va, acc[i][jj].x);
          acc[i][jj].y = fmaf(p[i], vb, acc[i][jj].y);
        }
      }
    }
  }
  __syncthreads();

  // ---- normalise and write
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      V2 o;
      o.x[0] = from_f<T>(acc[i][jj].x * inv);
      o.x[1] = from_f<T>(acc[i][jj].y * inv);
      *reinterpret_cast<V2*>(orow + 2 * (tx + 16 * jj)) = o;
    }
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qi] = l > 0.f ? m_s[r] + logf(l) : NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_positions,
                   const int* kv_valid, void* out, float* lse, int B, int Sq, int Skv, int H,
                   int KVH, float scale, int causal, int window, float logit_cap,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, D>();
  static bool smem_set = false;  // once per instantiation (also keeps it out of graph capture)
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      q_positions, kv_valid, static_cast<T*>(out), lse, Sq, Skv, H, KVH, scale, causal,
      window, logit_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* qp,
                     const int* kv, void* out, float* lse, int B, int Sq, int Skv, int H,
                     int KVH, float scale, int causal, int window, float cap,
                     cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, qp, kv, out, lse, B, Sq, Skv, H, KVH, scale, causal,
                           window, cap, st);
    case 128:
      return launch<T, 128>(q, k, v, qp, kv, out, lse, B, Sq, Skv, H, KVH, scale, causal,
                            window, cap, st);
    case 256:
      return launch<T, 256>(q, k, v, qp, kv, out, lse, B, Sq, Skv, H, KVH, scale, causal,
                            window, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no window; logit_cap <= 0: no softcap. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ttpu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_positions, const void* kv_valid, void* out,
                              void* lse, int B, int Sq, int Skv, int H, int KVH, int D,
                              float scale, int causal, int window, float logit_cap, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_positions);
  const int* kv = static_cast<const int*>(kv_valid);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<float>(D, q, k, v, qp, kv, out, l, B, Sq, Skv, H, KVH, scale, causal,
                            window, logit_cap, st);
      break;
    case TTPU_BF16:
      err = launch_d<__nv_bfloat16>(D, q, k, v, qp, kv, out, l, B, Sq, Skv, H, KVH, scale,
                                    causal, window, logit_cap, st);
      break;
    case TTPU_F16:
      err = launch_d<__half>(D, q, k, v, qp, kv, out, l, B, Sq, Skv, H, KVH, scale, causal,
                             window, logit_cap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
