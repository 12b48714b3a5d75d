// Flash attention backward: the gradients of the forward in flash_fwd.cu,
// recomputed from the forward's per-row logsumexp (O(S) memory).
//
//   K5 (flash_bwd_dq_*):  dQ = dS K, and delta = rowsum(dO * O) on the way
//   K4 (flash_bwd_dkv_*): dV = P^T dO, dK = dS^T Q, summed over the GQA group
//
// with, for query row i and kv slot j under the forward's mask (kv_valid[j],
// j <= q_positions[i] when causal, j > q_positions[i] - window with a window):
//   s  = scale * q_i . k_j,  sc = cap * tanh(s / cap) (or s without a softcap)
//   p  = exp(sc - lse_i)                  (exactly 0 where the mask is false)
//   ds = p * (dO_i . v_j - delta_i) * (1 - (sc / cap)^2) * scale
// All sums run in f32; each gradient is rounded once to its input's type.
// exp is evaluated only where the mask holds, so a row that sees no slot
// (lse = -inf, a left-pad row) gets p = 0 and never forms exp(s + inf).
//
// Replaces transformers_tpu/ops/pallas/flash_attention.py (_flash_bwd with
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel, the block math of
// _recompute_p_ds). The Pallas version writes per-query-head f32 dK/dV
// [B, H, Skv, D] and sums the group outside the kernel, and extracts each
// head's lse/delta with a one-hot product (Mosaic forbids a dynamic lane
// index). Here one K4 block owns a kv tile of one kv head and loops over the
// query tiles that see it and the G query heads of its group itself, so the
// group sum needs no buffer and no atomics and the result is deterministic;
// lse and delta are read directly.
//
// Bound on the H100: at the training shapes (B=4, S=2048, H=32, KVH=8,
// D=128, causal) K4 does 4 and K5 3 products of 2*Sq*Skv*D/2 operations per
// head (~275 and ~206 GFLOP) against ~0.3 GB of inputs and outputs, so the
// bound is operations (~0.28 and ~0.21 ms at 989 TFLOP/s): only the tensor
// cores can approach it.
//
// bf16 and fp16 at head_dim 64, 96 and 128 take the tensor-core kernels
// (*_tc_kernel): warp-level mma.sync m16n8k16 (f32 accumulate) on operands
// loaded by ldmatrix from shared-memory tiles whose rows are padded by 16
// bytes (the 8 rows of an ldmatrix, plain or transposed, fall in distinct
// banks); tiles arrive by cp.async into two stages, so the next tile's copy
// overlaps this tile's products. Each of the 4 warps owns 16 rows: K5 16
// query rows (S = Q K^T and dP = dO V^T in registers, then dQ += dS K with dS
// taken from the accumulators as the A operand), K4 16 kv rows (it computes
// S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are already in the A-operand
// layout of dV += P^T dO and dK += dS^T Q; dK/dV stay in f32 registers).
// The second products take P and dS as tensor-core operands of the storage
// type; rounding them once would break the element-wise hold to the f32
// plain version (chip_smoke.py), so each is split into hi = round(x) and lo
// = round(x - hi), two products that carry x to ~16 bits.
// Blocks are numbered heaviest first under causality (K4: low kv tiles, K5:
// high query tiles), so the short ones fill the last wave.
//
// float32 keeps the CUDA-core FMA kernels (TF32 would not hold float32's
// tolerance), and so does head_dim 256: a warp's 16 rows of dK and dV there
// would take 256 f32 registers a thread. Those kernels: 256 threads as a
// 16 x 16 grid; tiles in shared memory with rows padded by two elements;
// each thread holds a block of the score tile and of its f32 gradient
// accumulator in registers; 64 x 64 tiles, K4 32-slot kv tiles at D = 256
// and both 32-row tiles for f32 at D = 256. Query tiles that causality or
// the window mask for the whole kv tile (K4), and kv tiles masked for the
// whole query tile (K5), are never loaded, on either route.

#include "mma.cuh"

namespace {

// ------------------------------------------------ CUDA-core FMA kernels
constexpr int NT = 256;  // threads: a 16 x 16 grid

template <typename T, int D>
struct DkvTiles {  // K4
  static constexpr int BKV = D >= 256 ? 32 : 64;
  static constexpr int BQ = (D >= 256 && sizeof(T) == 4) ? 32 : 64;
};

template <typename T, int D>
struct DqTiles {  // K5
  static constexpr int BQ = (D >= 256 && sizeof(T) == 4) ? 32 : 64;
  static constexpr int BKV = BQ;
};

// Rows [0, R) of a tile with row stride D + 2 in shared memory, from global
// rows src + r * row_stride; rows at or past n_rows are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, size_t row_stride,
                                          int n_rows) {
  using V2 = Vec<T, 2>;
  for (int idx = threadIdx.x; idx < R * (D / 2); idx += NT) {
    const int r = idx / (D / 2);
    const int c = 2 * (idx % (D / 2));
    V2 val;
    if (r < n_rows) {
      val = *reinterpret_cast<const V2*>(src + (size_t)r * row_stride + c);
    } else {
      val.x[0] = val.x[1] = from_f<T>(0.f);
    }
    *reinterpret_cast<V2*>(dst + r * (D + 2) + c) = val;
  }
}

// out[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, both tiles of stride D + 2.
template <typename T, int D, int NI, int NJ>
__device__ __forceinline__ void dot_rows(float (&out)[NI][NJ], const T* A, const T* B, int ty,
                                         int tx) {
  constexpr int S = D + 2;
  using V2 = Vec<T, 2>;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float aa[NI], ab[NI], ba[NJ], bb[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const V2 x = *reinterpret_cast<const V2*>(A + (ty + 16 * i) * S + d);
      aa[i] = to_f(x.x[0]);
      ab[i] = to_f(x.x[1]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const V2 x = *reinterpret_cast<const V2*>(B + (tx + 16 * j) * S + d);
      ba[j] = to_f(x.x[0]);
      bb[j] = to_f(x.x[1]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[i][j] = fmaf(ab[i], bb[j], fmaf(aa[i], ba[j], out[i][j]));
  }
}

// p and ds of one score entry (see the note at the top).
__device__ __forceinline__ void p_ds(float s_dot, float dp, float lse, float delta, bool vis,
                                     float scale, float cap, float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (!vis || lse == -CUDART_INF_F) return;
  const float x = s_dot * scale;
  const float sc = cap > 0.f ? cap * tanhf(x / cap) : x;
  p = expf(sc - lse);
  ds = p * (dp - delta);
  if (cap > 0.f) {
    const float t = sc / cap;
    ds *= 1.f - t * t;
  }
  ds *= scale;
}

// ------------------------------------------------------------------ K5: dQ
template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = DqTiles<T, D>::BQ, BKV = DqTiles<T, D>::BKV;
  return (size_t)(2 * BQ + 2 * BKV) * (D + 2) * sizeof(T) +  // Q, dO, K, V tiles
         (size_t)(BQ * (BKV + 1) + 2 * BQ) * sizeof(float) +  // dS, lse, delta
         (size_t)(BQ + BKV + 2) * sizeof(int);                // qpos, valid, range
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q,      // [B, Sq, H, D]
                    const T* __restrict__ k,      // [B, Skv, KVH, D]
                    const T* __restrict__ v,      // [B, Skv, KVH, D]
                    const T* __restrict__ out,    // [B, Sq, H, D] forward output
                    const T* __restrict__ dout,   // [B, Sq, H, D]
                    const float* __restrict__ lse,  // [B, H, Sq]
                    const int* __restrict__ q_positions,  // [B, Sq]
                    const int* __restrict__ kv_valid,     // [B, Skv]
                    T* __restrict__ dq,           // [B, Sq, H, D]
                    float* __restrict__ delta,    // [B, H, Sq] out: rowsum(dO * O)
                    int Sq, int Skv, int H, int KVH, float scale, int causal, int window,
                    float logit_cap) {
  constexpr int BQ = DqTiles<T, D>::BQ, BKV = DqTiles<T, D>::BKV;
  constexpr int S = D + 2;
  constexpr int PS = BKV + 1;
  constexpr int NI = BQ / 16, NJ = BKV / 16, DP = D / 32;
  using V2 = Vec<T, 2>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * S;
  T* Ks = dOs + BQ * S;
  T* Vs = Ks + BKV * S;
  float* DSs = reinterpret_cast<float*>(Vs + BKV * S);
  float* lse_s = DSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(delta_s + BQ);
  int* valid_s = qpos_s + BQ;
  int* range_s = valid_s + BKV;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int n_rows = min(BQ, Sq - q0);
  const size_t row0 = ((size_t)b * Sq + q0) * H + h;  // row index of (b, q0, h)

  load_rows<T, D, BQ>(Qs, q + row0 * D, (size_t)H * D, n_rows);
  load_rows<T, D, BQ>(dOs, dout + row0 * D, (size_t)H * D, n_rows);
  if (tid < BQ) {
    const bool live = tid < n_rows;
    qpos_s[tid] = live ? q_positions[(size_t)b * Sq + q0 + tid] : 0;
    lse_s[tid] = live ? lse[((size_t)b * H + h) * Sq + q0 + tid] : -CUDART_INF_F;
  }
  __syncthreads();

  // delta = rowsum(dO * O) in f32: NT / BQ neighbouring threads per row
  {
    constexpr int TPR = NT / BQ;
    const int r = tid / TPR;
    const int part = tid % TPR;
    float sum = 0.f;
    if (r < n_rows) {
      const T* orow = out + (row0 + (size_t)r * H) * D;
      for (int c = 2 * part; c < D; c += 2 * TPR) {
        const V2 o = *reinterpret_cast<const V2*>(orow + c);
        const V2 g = *reinterpret_cast<const V2*>(dOs + r * S + c);
        sum = fmaf(to_f(o.x[0]), to_f(g.x[0]), sum);
        sum = fmaf(to_f(o.x[1]), to_f(g.x[1]), sum);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      delta_s[r] = sum;
      if (r < n_rows) delta[((size_t)b * H + h) * Sq + q0 + r] = sum;
    }
  }
  row_range(qpos_s, n_rows, range_s);
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];
  // kv tiles outside [kv_begin, kv_end) are masked for every row of this tile
  const int kv_begin = window > 0 ? max(0, (lo - window + 1) / BKV) * BKV : 0;
  const int kv_end = causal ? min(Skv, hi + 1) : Skv;

  float2 acc[NI][DP];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) acc[i][jj] = make_float2(0.f, 0.f);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;
    const int n_kv = min(BKV, Skv - kv0);
    load_rows<T, D, BKV>(Ks, k + kv_row0 * D, (size_t)KVH * D, n_kv);
    load_rows<T, D, BKV>(Vs, v + kv_row0 * D, (size_t)KVH * D, n_kv);
    if (tid < BKV) valid_s[tid] = tid < n_kv ? kv_valid[(size_t)b * Skv + kv0 + tid] : 0;
    __syncthreads();

    float s[NI][NJ], dp[NI][NJ];
    dot_rows<T, D, NI, NJ>(s, Qs, Ks, ty, tx);
    dot_rows<T, D, NI, NJ>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r],
             visible(kv0 + c, qpos_s[r], valid_s[c], causal, window), scale, logit_cap, p, ds);
        DSs[r * PS + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty + 16 i, column pairs tx + 16 jj
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float ds[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) ds[i] = DSs[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int jj = 0; jj < DP; ++jj) {
        const V2 x = *reinterpret_cast<const V2*>(Ks + j * S + 2 * (tx + 16 * jj));
        const float ka = to_f(x.x[0]);
        const float kb = to_f(x.x[1]);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          acc[i][jj].x = fmaf(ds[i], ka, acc[i][jj].x);
          acc[i][jj].y = fmaf(ds[i], kb, acc[i][jj].y);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
    T* drow = dq + (row0 + (size_t)r * H) * D;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      V2 o;
      o.x[0] = from_f<T>(acc[i][jj].x);
      o.x[1] = from_f<T>(acc[i][jj].y);
      *reinterpret_cast<V2*>(drow + 2 * (tx + 16 * jj)) = o;
    }
  }
}

// ------------------------------------------------------------ K4: dK, dV
template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = DkvTiles<T, D>::BQ, BKV = DkvTiles<T, D>::BKV;
  return (size_t)(2 * BKV + 2 * BQ) * (D + 2) * sizeof(T) +     // K, V, Q, dO tiles
         (size_t)(2 * BQ * (BKV + 1) + 2 * BQ) * sizeof(float) +  // P, dS, lse, delta
         (size_t)(BQ + BKV + 2) * sizeof(int);                   // qpos, valid, range
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q,      // [B, Sq, H, D]
                     const T* __restrict__ k,      // [B, Skv, KVH, D]
                     const T* __restrict__ v,      // [B, Skv, KVH, D]
                     const T* __restrict__ dout,   // [B, Sq, H, D]
                     const float* __restrict__ lse,    // [B, H, Sq]
                     const float* __restrict__ delta,  // [B, H, Sq]
                     const int* __restrict__ q_positions,  // [B, Sq]
                     const int* __restrict__ kv_valid,     // [B, Skv]
                     T* __restrict__ dk,           // [B, Skv, KVH, D]
                     T* __restrict__ dv,           // [B, Skv, KVH, D]
                     int Sq, int Skv, int H, int KVH, float scale, int causal, int window,
                     float logit_cap) {
  constexpr int BQ = DkvTiles<T, D>::BQ, BKV = DkvTiles<T, D>::BKV;
  constexpr int S = D + 2;
  constexpr int PS = BKV + 1;
  constexpr int NI = BQ / 16, NJ = BKV / 16;  // score entries per thread
  constexpr int NR = BKV / 16, DP = D / 32;   // accumulator rows and column pairs per thread
  using V2 = Vec<T, 2>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BKV * S;
  T* Qs = Vs + BKV * S;
  T* dOs = Qs + BQ * S;
  float* Ps = reinterpret_cast<float*>(dOs + BQ * S);
  float* DSs = Ps + BQ * PS;
  float* lse_s = DSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(delta_s + BQ);
  int* valid_s = qpos_s + BQ;
  int* range_s = valid_s + BKV;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kv0 = blockIdx.x * BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int n_kv = min(BKV, Skv - kv0);
  const int kv_last = kv0 + n_kv - 1;
  const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;

  load_rows<T, D, BKV>(Ks, k + kv_row0 * D, (size_t)KVH * D, n_kv);
  load_rows<T, D, BKV>(Vs, v + kv_row0 * D, (size_t)KVH * D, n_kv);
  if (tid < BKV) valid_s[tid] = tid < n_kv ? kv_valid[(size_t)b * Skv + kv0 + tid] : 0;

  float2 dk_acc[NR][DP], dv_acc[NR][DP];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      dk_acc[i][jj] = make_float2(0.f, 0.f);
      dv_acc[i][jj] = make_float2(0.f, 0.f);
    }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    const int n_rows = min(BQ, Sq - q0);
    __syncthreads();  // the previous query tile's readers are done
    if (tid < BQ) qpos_s[tid] = tid < n_rows ? q_positions[(size_t)b * Sq + q0 + tid] : 0;
    __syncthreads();
    row_range(qpos_s, n_rows, range_s);
    __syncthreads();
    // no row of this query tile sees a slot of this kv tile
    if ((causal && range_s[1] < kv0) || (window > 0 && range_s[0] - window >= kv_last)) continue;

    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const size_t row0 = ((size_t)b * Sq + q0) * H + h;
      __syncthreads();  // the previous head's readers are done
      load_rows<T, D, BQ>(Qs, q + row0 * D, (size_t)H * D, n_rows);
      load_rows<T, D, BQ>(dOs, dout + row0 * D, (size_t)H * D, n_rows);
      if (tid < BQ) {
        const bool live = tid < n_rows;
        const size_t at = ((size_t)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = live ? lse[at] : -CUDART_INF_F;
        delta_s[tid] = live ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[NI][NJ], dp[NI][NJ];
      dot_rows<T, D, NI, NJ>(s, Qs, Ks, ty, tx);
      dot_rows<T, D, NI, NJ>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          float p, ds;
          p_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r],
               visible(kv0 + c, qpos_s[r], valid_s[c], causal, window), scale, logit_cap, p,
               ds);
          Ps[r * PS + c] = p;
          DSs[r * PS + c] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: kv rows ty + 16 i, column pairs tx + 16 jj
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[NR], dsv[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          pv[i] = Ps[r * PS + ty + 16 * i];
          dsv[i] = DSs[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < DP; ++jj) {
          const int c = 2 * (tx + 16 * jj);
          const V2 go = *reinterpret_cast<const V2*>(dOs + r * S + c);
          const V2 qq = *reinterpret_cast<const V2*>(Qs + r * S + c);
          const float goa = to_f(go.x[0]), gob = to_f(go.x[1]);
          const float qa = to_f(qq.x[0]), qb = to_f(qq.x[1]);
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            dv_acc[i][jj].x = fmaf(pv[i], goa, dv_acc[i][jj].x);
            dv_acc[i][jj].y = fmaf(pv[i], gob, dv_acc[i][jj].y);
            dk_acc[i][jj].x = fmaf(dsv[i], qa, dk_acc[i][jj].x);
            dk_acc[i][jj].y = fmaf(dsv[i], qb, dk_acc[i][jj].y);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_kv) continue;
    const size_t off = (kv_row0 + (size_t)r * KVH) * D;
#pragma unroll
    for (int jj = 0; jj < DP; ++jj) {
      const int c = 2 * (tx + 16 * jj);
      V2 ok, ov;
      ok.x[0] = from_f<T>(dk_acc[i][jj].x);
      ok.x[1] = from_f<T>(dk_acc[i][jj].y);
      ov.x[0] = from_f<T>(dv_acc[i][jj].x);
      ov.x[1] = from_f<T>(dv_acc[i][jj].y);
      *reinterpret_cast<V2*>(dk + off + c) = ok;
      *reinterpret_cast<V2*>(dv + off + c) = ov;
    }
  }
}


// ------------------------------------------------------ K5: dQ, tensor cores
template <typename T, int D>
struct DqTc {
  static constexpr int NW = 4;         // warps, 16 query rows each
  static constexpr int BQ = 16 * NW;   // query rows per block
  static constexpr int BKV = 64;       // kv slots per tile
  static constexpr int S = D + kPad;   // shared row stride
  static constexpr size_t smem = (size_t)(2 * BQ + 4 * BKV) * S * sizeof(T) +  // Q, dO; K, V x 2
                                 (size_t)2 * BQ * sizeof(float) +              // lse, delta
                                 (size_t)(BQ + 2 * BKV + 2) * sizeof(int);     // qpos, valid x 2, range
};

template <typename T, int D>
__global__ void __launch_bounds__(DqTc<T, D>::NW * 32)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ out,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const int* __restrict__ q_positions, const int* __restrict__ kv_valid,
                       T* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv, int H,
                       int KVH, float scale, int causal, int window, float logit_cap) {
  using C = DqTc<T, D>;
  constexpr int NW = C::NW, BQ = C::BQ, BKV = C::BKV, S = C::S;
  constexpr int NTH = NW * 32, NT = BKV / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * S;
  T* Ks = dOs + BQ * S;      // [2][BKV][S]
  T* Vs = Ks + 2 * BKV * S;  // [2][BKV][S]
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BKV * S);
  float* delta_s = lse_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(delta_s + BQ);
  int* valid_s = qpos_s + BQ;  // [2][BKV]
  int* range_s = valid_s + 2 * BKV;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  // heaviest first: under causality the last query tiles see the most slots
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int n_rows = min(BQ, Sq - q0);
  const size_t row0 = ((size_t)b * Sq + q0) * H + h;  // row index of (b, q0, h)

  cp_rows<T, D, BQ, NTH>(Qs, q + row0 * D, (size_t)H * D, n_rows);
  cp_rows<T, D, BQ, NTH>(dOs, dout + row0 * D, (size_t)H * D, n_rows);
  cp_async_commit();
  if (tid < BQ) {
    const bool live = tid < n_rows;
    qpos_s[tid] = live ? q_positions[(size_t)b * Sq + q0 + tid] : 0;
    lse_s[tid] = live ? lse[((size_t)b * H + h) * Sq + q0 + tid] : -CUDART_INF_F;
  }
  __syncthreads();
  row_range(qpos_s, n_rows, range_s);
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];
  // kv tiles outside [kv_begin, kv_end) are masked for every row of this tile
  const int kv_begin = window > 0 ? max(0, (lo - window + 1) / BKV) * BKV : 0;
  const int kv_end = causal ? min(Skv, hi + 1) : Skv;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int t, int stage) {
    const int kv0 = kv_begin + t * BKV;
    const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;
    const int n_kv = min(BKV, Skv - kv0);
    cp_rows<T, D, BKV, NTH>(Ks + stage * BKV * S, k + kv_row0 * D, (size_t)KVH * D, n_kv);
    cp_rows<T, D, BKV, NTH>(Vs + stage * BKV * S, v + kv_row0 * D, (size_t)KVH * D, n_kv);
    cp_vals<BKV>(valid_s + stage * BKV, kv_valid + (size_t)b * Skv + kv0, n_kv);
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_kv(0, 0);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // delta = rowsum(dO * O) in f32: NTH / BQ neighbouring threads per row
  {
    constexpr int TPR = NTH / BQ;
    constexpr int EPC = 16 / (int)sizeof(T);
    const int r = tid / TPR;
    const int part = tid % TPR;
    float sum = 0.f;
    if (r < n_rows) {
      const T* orow = out + (row0 + (size_t)r * H) * D;
      for (int c = part * EPC; c < D; c += TPR * EPC) {
        float o[EPC], g[EPC];
        load_f<T, EPC>(orow + c, o);
        load_f<T, EPC>(dOs + r * S + c, g);
#pragma unroll
        for (int e = 0; e < EPC; ++e) sum = fmaf(o[e], g[e], sum);
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      delta_s[r] = sum;
      if (r < n_rows) delta[((size_t)b * H + h) * Sq + q0 + r] = sum;
    }
  }
  __syncthreads();

  // this thread's two query rows: gr and gr + 8 of the warp's 16
  const int rw = w * 16 + gr;
  const float lse_r[2] = {lse_s[rw], lse_s[rw + 8]};
  const float delta_r[2] = {delta_s[rw], delta_s[rw + 8]};
  const int qp_r[2] = {qpos_s[rw], qpos_s[rw + 8]};

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + stage * BKV * S;
    const T* Vt = Vs + stage * BKV * S;
    const int* vt = valid_s + stage * BKV;
    const int kv0 = kv_begin + t * BKV;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      const int a_off = (w * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(aq, Qs + a_off);
      ldsm_x4(ao, dOs + a_off);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        const int b_off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(bk, Kt + b_off);
        ldsm_x4(bv, Vt + b_off);
        mma16816<T>(s[2 * np], aq, bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], aq, bk[2], bk[3]);
        mma16816<T>(dp[2 * np], ao, bv[0], bv[1]);
        mma16816<T>(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS in place of S
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tg + (e & 1);
        const int i = e >> 1;
        float p, ds;
        p_ds(s[j][e], dp[j][e], lse_r[i], delta_r[i],
             visible(kv0 + c, qp_r[i], vt[c], causal, window), scale, logit_cap, p, ds);
        s[j][e] = ds;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      acc_to_a<T, NT>(s, kk, a_hi, a_lo);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (kk * 16 + (lane & 15)) * S + dp2 * 16 + (lane >> 4) * 8);
        mma16816<T>(acc[2 * dp2], a_hi, bk[0], bk[1]);
        mma16816<T>(acc[2 * dp2 + 1], a_hi, bk[2], bk[3]);
        mma16816<T>(acc[2 * dp2], a_lo, bk[0], bk[1]);
        mma16816<T>(acc[2 * dp2 + 1], a_lo, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled in the next iteration
  }

  store_acc<T, D>(acc, [&](int i) -> T* {
    const int r = rw + 8 * i;
    return r < n_rows ? dq + (row0 + (size_t)r * H) * D : nullptr;
  });
}

// -------------------------------------------------- K4: dK, dV, tensor cores
template <typename T, int D>
struct DkvTc {
  static constexpr int NW = 4;                 // warps, 16 kv rows each
  static constexpr int BKV = 16 * NW;          // kv slots per block
  static constexpr int BQ = D <= 64 ? 64 : 32; // query rows per tile
  static constexpr int S = D + kPad;
  static constexpr size_t smem = (size_t)(2 * BKV + 4 * BQ) * S * sizeof(T) +  // K, V; Q, dO x 2
                                 (size_t)4 * BQ * sizeof(float) +  // lse, delta x 2
                                 (size_t)(2 * BQ + BKV + 2) * sizeof(int);  // qpos x 2, valid, range
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvTc<T, D>::NW * 32)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ q_positions, const int* __restrict__ kv_valid,
                        T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                        float scale, int causal, int window, float logit_cap) {
  using C = DkvTc<T, D>;
  constexpr int NW = C::NW, BKV = C::BKV, BQ = C::BQ, S = C::S;
  constexpr int NTH = NW * 32, NQ = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BKV * S;
  T* Qs = Vs + BKV * S;       // [2][BQ][S]
  T* dOs = Qs + 2 * BQ * S;   // [2][BQ][S]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * S);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                           // [2][BQ]
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * BQ);    // [2][BQ]
  int* valid_s = qpos_s + 2 * BQ;                            // [BKV]
  int* range_s = valid_s + BKV;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  // heaviest first: under causality the first kv tiles are seen by the most rows
  const int kv0 = blockIdx.z * BKV;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int n_kv = min(BKV, Skv - kv0);
  const int kv_last = kv0 + n_kv - 1;
  const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;

  cp_rows<T, D, BKV, NTH>(Ks, k + kv_row0 * D, (size_t)KVH * D, n_kv);
  cp_rows<T, D, BKV, NTH>(Vs, v + kv_row0 * D, (size_t)KVH * D, n_kv);
  cp_vals<BKV>(valid_s, kv_valid + (size_t)b * Skv + kv0, n_kv);
  cp_async_commit();

  // The first and last query tile that some row of it sees this kv tile
  // (a warp per query tile); the tiles between them are all visited.
  if (tid == 0) {
    range_s[0] = 0x7fffffff;
    range_s[1] = -1;
  }
  __syncthreads();
  const int* qpos_row = q_positions + (size_t)b * Sq;
  for (int qt = w * BQ; qt < Sq; qt += NW * BQ) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = lane; r < min(BQ, Sq - qt); r += 32) {
      const int p = qpos_row[qt + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    const bool skip = (causal && hi < kv0) || (window > 0 && lo - window >= kv_last);
    if (!skip && lane == 0) {
      atomicMin(&range_s[0], qt);
      atomicMax(&range_s[1], qt);
    }
  }
  __syncthreads();
  const int qt_first = range_s[0];
  const int n_items = range_s[1] >= qt_first ? ((range_s[1] - qt_first) / BQ + 1) * G : 0;

  // item i: query tile qt_first + (i / G) * BQ of head kvh * G + i % G
  auto load_q = [&](int item, int stage) {
    const int qt = qt_first + (item / G) * BQ;
    const int h = kvh * G + item % G;
    const int n_rows = min(BQ, Sq - qt);
    const size_t row0 = ((size_t)b * Sq + qt) * H + h;
    const size_t at = ((size_t)b * H + h) * Sq + qt;
    cp_rows<T, D, BQ, NTH>(Qs + stage * BQ * S, q + row0 * D, (size_t)H * D, n_rows);
    cp_rows<T, D, BQ, NTH>(dOs + stage * BQ * S, dout + row0 * D, (size_t)H * D, n_rows);
    cp_vals<BQ>(lse_s + stage * BQ, lse + at, n_rows);
    cp_vals<BQ>(delta_s + stage * BQ, delta + at, n_rows);
    cp_vals<BQ>(qpos_s + stage * BQ, qpos_row + qt, n_rows);
    cp_async_commit();
  };
  if (n_items > 0) load_q(0, 0);

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int rw = w * 16 + gr;  // this thread's kv rows: rw and rw + 8

  for (int it = 0; it < n_items; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_items) {
      load_q(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_rows = min(BQ, Sq - (qt_first + (it / G) * BQ));
    const T* Qt = Qs + stage * BQ * S;
    const T* dOt = dOs + stage * BQ * S;
    const float* lt = lse_s + stage * BQ;
    const float* dt = delta_s + stage * BQ;
    const int* pt = qpos_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 kv rows
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int a_off = (w * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ak, Ks + a_off);
      ldsm_x4(av, Vs + a_off);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bq[4], bo[4];
        const int b_off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        ldsm_x4(bq, Qt + b_off);
        ldsm_x4(bo, dOt + b_off);
        mma16816<T>(st[2 * np], ak, bq[0], bq[1]);
        mma16816<T>(st[2 * np + 1], ak, bq[2], bq[3]);
        mma16816<T>(dpt[2 * np], av, bo[0], bo[1]);
        mma16816<T>(dpt[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tg + (e & 1);
        const int rr = rw + 8 * (e >> 1);
        const bool vis = c < n_rows && visible(kv0 + rr, pt[c], valid_s[rr], causal, window);
        float p, ds;
        p_ds(st[j][e], dpt[j][e], lt[c], dt[c], vis, scale, logit_cap, p, ds);
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
      acc_to_a<T, NQ>(st, kk, p_hi, p_lo);
      acc_to_a<T, NQ>(dpt, kk, ds_hi, ds_lo);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bo[4], bq[4];
        const int off = (kk * 16 + (lane & 15)) * S + dp2 * 16 + (lane >> 4) * 8;
        ldsm_x4_t(bo, dOt + off);
        ldsm_x4_t(bq, Qt + off);
        mma16816<T>(dv_acc[2 * dp2], p_hi, bo[0], bo[1]);
        mma16816<T>(dv_acc[2 * dp2 + 1], p_hi, bo[2], bo[3]);
        mma16816<T>(dk_acc[2 * dp2], ds_hi, bq[0], bq[1]);
        mma16816<T>(dk_acc[2 * dp2 + 1], ds_hi, bq[2], bq[3]);
        mma16816<T>(dv_acc[2 * dp2], p_lo, bo[0], bo[1]);
        mma16816<T>(dv_acc[2 * dp2 + 1], p_lo, bo[2], bo[3]);
        mma16816<T>(dk_acc[2 * dp2], ds_lo, bq[0], bq[1]);
        mma16816<T>(dk_acc[2 * dp2 + 1], ds_lo, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled in the next iteration
  }
  cp_async_wait<0>();  // K/V's copies, when no query tile was visited

  auto kv_row = [&](T* base) {
    return [=](int i) -> T* {
      const int r = rw + 8 * i;
      return r < n_kv ? base + (kv_row0 + (size_t)r * KVH) * D : nullptr;
    };
  };
  store_acc<T, D>(dk_acc, kv_row(dk));
  store_acc<T, D>(dv_acc, kv_row(dv));
}

// ---------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *out_or_dout, *dout_or_lse, *lse_or_delta;
  const int *q_positions, *kv_valid;
  void *o1, *o2;
  int B, Sq, Skv, H, KVH;
  float scale;
  int causal, window;
  float cap;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  static bool smem_set = false;  // once per instantiation (also keeps it out of graph capture)
  if constexpr (use_tensor_cores<T, D>()) {
    using C = DqTc<T, D>;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)C::smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    dim3 grid(a.H, a.B, (a.Sq + C::BQ - 1) / C::BQ);
    flash_bwd_dq_tc_kernel<T, D><<<grid, C::NW * 32, C::smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.out_or_dout), static_cast<const T*>(a.dout_or_lse),
        static_cast<const float*>(a.lse_or_delta), a.q_positions, a.kv_valid,
        static_cast<T*>(a.o1), static_cast<float*>(a.o2), a.Sq, a.Skv, a.H, a.KVH, a.scale,
        a.causal, a.window, a.cap);
  } else {
    constexpr size_t bytes = dq_smem_bytes<T, D>();
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    constexpr int BQ = DqTiles<T, D>::BQ;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.out_or_dout), static_cast<const T*>(a.dout_or_lse),
        static_cast<const float*>(a.lse_or_delta), a.q_positions, a.kv_valid,
        static_cast<T*>(a.o1), static_cast<float*>(a.o2), a.Sq, a.Skv, a.H, a.KVH, a.scale,
        a.causal, a.window, a.cap);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  static bool smem_set = false;
  if constexpr (use_tensor_cores<T, D>()) {
    using C = DkvTc<T, D>;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)C::smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    dim3 grid(a.KVH, a.B, (a.Skv + C::BKV - 1) / C::BKV);
    flash_bwd_dkv_tc_kernel<T, D><<<grid, C::NW * 32, C::smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.out_or_dout), static_cast<const float*>(a.dout_or_lse),
        static_cast<const float*>(a.lse_or_delta), a.q_positions, a.kv_valid,
        static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.Sq, a.Skv, a.H, a.KVH, a.scale,
        a.causal, a.window, a.cap);
  } else {
    constexpr size_t bytes = dkv_smem_bytes<T, D>();
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    constexpr int BKV = DkvTiles<T, D>::BKV;
    dim3 grid((a.Skv + BKV - 1) / BKV, a.KVH, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.out_or_dout), static_cast<const float*>(a.dout_or_lse),
        static_cast<const float*>(a.lse_or_delta), a.q_positions, a.kv_valid,
        static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.Sq, a.Skv, a.H, a.KVH, a.scale,
        a.causal, a.window, a.cap);
  }
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 96:
      return DQ ? launch_dq<T, 96>(a) : launch_dkv<T, 96>(a);
    case 128:
      return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256:
      return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch_dtype(int dtype, int D, const Args& a) {
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<DQ, float>(D, a);
      break;
    case TTPU_BF16:
      err = launch_d<DQ, __nv_bfloat16>(D, a);
      break;
    case TTPU_F16:
      err = launch_d<DQ, __half>(D, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// K5. Writes dq [B, Sq, H, D] (q's type) and delta [B, H, Sq] (f32, read by
// K4). window <= 0: no window; logit_cap <= 0: no softcap. Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int ttpu_flash_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, const void* q_positions,
                                 const void* kv_valid, void* dq, void* delta, int B, int Sq,
                                 int Skv, int H, int KVH, int D, float scale, int causal,
                                 int window, float logit_cap, int dtype, void* stream) {
  Args a{q, k, v, out, dout, lse, static_cast<const int*>(q_positions),
         static_cast<const int*>(kv_valid), dq, delta, B, Sq, Skv, H, KVH, scale, causal,
         window, logit_cap, static_cast<cudaStream_t>(stream)};
  return launch_dtype<true>(dtype, D, a);
}

// K4. Reads delta from K5; writes dk and dv [B, Skv, KVH, D] (k's type).
extern "C" int ttpu_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* q_positions,
                                  const void* kv_valid, void* dk, void* dv, int B, int Sq,
                                  int Skv, int H, int KVH, int D, float scale, int causal,
                                  int window, float logit_cap, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, static_cast<const int*>(q_positions),
         static_cast<const int*>(kv_valid), dk, dv, B, Sq, Skv, H, KVH, scale, causal, window,
         logit_cap, static_cast<cudaStream_t>(stream)};
  return launch_dtype<false>(dtype, D, a);
}
