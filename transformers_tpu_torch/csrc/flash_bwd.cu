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
// cores can approach it. At Gemma-3-12B's (H=16, KVH=8, D=256) the
// operations are the same, and f32 FMAs (~67 TFLOP/s) could not come under
// ~7 ms.
//
// Three routes, chosen by bwd_route (at the launchers) from the storage
// type and D.
//
// bf16 and fp16 at head_dim 64, 96 and 128 take the mma.sync kernels
// (*_tc_kernel): warp-level mma.sync m16n8k16 (f32 accumulate) on operands
// loaded by ldmatrix from shared-memory tiles whose rows are padded by 16
// bytes (the 8 rows of an ldmatrix, plain or transposed, fall in distinct
// banks); tiles arrive by cp.async into two stages, so the next tile's copy
// overlaps this tile's products. Each of the 4 warps owns 16 rows: K5 16
// query rows (S = Q K^T and dP = dO V^T in registers, then dQ += dS K with dS
// taken from the accumulators as the A operand), K4 16 kv rows (it computes
// S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are already in the A-operand
// layout of dV += P^T dO and dK += dS^T Q; dK/dV stay in f32 registers).
//
// bf16 and fp16 at head_dim 256 (Gemma, Gemma-2, Gemma-3) take the Hopper
// kernels (*_wg_kernel, helpers in wgmma.cuh), K1's shape (flash_fwd.cu): a
// block is one producer warpgroup, one of whose threads issues every TMA
// load (128-byte-swizzled boxes from 4-d tensor maps over the BSHD tensors,
// whose zero fill covers the ragged ends) into a ring of two stages with
// full and empty mbarriers, and two consumer warpgroups whose products are
// wgmma with their operands read from shared memory by descriptor;
// setmaxnreg moves registers from the producer (40) to the consumers (232).
// At D = 256 a warp's 16 rows of dK and dV would take 256 f32 registers a
// thread, which sets the split:
// - K5 (flash_bwd_dq_wg_kernel): each consumer owns 64 query rows of one
//   head (one head's 128 rows a block, as K1); Q and dO arrive once, K and V
//   in 32-slot tiles. S = Q K^T and dP = dO V^T are 16 wgmma m64n32k16 each
//   (f32, 16 + 16 registers), dS is formed in registers and is the A operand
//   of dQ += dS K (wgmma m64n256k16, K read transposed; dQ in 128 f32
//   registers). delta = rowsum(dO * O) is computed first from global memory,
//   each warp its own rows: O never enters shared memory.
// - K4 (flash_bwd_dkv_wg_kernel): both consumers share one 64-slot kv tile of
//   one kv head (K and V arrive once) and each holds half of the head dim of
//   dK and dV (64 + 64 f32 registers a thread). Per item (a 64-row query tile
//   of one query head of the group) each consumer computes S^T = K Q^T and
//   dP^T = V dO^T for half of the query rows (wgmma m64n32k16: the two halves
//   cost the same, and each consumer forms p and ds where it holds both s
//   and dp), then writes its P^T and dS^T columns as hi and lo into four
//   exchange tiles in the A operand's K-major swizzled layout; the consumers
//   meet at named barriers around the exchange, and each adds dV_half +=
//   P^T dO_half and dK_half += dS^T Q_half (wgmma m64n128k16, dO and Q read
//   transposed) over all of the tile's query rows.
// Tiles that causality or the window hide from a whole block are never
// loaded; a K5 consumer skips the products of a kv tile that none of its
// rows sees, and a K4 block whose kv tile holds no live slot visits no query
// tile.
//
// On both tensor-core routes the second products (dV += P^T dO, dK += dS^T
// Q, dQ += dS K) take P and dS as tensor-core operands of the storage type;
// rounding them once would break the element-wise hold to the f32 plain
// version (chip_smoke.py), so each is split into hi = round(x) and lo =
// round(x - hi), two products that carry x to ~16 bits. Blocks are numbered
// heaviest first under causality (K4: low kv tiles, K5: high query tiles),
// so the short ones fill the last wave.
//
// float32 keeps the CUDA-core FMA kernels at every head_dim (TF32 would not
// hold float32's tolerance): 256 threads as a 16 x 16 grid; tiles in shared
// memory with rows padded by two elements; each thread holds a block of the
// score tile and of its f32 gradient accumulator in registers; 64 x 64
// tiles, 32 x 32 at D = 256. Query tiles that causality or the window mask
// for the whole kv tile (K4), and kv tiles masked for the whole query tile
// (K5), are never loaded, on every route.

#include "wgmma.cuh"

namespace {

// ------------------------------------------------ CUDA-core FMA kernels
constexpr int NT = 256;  // threads: a 16 x 16 grid

template <int D>
struct DkvTiles {  // K4
  static constexpr int BKV = D >= 256 ? 32 : 64;
  static constexpr int BQ = D >= 256 ? 32 : 64;
};

template <int D>
struct DqTiles {  // K5
  static constexpr int BQ = D >= 256 ? 32 : 64;
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
  constexpr int BQ = DqTiles<D>::BQ, BKV = DqTiles<D>::BKV;
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
  constexpr int BQ = DqTiles<D>::BQ, BKV = DqTiles<D>::BKV;
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
  constexpr int BQ = DkvTiles<D>::BQ, BKV = DkvTiles<D>::BKV;
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
  constexpr int BQ = DkvTiles<D>::BQ, BKV = DkvTiles<D>::BKV;
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

// ------------------------------------------ head_dim 256: wgmma and TMA
// K5: one block of three warpgroups, as K1's: warpgroup 0 is the producer
// (one of its warps issues every TMA load), warpgroups 1 and 2 are consumers
// of 64 query rows each, rows [0, 64) and [64, 128) of one head's 128.
struct DqWg {
  static constexpr int D = 256;
  static constexpr int BM = 64;    // query rows of a consumer warpgroup
  static constexpr int BKV = 32;   // kv slots per tile
  static constexpr int NC = 2;     // consumer warpgroups
  static constexpr int NTH = 128 * (NC + 1);
  static constexpr int STAGES = 2;                 // K/V ring
  static constexpr int Q_TILE = D / 64 * BM * 128;  // 64 rows x 256: 32 KB
  static constexpr int KV_BOX = BKV * 128;          // BKV rows x 64 elements
  static constexpr int KV_TILE = D / 64 * KV_BOX;   // BKV rows x 256
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + NC * Q_TILE;
  static constexpr int K_OFF = DO_OFF + NC * Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int VALID_OFF = V_OFF + STAGES * KV_TILE;     // int [STAGES][BKV]
  static constexpr int QPOS_OFF = VALID_OFF + STAGES * BKV * 4;  // int [NC * BM]
  static constexpr int RANGE_OFF = QPOS_OFF + NC * BM * 4;       // int [2 (NC + 1)]
  static constexpr int BAR_OFF = RANGE_OFF + 8 * 4;  // q_full, kv_full[2], empty[2]
  static constexpr size_t smem = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
  static_assert(BAR_OFF % 8 == 0 && 2 * (NC + 1) <= 8 && smem <= 232448, "shared layout");
};

template <typename T>
__global__ void __launch_bounds__(DqWg::NTH, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap q_map,   // [B, Sq, H, D]
                       const __grid_constant__ CUtensorMap k_map,   // [B, Skv, KVH, D]
                       const __grid_constant__ CUtensorMap v_map,   // [B, Skv, KVH, D]
                       const __grid_constant__ CUtensorMap do_map,  // [B, Sq, H, D]
                       const T* __restrict__ out, const T* __restrict__ dout,
                       const float* __restrict__ lse, const int* __restrict__ q_positions,
                       const int* __restrict__ kv_valid, T* __restrict__ dq,
                       float* __restrict__ delta, int Sq, int Skv, int H, int KVH, float scale,
                       int causal, int window, float logit_cap) {
  using C = DqWg;
  constexpr int D = C::D, BM = C::BM, BKV = C::BKV, NC = C::NC, NT = BKV / 8, DT = D / 8;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* valid_s = reinterpret_cast<int*>(smem + C::VALID_OFF);
  int* qpos_s = reinterpret_cast<int*>(smem + C::QPOS_OFF);
  int* range_s = reinterpret_cast<int*>(smem + C::RANGE_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* kv_full = q_full + 1;
  uint64_t* empty = kv_full + C::STAGES;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  // heaviest first: under causality the last query tiles see the most slots
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int b = blockIdx.y, h = blockIdx.x, kvh = h / (H / KVH);
  auto row0_of = [&](int c) { return (tile * NC + c) * BM; };

  if (tid < NC * BM) {
    const int r = row0_of(tid / BM) + tid % BM;
    qpos_s[tid] = r < Sq ? q_positions[(size_t)b * Sq + r] : 0;
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&kv_full[s], 32);    // the producer warp (its valid flags) + K's and V's bytes
      mbar_init(&empty[s], NC * 4);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the smallest and largest position of the block's live rows and of each consumer's
  wg_row_ranges<NC, BM>(qpos_s, row0_of(0), Sq, range_s);
  __syncthreads();
  // kv tiles outside [kv_begin, kv_end) are masked for every row of the block
  const int kv_begin = window > 0 ? max(0, (range_s[0] - window + 1) / BKV) * BKV : 0;
  const int kv_end = causal ? min(Skv, range_s[1] + 1) : Skv;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  if (wg == 0) {
    // ---- producer: Q and dO once, then K and V tiles into the ring
    regs_dec<40>();
    if (tid >= 32) return;
    unsigned char* Qs = smem + C::Q_OFF;
    unsigned char* dOs = smem + C::DO_OFF;
    unsigned char* Ks = smem + C::K_OFF;
    unsigned char* Vs = smem + C::V_OFF;
    if (n_tiles > 0 && lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * NC * C::Q_TILE);
      for (int c = 0; c < NC; ++c)
        for (int i = 0; i < D / 64; ++i) {
          const int off = c * C::Q_TILE + i * BM * 128;
          tma_load_4d(Qs + off, &q_map, q_full, 64 * i, h, row0_of(c), b);
          tma_load_4d(dOs + off, &do_map, q_full, 64 * i, h, row0_of(c), b);
        }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::STAGES;
      mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
      const int kv0 = kv_begin + t * BKV;
      for (int i = lane; i < BKV; i += 32)
        valid_s[s * BKV + i] = kv0 + i < Skv ? kv_valid[(size_t)b * Skv + kv0 + i] : 0;
      if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full[s], 2 * C::KV_TILE);
        for (int i = 0; i < D / 64; ++i) {
          const int off = s * C::KV_TILE + i * C::KV_BOX;
          tma_load_4d(Ks + off, &k_map, &kv_full[s], 64 * i, kvh, kv0, b);
          tma_load_4d(Vs + off, &v_map, &kv_full[s], 64 * i, kvh, kv0, b);
        }
      } else {
        mbar_arrive(&kv_full[s]);
      }
    }
    return;
  }

  // ---- consumers
  regs_inc<232>();
  const int c = wg - 1;
  const int w = (tid >> 5) & 3;  // warp of the warpgroup: rows 16 w .. 16 w + 15
  const int gr = lane >> 2, tg = lane & 3;
  const int q0 = row0_of(c);
  const int n_rows = min(BM, Sq - q0);  // <= 0: a consumer with no rows (the last tile)
  const int wg_lo = range_s[2 + 2 * c], wg_hi = range_s[3 + 2 * c];
  const size_t row0 = ((size_t)b * Sq + q0) * H + h;  // row index of (b, q0, h)
  const size_t stat0 = ((size_t)b * H + h) * Sq + q0;  // lse / delta index of row q0
  // this thread's two query rows: gr and gr + 8 of the warp's 16
  const int rw = w * 16 + gr;
  const bool live_r[2] = {rw < n_rows, rw + 8 < n_rows};
  const int qp_r[2] = {qpos_s[c * BM + rw], qpos_s[c * BM + rw + 8]};
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lse_r[i] = live_r[i] ? lse[stat0 + rw + 8 * i] : -CUDART_INF_F;

  // delta = rowsum(dO * O) in f32 from global memory (O never enters shared
  // memory): each warp its own 16 rows, 8 elements a lane; K4 reads it back
  float delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = w * 16 + r;
    if (row >= n_rows) break;  // the same for the whole warp
    float o[8], g[8];
    load_f<T, 8>(out + (row0 + (size_t)row * H) * D + lane * 8, o);
    load_f<T, 8>(dout + (row0 + (size_t)row * H) * D + lane * 8, g);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part = fmaf(o[e], g[e], part);
    const float sum = warp_sum(part);
    if (r == gr) delta_r[0] = sum;
    if (r == gr + 8) delta_r[1] = sum;
    if (lane == 0) delta[stat0 + row] = sum;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const unsigned char* Qs = smem + C::Q_OFF + c * C::Q_TILE;
  const unsigned char* dOs = smem + C::DO_OFF + c * C::Q_TILE;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const int kv0 = kv_begin + t * BKV;
    mbar_wait(&kv_full[s], (t / C::STAGES) & 1);
    // warpgroup-uniform: a tile that none of the consumer's rows sees
    const bool seen = wg_lo <= wg_hi && !(causal && kv0 > wg_hi) &&
                      !(window > 0 && kv0 + BKV - 1 <= wg_lo - window);
    if (seen) {
      const unsigned char* Kt = smem + C::K_OFF + s * C::KV_TILE;
      const unsigned char* Vt = smem + C::V_OFF + s * C::KV_TILE;
      const int* vt = valid_s + s * BKV;

      // S = Q K^T and dP = dO V^T: 16 steps of 16 over D, 4 to a 128-byte box
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qa = (kk / 4) * BM * 128 + (kk % 4) * 32;
        const int kb = (kk / 4) * C::KV_BOX + (kk % 4) * 32;
        wgmma_ss<T>(sc, wgmma_desc(Qs + qa, 16, 1024), wgmma_desc(Kt + kb, 16, 1024), 1);
        wgmma_ss<T>(dp, wgmma_desc(dOs + qa, 16, 1024), wgmma_desc(Vt + kb, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS in place of S, then as A fragments of hi + lo
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tg + (e & 1);
          const int i = e >> 1;
          float p, ds;
          p_ds(sc[j][e], dp[j][e], lse_r[i], delta_r[i],
               visible(kv0 + col, qp_r[i], vt[col], causal, window), scale, logit_cap, p, ds);
          sc[j][e] = ds;
        }
      }
      uint32_t a_hi[BKV / 16][4], a_lo[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) acc_to_a<T, NT>(sc, kk, a_hi[kk], a_lo[kk]);

      // dQ += dS K: BKV / 16 steps of 16 slots, K's rows read transposed
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t bk = wgmma_desc(Kt + kk * 16 * 128, C::KV_BOX, 1024);
        wgmma_rs<T>(acc, a_hi[kk], bk, 1);
        wgmma_rs<T>(acc, a_lo[kk], bk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_acc<T, D>(acc, [&](int i) -> T* {
    return live_r[i] ? dq + (row0 + (size_t)(rw + 8 * i) * H) * D : nullptr;
  });
}

// K4: one block of three warpgroups owns a 64-slot kv tile of one kv head:
// warpgroup 0 is the producer, warpgroups 1 and 2 are consumers that each
// hold half of the head dim of dK and dV (columns [128 c, 128 c + 128)).
struct DkvWg {
  static constexpr int D = 256;
  static constexpr int BKV = 64;      // kv slots of the block
  static constexpr int BQ = 64;       // query rows per tile
  static constexpr int NC = 2;        // consumer warpgroups
  static constexpr int DH = D / NC;   // dK / dV columns of a consumer
  static constexpr int NQ = BQ / NC;  // query columns of S^T and dP^T a consumer computes
  static constexpr int NTH = 128 * (NC + 1);
  static constexpr int STAGES = 2;                   // Q/dO ring
  static constexpr int KV_BOX = BKV * 128;           // 64 rows x 64 elements: 8 KB
  static constexpr int KV_TILE = D / 64 * KV_BOX;    // 32 KB
  static constexpr int Q_BOX = BQ * 128;             // BQ rows x 64 elements
  static constexpr int Q_TILE = D / 64 * Q_BOX;
  static constexpr int X_TILE = BKV * 128;  // an exchange tile: 64 kv rows x BQ query columns
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_TILE;
  static constexpr int Q_OFF = V_OFF + KV_TILE;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_TILE;
  static constexpr int X_OFF = DO_OFF + STAGES * Q_TILE;   // P hi, P lo, dS hi, dS lo
  static constexpr int ROW_OFF = X_OFF + 4 * X_TILE;       // lse, delta, qpos: [STAGES][BQ] each
  static constexpr int VALID_OFF = ROW_OFF + 3 * STAGES * BQ * 4;  // int [BKV]
  static constexpr int RANGE_OFF = VALID_OFF + BKV * 4;            // int [2]
  static constexpr int BAR_OFF = RANGE_OFF + 8;  // kv_full, q_full[2], empty[2]
  static constexpr size_t smem = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
  static_assert(NQ == 32 && BQ * 2 == 128, "m64n32 halves; a 128-byte exchange row");
  static_assert(BAR_OFF % 8 == 0 && smem <= 232448, "shared layout");
};

template <typename T>
__global__ void __launch_bounds__(DkvWg::NTH, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap q_map,   // [B, Sq, H, D]
                        const __grid_constant__ CUtensorMap k_map,   // [B, Skv, KVH, D]
                        const __grid_constant__ CUtensorMap v_map,   // [B, Skv, KVH, D]
                        const __grid_constant__ CUtensorMap do_map,  // [B, Sq, H, D]
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ q_positions, const int* __restrict__ kv_valid,
                        T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KVH,
                        float scale, int causal, int window, float logit_cap) {
  using C = DkvWg;
  constexpr int D = C::D, BKV = C::BKV, BQ = C::BQ, NQ = C::NQ, DH = C::DH, NT = NQ / 8;
  constexpr int NWARPS = C::NTH / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* lse_s = reinterpret_cast<float*>(smem + C::ROW_OFF);  // [STAGES][BQ]
  float* delta_s = lse_s + C::STAGES * BQ;                     // [STAGES][BQ]
  int* qpos_s = reinterpret_cast<int*>(delta_s + C::STAGES * BQ);  // [STAGES][BQ]
  int* valid_s = reinterpret_cast<int*>(smem + C::VALID_OFF);
  int* range_s = reinterpret_cast<int*>(smem + C::RANGE_OFF);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* q_full = kv_full + 1;
  uint64_t* empty = q_full + C::STAGES;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  // heaviest first: under causality the first kv tiles are seen by the most rows
  const int kv0 = blockIdx.z * BKV;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KVH;
  const int n_kv = min(BKV, Skv - kv0);
  const int kv_last = kv0 + n_kv - 1;

  if (tid < BKV) valid_s[tid] = tid < n_kv ? kv_valid[(size_t)b * Skv + kv0 + tid] : 0;
  if (tid == 0) {
    range_s[0] = 0x7fffffff;
    range_s[1] = -1;
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&q_full[s], 32);      // the producer warp (the rows' values) + Q's and dO's bytes
      mbar_init(&empty[s], C::NC * 4);  // every consumer warp
    }
    mbar_fence_init();
  }
  // a tile without a live slot gets dK = dV = 0 and visits no query tile
  const bool any_live = __syncthreads_or(tid < BKV && valid_s[tid] != 0);
  // The first and last query tile that some row of it sees this kv tile (a
  // warp per query tile); the tiles between them are all visited.
  const int* qpos_row = q_positions + (size_t)b * Sq;
  if (any_live) {
    for (int qt = (tid >> 5) * BQ; qt < Sq; qt += NWARPS * BQ) {
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
  }
  __syncthreads();
  const int qt_first = range_s[0];
  // item i: query tile qt_first + (i / G) * BQ of head kvh * G + i % G
  const int n_items = range_s[1] >= qt_first ? ((range_s[1] - qt_first) / BQ + 1) * G : 0;

  if (wg == 0) {
    // ---- producer: K and V once, then the items' Q and dO tiles into the ring
    regs_dec<40>();
    if (tid >= 32) return;
    unsigned char* Qs = smem + C::Q_OFF;
    unsigned char* dOs = smem + C::DO_OFF;
    if (n_items > 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::KV_TILE);
      for (int i = 0; i < D / 64; ++i) {
        tma_load_4d(smem + C::K_OFF + i * C::KV_BOX, &k_map, kv_full, 64 * i, kvh, kv0, b);
        tma_load_4d(smem + C::V_OFF + i * C::KV_BOX, &v_map, kv_full, 64 * i, kvh, kv0, b);
      }
    }
    for (int it = 0; it < n_items; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
      const int qt = qt_first + (it / G) * BQ;
      const int h = kvh * G + it % G;
      for (int i = lane; i < BQ; i += 32) {  // rows past Sq: lse -inf, so p = ds = 0
        const bool live = qt + i < Sq;
        const size_t at = ((size_t)b * H + h) * Sq + qt + i;
        lse_s[s * BQ + i] = live ? lse[at] : -CUDART_INF_F;
        delta_s[s * BQ + i] = live ? delta[at] : 0.f;
        qpos_s[s * BQ + i] = live ? qpos_row[qt + i] : 0;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[s], 2 * C::Q_TILE);
        for (int i = 0; i < D / 64; ++i) {
          const int off = s * C::Q_TILE + i * C::Q_BOX;
          tma_load_4d(Qs + off, &q_map, &q_full[s], 64 * i, h, qt, b);
          tma_load_4d(dOs + off, &do_map, &q_full[s], 64 * i, h, qt, b);
        }
      } else {
        mbar_arrive(&q_full[s]);
      }
    }
    return;
  }

  // ---- consumers
  regs_inc<232>();
  const int c = wg - 1;  // this consumer's half of the head dim
  const int w = (tid >> 5) & 3;
  const int gr = lane >> 2, tg = lane & 3;
  const int rw = w * 16 + gr;  // this thread's kv rows: rw and rw + 8
  const int valid_r[2] = {valid_s[rw], valid_s[rw + 8]};
  const unsigned char* Ks = smem + C::K_OFF;
  const unsigned char* Vs = smem + C::V_OFF;
  unsigned char* Xs = smem + C::X_OFF;

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (n_items > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(&q_full[s], (it / C::STAGES) & 1);
    const unsigned char* Qt = smem + C::Q_OFF + s * C::Q_TILE;
    const unsigned char* dOt = smem + C::DO_OFF + s * C::Q_TILE;
    const float* lt = lse_s + s * BQ;
    const float* dt = delta_s + s * BQ;
    const int* pt = qpos_s + s * BQ;

    // S^T = K Q^T and dP^T = V dO^T over this consumer's NQ query columns
    // (rows [c NQ, c NQ + NQ) of the Q and dO tiles): 16 steps of 16 over D
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ka = (kk / 4) * C::KV_BOX + (kk % 4) * 32;
      const int qb = (kk / 4) * C::Q_BOX + c * NQ * 128 + (kk % 4) * 32;
      wgmma_ss<T>(st, wgmma_desc(Ks + ka, 16, 1024), wgmma_desc(Qt + qb, 16, 1024), 1);
      wgmma_ss<T>(dpt, wgmma_desc(Vs + ka, 16, 1024), wgmma_desc(dOt + qb, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = c * NQ + j * 8 + 2 * tg + (e & 1);  // query row of the tile
        const int i = e >> 1;
        float p, ds;
        p_ds(st[j][e], dpt[j][e], lt[qc], dt[qc],
             visible(kv0 + rw + 8 * i, pt[qc], valid_r[i], causal, window), scale, logit_cap,
             p, ds);
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    // Both consumers need all of P^T and dS^T: each writes its query columns
    // as hi and lo in T into the exchange tiles (K-major, 128-byte swizzled:
    // the A operands of the next products), once both have finished reading
    // the last item's.
    bar_sync<1, 256>();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int chunk = c * NQ / 8 + j;  // the 16-byte chunk of columns 8 chunk .. 8 chunk + 7
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rw + 8 * i;
        const int off = r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * tg;
        const float p0 = st[j][2 * i], p1 = st[j][2 * i + 1];
        const float d0 = dpt[j][2 * i], d1 = dpt[j][2 * i + 1];
        *reinterpret_cast<uint32_t*>(Xs + off) = pack2<T>(p0, p1);
        *reinterpret_cast<uint32_t*>(Xs + C::X_TILE + off) =
            pack2<T>(p0 - round_to<T>(p0), p1 - round_to<T>(p1));
        *reinterpret_cast<uint32_t*>(Xs + 2 * C::X_TILE + off) = pack2<T>(d0, d1);
        *reinterpret_cast<uint32_t*>(Xs + 3 * C::X_TILE + off) =
            pack2<T>(d0 - round_to<T>(d0), d1 - round_to<T>(d1));
      }
    }
    fence_proxy_async();
    bar_sync<2, 256>();

    // dV += P^T dO and dK += dS^T Q over this consumer's half of D: BQ / 16
    // steps of 16 query rows, dO's and Q's rows read transposed
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const int half = (c * DH / 64) * C::Q_BOX + kk * 16 * 128;
      const uint64_t bo = wgmma_desc(dOt + half, C::Q_BOX, 1024);
      const uint64_t bq = wgmma_desc(Qt + half, C::Q_BOX, 1024);
      wgmma_ss_bt<T>(dv_acc, wgmma_desc(Xs + kk * 32, 16, 1024), bo, 1);
      wgmma_ss_bt<T>(dv_acc, wgmma_desc(Xs + C::X_TILE + kk * 32, 16, 1024), bo, 1);
      wgmma_ss_bt<T>(dk_acc, wgmma_desc(Xs + 2 * C::X_TILE + kk * 32, 16, 1024), bq, 1);
      wgmma_ss_bt<T>(dk_acc, wgmma_desc(Xs + 3 * C::X_TILE + kk * 32, 16, 1024), bq, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;
  auto kv_row = [&](T* base) {
    return [=](int i) -> T* {
      const int r = rw + 8 * i;
      return r < n_kv ? base + (kv_row0 + (size_t)r * KVH) * D + c * DH : nullptr;
    };
  };
  store_acc<T, DH>(dk_acc, kv_row(dk));
  store_acc<T, DH>(dv_acc, kv_row(dv));
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

// The backward's routes: float32 keeps the CUDA-core kernels at every head_dim
// (TF32 would not hold its tolerance); bf16 and fp16 take mma.sync at
// head_dim 64/96/128 and wgmma at 256.
enum class BwdRoute { kFma, kMmaSync, kWgmma };

template <typename T, int D>
constexpr BwdRoute bwd_route() {
  if (std::is_same<T, float>::value) return BwdRoute::kFma;
  return D == 256 ? BwdRoute::kWgmma : BwdRoute::kMmaSync;
}

// cudaFuncSetAttribute of `kernel`'s dynamic shared memory, once (`done`: a
// static of the caller's instantiation; this also keeps it out of graph capture).
template <typename K>
cudaError_t set_smem(bool& done, K kernel, size_t bytes) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  static bool smem_set = false;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* out = static_cast<const T*>(a.out_or_dout);
  const T* dout = static_cast<const T*>(a.dout_or_lse);
  const float* lse = static_cast<const float*>(a.lse_or_delta);
  T* dq = static_cast<T*>(a.o1);
  float* delta = static_cast<float*>(a.o2);
  cudaError_t err;
  if constexpr (bwd_route<T, D>() == BwdRoute::kWgmma) {
    using C = DqWg;
    if ((err = set_smem(smem_set, flash_bwd_dq_wg_kernel<T>, C::smem)) != cudaSuccess) return err;
    CUtensorMap q_map, k_map, v_map, do_map;
    if (!bshd_map<T>(&q_map, q, a.B, a.Sq, a.H, D, C::BM) ||
        !bshd_map<T>(&do_map, dout, a.B, a.Sq, a.H, D, C::BM) ||
        !bshd_map<T>(&k_map, k, a.B, a.Skv, a.KVH, D, C::BKV) ||
        !bshd_map<T>(&v_map, v, a.B, a.Skv, a.KVH, D, C::BKV))
      return cudaErrorInvalidValue;
    dim3 grid(a.H, a.B, (a.Sq + C::NC * C::BM - 1) / (C::NC * C::BM));
    flash_bwd_dq_wg_kernel<T><<<grid, C::NTH, C::smem, a.stream>>>(
        q_map, k_map, v_map, do_map, out, dout, lse, a.q_positions, a.kv_valid, dq, delta, a.Sq,
        a.Skv, a.H, a.KVH, a.scale, a.causal, a.window, a.cap);
  } else if constexpr (bwd_route<T, D>() == BwdRoute::kMmaSync) {
    using C = DqTc<T, D>;
    if ((err = set_smem(smem_set, flash_bwd_dq_tc_kernel<T, D>, C::smem)) != cudaSuccess)
      return err;
    dim3 grid(a.H, a.B, (a.Sq + C::BQ - 1) / C::BQ);
    flash_bwd_dq_tc_kernel<T, D><<<grid, C::NW * 32, C::smem, a.stream>>>(
        q, k, v, out, dout, lse, a.q_positions, a.kv_valid, dq, delta, a.Sq, a.Skv, a.H, a.KVH,
        a.scale, a.causal, a.window, a.cap);
  } else {
    constexpr size_t bytes = dq_smem_bytes<T, D>();
    if ((err = set_smem(smem_set, flash_bwd_dq_kernel<T, D>, bytes)) != cudaSuccess) return err;
    constexpr int BQ = DqTiles<D>::BQ;
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
        q, k, v, out, dout, lse, a.q_positions, a.kv_valid, dq, delta, a.Sq, a.Skv, a.H, a.KVH,
        a.scale, a.causal, a.window, a.cap);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  static bool smem_set = false;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.out_or_dout);
  const float* lse = static_cast<const float*>(a.dout_or_lse);
  const float* delta = static_cast<const float*>(a.lse_or_delta);
  T* dk = static_cast<T*>(a.o1);
  T* dv = static_cast<T*>(a.o2);
  cudaError_t err;
  if constexpr (bwd_route<T, D>() == BwdRoute::kWgmma) {
    using C = DkvWg;
    if ((err = set_smem(smem_set, flash_bwd_dkv_wg_kernel<T>, C::smem)) != cudaSuccess)
      return err;
    CUtensorMap q_map, k_map, v_map, do_map;
    if (!bshd_map<T>(&q_map, q, a.B, a.Sq, a.H, D, C::BQ) ||
        !bshd_map<T>(&do_map, dout, a.B, a.Sq, a.H, D, C::BQ) ||
        !bshd_map<T>(&k_map, k, a.B, a.Skv, a.KVH, D, C::BKV) ||
        !bshd_map<T>(&v_map, v, a.B, a.Skv, a.KVH, D, C::BKV))
      return cudaErrorInvalidValue;
    dim3 grid(a.KVH, a.B, (a.Skv + C::BKV - 1) / C::BKV);
    flash_bwd_dkv_wg_kernel<T><<<grid, C::NTH, C::smem, a.stream>>>(
        q_map, k_map, v_map, do_map, lse, delta, a.q_positions, a.kv_valid, dk, dv, a.Sq, a.Skv,
        a.H, a.KVH, a.scale, a.causal, a.window, a.cap);
  } else if constexpr (bwd_route<T, D>() == BwdRoute::kMmaSync) {
    using C = DkvTc<T, D>;
    if ((err = set_smem(smem_set, flash_bwd_dkv_tc_kernel<T, D>, C::smem)) != cudaSuccess)
      return err;
    dim3 grid(a.KVH, a.B, (a.Skv + C::BKV - 1) / C::BKV);
    flash_bwd_dkv_tc_kernel<T, D><<<grid, C::NW * 32, C::smem, a.stream>>>(
        q, k, v, dout, lse, delta, a.q_positions, a.kv_valid, dk, dv, a.Sq, a.Skv, a.H, a.KVH,
        a.scale, a.causal, a.window, a.cap);
  } else {
    constexpr size_t bytes = dkv_smem_bytes<T, D>();
    if ((err = set_smem(smem_set, flash_bwd_dkv_kernel<T, D>, bytes)) != cudaSuccess) return err;
    constexpr int BKV = DkvTiles<D>::BKV;
    dim3 grid((a.Skv + BKV - 1) / BKV, a.KVH, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
        q, k, v, dout, lse, delta, a.q_positions, a.kv_valid, dk, dv, a.Sq, a.Skv, a.H, a.KVH,
        a.scale, a.causal, a.window, a.cap);
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
