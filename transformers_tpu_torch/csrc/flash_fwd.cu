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
// ~1 GFLOP of the causal half, so the bound is bytes (~6 us); at the training
// shape (4 rows of 2048, 32 heads over 8 kv heads) the causal forward does
// ~1.3e11 operations on ~0.1 GB, so the bound is operations (~0.13 ms at 989
// TFLOP/s): only the tensor cores can approach it. At Gemma-3-12B's prefill
// (4 left-padded rows of 1536, 16 heads over 8, D = 256) the causal forward
// does ~6.7e10 operations (~6.1e10 under the 1024 window) on ~0.1 GB:
// operations bound it (~0.07 ms), and at 67 TFLOP/s of f32 FMAs it could not
// come under ~1 ms.
//
// Three routes, chosen by fwd_route (below) from the storage type and D:
//
// bf16 and fp16 at head_dim 64, 96 (Phi-3: 6 x 16, the mma fragments' depth)
// and 128 take the tensor-core kernel
// (flash_fwd_tc_kernel), the loop of the backward's dQ kernel with an online
// softmax: one block of 4 warps owns 64 query rows of one (batch, head), 16
// rows a warp, and walks the kv tiles of 64 slots that some row of it sees,
// heaviest query tiles first. Q is copied once and its mma.sync m16n8k16 A
// fragments stay in registers; K and V tiles arrive by cp.async into two
// stages (the next tile's copy overlaps this one's products) with rows padded
// by 16 bytes, and are read by ldmatrix (V through ldmatrix.trans). S = Q K^T
// accumulates in f32 registers; the row max m and sum l stay f32 in the
// registers of the 4 threads that hold a row (scores in log2 units, so each
// exp is one exp2). P = exp(s - m) goes from the S accumulators straight into
// the A fragments of O += P V, rounded once to the storage type, as the
// Pallas kernel rounds it (p.astype(v.dtype)); l sums the f32 P. A warp
// skips the products of a tile that none of its 16 rows sees, and the mask of
// a tile that all its live rows see whole. The Q tile's copy lands in the
// second K stage, which is refilled only after Q is in registers.
//
// bf16 and fp16 at head_dim 256 (Gemma, Gemma-2, Gemma-3) take the Hopper
// kernel (flash_fwd_wg_kernel, helpers in wgmma.cuh): at D = 256 a warp's 16
// rows of O take 128 f32 registers a thread, and the mma.sync route's Q
// fragments would take 64 more. Here Q never enters the registers: the
// products read their operands from shared memory by descriptor (wgmma). A
// block is one producer warpgroup and two consumer warpgroups of 64 query
// rows each, one head's 128 rows (giving them the two query heads of one kv
// head at the same 64 rows measured 6% slower: PERF.md). One producer thread
// issues TMA loads: the block's Q tiles once, then K and V tiles of 64
// slots into a ring of two stages, each with full barriers (K with the
// tile's kv_valid flags, which the producer warp stores; V) and an empty
// barrier that every consumer warp arrives on. Tiles are 128-byte swizzled
// boxes from 4-d tensor maps over the BSHD tensors, whose zero fill covers
// the ragged ends of Sq and Skv. A consumer computes S = Q K^T as 16
// wgmma m64n64k16 from shared memory (f32 in 32 registers a thread, laid
// out as mma.sync's accumulators), then the same mask, softcap and online
// softmax as flash_fwd_tc_kernel, and O += P V as 4 wgmma m64n256k16 with P
// from registers (rounded once to the storage type) and V read transposed
// from shared memory, O in 128 f32 registers. setmaxnreg moves registers
// from the producer (40) to the consumers (232). The block's kv range skips
// the tiles that causality or the window hide from all its rows; a consumer
// skips the products of a tile that none of its 64 rows sees (wgmma works a
// warpgroup at a time), and a warp the mask of a tile its rows see whole.
// Query tiles run heaviest first. Shared memory: Q 64 KB, K and V 2 x 64
// KB: one block an SM.
//
// float32 (TF32 would not hold its tolerance) keeps the CUDA-core FMA kernel
// (flash_fwd_kernel) at every head_dim: one block of 256 threads per
// (batch, head, 64-row query tile) keeps Q, a 64-slot K tile and V tile in
// shared memory in the storage type (rows padded by two elements so the
// column-parallel reads of K hit distinct banks), each thread computes a
// 4 x 4 block of scores and a 4-row slice of the output from register
// tiles, and the f32 running max / sum live in shared memory per row. On
// every route, KV tiles that causality or the window mask for every row of
// the query tile are never loaded.

#include "wgmma.cuh"

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

// ------------------------------------------------------------ tensor cores
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22; 0 at -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
struct FwdTc {
  static constexpr int NW = 4;        // warps, 16 query rows each
  static constexpr int BQ = 16 * NW;  // query rows per block
  static constexpr int BKV = 64;      // kv slots per tile
  static constexpr int S = D + kPad;  // shared row stride
  static_assert(BQ <= 2 * BKV, "the Q tile is copied into the K stages");
  static constexpr size_t smem = (size_t)4 * BKV * S * sizeof(T) +         // K, V x 2 (Q in K's)
                                 (size_t)(BQ + 2 * BKV + 2) * sizeof(int);  // qpos, valid x 2, range
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdTc<T, D>::NW * 32)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_positions, const int* __restrict__ kv_valid,
                    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H,
                    int KVH, float scale, int causal, int window, float logit_cap) {
  using C = FwdTc<T, D>;
  constexpr int NW = C::NW, BQ = C::BQ, BKV = C::BKV, S = C::S;
  constexpr int NTH = NW * 32, NT = BKV / 8, DT = D / 8;
  const float NEG_INF = -CUDART_INF_F;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [2][BKV][S]; the Q tile first lands in stage 1
  T* Vs = Ks + 2 * BKV * S;            // [2][BKV][S]
  int* qpos_s = reinterpret_cast<int*>(Vs + 2 * BKV * S);
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

  if (tid < BQ) qpos_s[tid] = tid < n_rows ? q_positions[(size_t)b * Sq + q0 + tid] : 0;
  __syncthreads();
  row_range(qpos_s, n_rows, range_s);
  __syncthreads();
  // kv tiles outside [kv_begin, kv_end) are masked for every row of this tile
  const int kv_begin = window > 0 ? max(0, (range_s[0] - window + 1) / BKV) * BKV : 0;
  const int kv_end = causal ? min(Skv, range_s[1] + 1) : Skv;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  // this thread's two query rows: gr and gr + 8 of the warp's 16
  const int rw = w * 16 + gr;
  const bool live_r[2] = {rw < n_rows, rw + 8 < n_rows};
  const int qp_r[2] = {qpos_s[rw], qpos_s[rw + 8]};
  // the range of the warp's live rows, for skipping the tiles none of them sees
  int w_lo = 0x7fffffff, w_hi = -0x7fffffff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (live_r[i]) {
      w_lo = min(w_lo, qp_r[i]);
      w_hi = max(w_hi, qp_r[i]);
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // row max of the scores in log2 units
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float scale_log2 = scale * kLog2e;

  if (n_tiles > 0) {
    auto load_kv = [&](int t, int stage) {
      const int kv0 = kv_begin + t * BKV;
      const size_t kv_row0 = ((size_t)b * Skv + kv0) * KVH + kvh;
      const int n_kv = min(BKV, Skv - kv0);
      cp_rows<T, D, BKV, NTH>(Ks + stage * BKV * S, k + kv_row0 * D, (size_t)KVH * D, n_kv);
      cp_rows<T, D, BKV, NTH>(Vs + stage * BKV * S, v + kv_row0 * D, (size_t)KVH * D, n_kv);
      cp_vals<BKV>(valid_s + stage * BKV, kv_valid + (size_t)b * Skv + kv0, n_kv);
      cp_async_commit();
    };
    // Q lands in the last BQ rows of the K stages (stage 1 when BQ <= BKV,
    // which tile 0's copy into stage 0 then overlaps)
    T* Qs = Ks + (2 * BKV - BQ) * S;
    cp_rows<T, D, BQ, NTH>(Qs, q + row0 * D, (size_t)H * D, n_rows);
    cp_async_commit();
    if constexpr (BQ <= BKV) load_kv(0, 0);
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[D / 16][4];  // the warp's 16 rows of Q as A fragments
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qf[kk], Qs + (w * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
    __syncthreads();  // the K stages are refilled below
    if constexpr (BQ > BKV) load_kv(0, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t & 1;
      if (t + 1 < n_tiles) {
        load_kv(t + 1, stage ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kv0 = kv_begin + t * BKV;
      const bool seen = w_lo <= w_hi && !(causal && kv0 > w_hi) &&
                        !(window > 0 && kv0 + BKV - 1 <= w_lo - window);
      if (seen) {  // warp-uniform
        const T* Kt = Ks + stage * BKV * S;
        const T* Vt = Vs + stage * BKV * S;
        const int* vt = valid_s + stage * BKV;

        // S = Q K^T for the warp's 16 rows
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * S + kk * 16 +
                            ((lane >> 3) & 1) * 8);
            mma16816<T>(s[2 * np], qf[kk], bk[0], bk[1]);
            mma16816<T>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          }
        }
        // scale and softcap, in log2 units; the mask, unless every slot of the
        // tile is visible to every live row of the warp; the tile's row max
        // over the 4 threads of a row
        const bool all_valid = __all_sync(0xffffffffu, vt[lane] != 0 && vt[lane + 32] != 0);
        const bool full = all_valid && (!causal || kv0 + BKV - 1 <= w_lo) &&
                          (window <= 0 || kv0 > w_hi - window);
        float mx[2] = {NEG_INF, NEG_INF};
        auto score = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = j * 8 + 2 * tg + (e & 1);
              const int i = e >> 1;
              float x = logit_cap > 0.f
                            ? logit_cap * tanhf(s[j][e] * scale / logit_cap) * kLog2e
                            : s[j][e] * scale_log2;
              if (decltype(masked)::value && !visible(kv0 + c, qp_r[i], vt[c], causal, window))
                x = NEG_INF;
              s[j][e] = x;
              mx[i] = fmaxf(mx[i], x);
            }
          }
        };
        if (full) {
          score(std::false_type{});
        } else {
          score(std::true_type{});
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_r[i], mx[i]);
          alpha[i] = m_new == NEG_INF ? 1.f : fast_exp2(m_r[i] - m_new);  // 0 when m was -inf
          m_r[i] = m_new;
          l_r[i] *= alpha[i];
        }
        // P in place of S (exactly 0 where masked)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = m_r[i] == NEG_INF ? 0.f : fast_exp2(s[j][e] - m_r[i]);
            s[j][e] = p;
            l_r[i] += p;
          }
        }
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {  // a row max moved
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            acc[j][0] *= alpha[0];
            acc[j][1] *= alpha[0];
            acc[j][2] *= alpha[1];
            acc[j][3] *= alpha[1];
          }
        }
        // O += P V, P rounded once to T
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          uint32_t a[4];
          acc_to_a<T, NT>(s, kk, a);
#pragma unroll
          for (int dp2 = 0; dp2 < D / 16; ++dp2) {
            uint32_t bv[4];
            ldsm_x4_t(bv, Vt + (kk * 16 + (lane & 15)) * S + dp2 * 16 + (lane >> 4) * 8);
            mma16816<T>(acc[2 * dp2], a, bv[0], bv[1]);
            mma16816<T>(acc[2 * dp2 + 1], a, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // this stage is refilled in the next iteration
    }
  }

  // normalise and write; the row sums are summed over the row's 4 threads
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] *= inv[0];
    acc[j][1] *= inv[0];
    acc[j][2] *= inv[1];
    acc[j][3] *= inv[1];
  }
  store_acc<T, D>(acc, [&](int i) -> T* {
    return live_r[i] ? out + (row0 + (size_t)(rw + 8 * i) * H) * D : nullptr;
  });
  if (tg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (live_r[i])
        lse[((size_t)b * H + h) * Sq + q0 + rw + 8 * i] =
            l_r[i] > 0.f ? (m_r[i] + log2f(l_r[i])) * kLn2 : NEG_INF;
    }
  }
}

// ------------------------------------------- head_dim 256: wgmma and TMA
// One block of three warpgroups: warpgroup 0 is the producer (one of its
// warps issues every TMA load), warpgroups 1 and 2 are consumers of 64 query
// rows each, rows [0, 64) and [64, 128) of one head's 128.
struct FwdWg {
  static constexpr int D = 256;
  static constexpr int BM = 64;          // query rows of a consumer warpgroup
  static constexpr int BKV = 64;         // kv slots per tile
  static constexpr int NC = 2;           // consumer warpgroups
  static constexpr int NTH = 128 * (NC + 1);
  static constexpr int STAGES = 2;       // K/V ring
  static constexpr int BOX = 64 * 128;   // bytes of one 64-row x 64-element box
  static constexpr int TILE = D / 64 * BOX;  // 64 rows x 256: 32 KB
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NC * TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int VALID_OFF = V_OFF + STAGES * TILE;      // int [STAGES][BKV]
  static constexpr int QPOS_OFF = VALID_OFF + STAGES * BKV * 4;  // int [NC * BM]
  static constexpr int RANGE_OFF = QPOS_OFF + NC * BM * 4;       // int [2 (NC + 1)]
  static constexpr int BAR_OFF = RANGE_OFF + 8 * 4;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr size_t smem = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;  // + alignment
  static_assert(BAR_OFF % 8 == 0 && 2 * (NC + 1) <= 8, "shared layout");
};

template <typename T>
__global__ void __launch_bounds__(FwdWg::NTH, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, Sq, H, D]
                    const __grid_constant__ CUtensorMap k_map,  // [B, Skv, KVH, D]
                    const __grid_constant__ CUtensorMap v_map,  // [B, Skv, KVH, D]
                    const int* __restrict__ q_positions, const int* __restrict__ kv_valid,
                    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H,
                    int KVH, float scale, int causal, int window, float logit_cap) {
  using C = FwdWg;
  constexpr int D = C::D, BM = C::BM, BKV = C::BKV, NC = C::NC, NT = BKV / 8, DT = D / 8;
  const float NEG_INF = -CUDART_INF_F;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int* valid_s = reinterpret_cast<int*>(smem + C::VALID_OFF);
  int* qpos_s = reinterpret_cast<int*>(smem + C::QPOS_OFF);
  int* range_s = reinterpret_cast<int*>(smem + C::RANGE_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* empty = v_full + C::STAGES;

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
      mbar_init(&k_full[s], 32);      // the producer warp (its valid flags) + K's bytes
      mbar_init(&v_full[s], 1);       // V's bytes
      mbar_init(&empty[s], NC * 4);   // every consumer warp
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
    // ---- producer: Q once, then K and V tiles into the ring
    regs_dec<40>();
    if (tid >= 32) return;
    unsigned char* Qs = smem + C::Q_OFF;
    unsigned char* Ks = smem + C::K_OFF;
    unsigned char* Vs = smem + C::V_OFF;
    if (n_tiles > 0 && lane == 0) {
      mbar_arrive_expect_tx(q_full, NC * C::TILE);
      for (int c = 0; c < NC; ++c)
        for (int i = 0; i < D / 64; ++i)
          tma_load_4d(Qs + c * C::TILE + i * C::BOX, &q_map, q_full, 64 * i, h, row0_of(c), b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::STAGES;
      mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
      const int kv0 = kv_begin + t * BKV;
      for (int i = lane; i < BKV; i += 32)
        valid_s[s * BKV + i] = kv0 + i < Skv ? kv_valid[(size_t)b * Skv + kv0 + i] : 0;
      if (lane == 0) {
        mbar_arrive_expect_tx(&k_full[s], C::TILE);
        for (int i = 0; i < D / 64; ++i)
          tma_load_4d(Ks + s * C::TILE + i * C::BOX, &k_map, &k_full[s], 64 * i, kvh, kv0, b);
        mbar_arrive_expect_tx(&v_full[s], C::TILE);
        for (int i = 0; i < D / 64; ++i)
          tma_load_4d(Vs + s * C::TILE + i * C::BOX, &v_map, &v_full[s], 64 * i, kvh, kv0, b);
      } else {
        mbar_arrive(&k_full[s]);
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
  // this thread's two query rows: gr and gr + 8 of the warp's 16
  const int rw = w * 16 + gr;
  const bool live_r[2] = {rw < n_rows, rw + 8 < n_rows};
  const int qp_r[2] = {qpos_s[c * BM + rw], qpos_s[c * BM + rw + 8]};
  // the range of the warp's live rows, for the mask's whole-tile shortcut
  int w_lo = 0x7fffffff, w_hi = -0x7fffffff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (live_r[i]) {
      w_lo = min(w_lo, qp_r[i]);
      w_hi = max(w_hi, qp_r[i]);
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // row max of the scores in log2 units
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float scale_log2 = scale * kLog2e;
  const unsigned char* Qs = smem + C::Q_OFF + c * C::TILE;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t parity = (t / C::STAGES) & 1;
    const int kv0 = kv_begin + t * BKV;
    mbar_wait(&k_full[s], parity);
    // warpgroup-uniform: a tile that none of the consumer's rows sees
    const bool seen = wg_lo <= wg_hi && !(causal && kv0 > wg_hi) &&
                      !(window > 0 && kv0 + BKV - 1 <= wg_lo - window);
    if (seen) {
      const unsigned char* Kt = smem + C::K_OFF + s * C::TILE;
      const unsigned char* Vt = smem + C::V_OFF + s * C::TILE;
      const int* vt = valid_s + s * BKV;

      // S = Q K^T: 16 steps of 16 over D, 4 to a 128-byte box
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * C::BOX + (kk % 4) * 32;
        wgmma_ss<T>(sc, wgmma_desc(Qs + off, 16, 1024), wgmma_desc(Kt + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale and softcap, in log2 units; the mask, unless every slot of the
      // tile is visible to every live row of the warp; the tile's row max
      // over the 4 threads of a row
      const bool all_valid = __all_sync(0xffffffffu, vt[lane] != 0 && vt[lane + 32] != 0);
      const bool full = all_valid && (!causal || kv0 + BKV - 1 <= w_lo) &&
                        (window <= 0 || kv0 > w_hi - window);
      float mx[2] = {NEG_INF, NEG_INF};
      auto score = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * tg + (e & 1);
            const int i = e >> 1;
            float x = logit_cap > 0.f
                          ? logit_cap * tanhf(sc[j][e] * scale / logit_cap) * kLog2e
                          : sc[j][e] * scale_log2;
            if (decltype(masked)::value && !visible(kv0 + col, qp_r[i], vt[col], causal, window))
              x = NEG_INF;
            sc[j][e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      };
      if (full) {
        score(std::false_type{});
      } else {
        score(std::true_type{});
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = m_new == NEG_INF ? 1.f : fast_exp2(m_r[i] - m_new);  // 0 when m was -inf
        m_r[i] = m_new;
        l_r[i] *= alpha[i];
      }
      // P in place of S (exactly 0 where masked), then as P's A fragments,
      // rounded once to T
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = m_r[i] == NEG_INF ? 0.f : fast_exp2(sc[j][e] - m_r[i]);
          sc[j][e] = p;
          l_r[i] += p;
        }
      }
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) acc_to_a<T, NT>(sc, kk, pa[kk]);
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {  // a row max moved
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
      }

      // O += P V: 4 steps of 16 slots, V's rows read transposed
      mbar_wait(&v_full[s], parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<T>(acc, pa[kk], wgmma_desc(Vt + kk * 16 * 128, C::BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      mbar_wait(&v_full[s], parity);  // the stage is released only once both loads landed
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // normalise and write; the row sums are summed over the row's 4 threads
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] *= inv[0];
    acc[j][1] *= inv[0];
    acc[j][2] *= inv[1];
    acc[j][3] *= inv[1];
  }
  const size_t row0 = ((size_t)b * Sq + q0) * H + h;  // row index of (b, q0, h)
  store_acc<T, D>(acc, [&](int i) -> T* {
    return live_r[i] ? out + (row0 + (size_t)(rw + 8 * i) * H) * D : nullptr;
  });
  if (tg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (live_r[i])
        lse[((size_t)b * H + h) * Sq + q0 + rw + 8 * i] =
            l_r[i] > 0.f ? (m_r[i] + log2f(l_r[i])) * kLn2 : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------- launch
// The forward's routes (the backward's: bwd_route in flash_bwd.cu):
// float32 keeps the CUDA-core kernel (TF32 would not hold its tolerance);
// bf16 and fp16 take mma.sync at head_dim 64/96/128 and wgmma at 256.
enum class FwdRoute { kFma, kMmaSync, kWgmma };

template <typename T, int D>
constexpr FwdRoute fwd_route() {
  if (std::is_same<T, float>::value) return FwdRoute::kFma;
  return D == FwdWg::D ? FwdRoute::kWgmma : FwdRoute::kMmaSync;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_positions,
                   const int* kv_valid, void* out, float* lse, int B, int Sq, int Skv, int H,
                   int KVH, float scale, int causal, int window, float logit_cap,
                   cudaStream_t stream) {
  static bool smem_set = false;  // once per instantiation (also keeps it out of graph capture)
  if constexpr (fwd_route<T, D>() == FwdRoute::kWgmma) {
    using C = FwdWg;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_wg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    CUtensorMap q_map, k_map, v_map;
    if (!bshd_map<T>(&q_map, q, B, Sq, H, C::D, C::BM) ||
        !bshd_map<T>(&k_map, k, B, Skv, KVH, C::D, C::BKV) ||
        !bshd_map<T>(&v_map, v, B, Skv, KVH, C::D, C::BKV))
      return cudaErrorInvalidValue;
    dim3 grid(H, B, (Sq + C::NC * C::BM - 1) / (C::NC * C::BM));
    flash_fwd_wg_kernel<T><<<grid, C::NTH, C::smem, stream>>>(
        q_map, k_map, v_map, q_positions, kv_valid, static_cast<T*>(out), lse, Sq, Skv, H, KVH,
        scale, causal, window, logit_cap);
  } else if constexpr (fwd_route<T, D>() == FwdRoute::kMmaSync) {
    using C = FwdTc<T, D>;
    if (!smem_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
    flash_fwd_tc_kernel<T, D><<<grid, C::NW * 32, C::smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        q_positions, kv_valid, static_cast<T*>(out), lse, Sq, Skv, H, KVH, scale, causal,
        window, logit_cap);
  } else {
    constexpr size_t bytes = smem_bytes<T, D>();
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
  }
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
    case 96:
      return launch<T, 96>(q, k, v, qp, kv, out, lse, B, Sq, Skv, H, KVH, scale, causal,
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
