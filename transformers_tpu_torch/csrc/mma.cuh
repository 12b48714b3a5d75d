// Building blocks of the flash kernels (flash_fwd.cu: K1; flash_bwd.cu: K4,
// K5): the sm_80 warp-level tensor-core instructions (mma.sync m16n8k16 with
// f32 accumulate, ldmatrix), cp.async tile copies, the accumulator store, and
// the attention mask as data; and the split-KV decode blocks' per-warp
// scoring and merge, shared by paged_decode.cu (K6) and fused_decode.cu (K2,
// K7).
#pragma once

#include <type_traits>

#include "common.cuh"

// Fragment layouts (PTX ISA): with g = lane / 4 and t = lane % 4, an A
// fragment (16 x 16) holds rows g, g + 8 and column pairs 2t, 2t + 8; a B
// fragment (16 x 8) k pairs 2t, 2t + 8 of column g; the f32 accumulator
// (16 x 8) rows g, g + 8, column pair 2t.

constexpr int kPad = 8;  // elements of padding per shared row

// The flash backward's route (flash_bwd.cu, K4 and K5): bf16 and fp16 at
// head_dim <= 128 take the mma.sync kernels; float32 (TF32 would not hold its
// tolerance) and head_dim 256 (a warp's dK/dV rows would not fit its
// registers) take the CUDA-core ones. The forward has its own (fwd_route in
// flash_fwd.cu).
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

// ------------------------------------------------- split-KV decode (K2, K6, K7)
// A decode block of NW warps owns one split of one (row, kv head)'s slots
// and up to GB (<= 8) of that kv head's query heads. The split's K and V rows
// are copied in stages of 8 slots a warp (rows padded by kPad); each warp
// scores its 8 slots of a stage. In bf16/fp16 the scores are one mma.sync
// m16n8k16 tile per 16 of D (q as the A rows g < GB, K by ldmatrix as B:
// exact products, f32 sums); in f32 a lane holds D / 32 elements of a slot's
// row and each score is a warp sum. The softmax and P.V stay in f32 on the
// CUDA cores: a lane holds D / 32 elements of each head's output and takes
// each slot's probability from the lane that scored it.

// One warp's query fragments and online-softmax state over the block's GB
// query heads: m (every head, in every lane) and the P.V sums of this lane's
// elements; l per head in every lane (f32 route) or, on the tensor-core
// route, this thread's share of head g's sum (m_own: m[g]), g = lane / 4.
template <typename T, int D, int GB>
struct DecodeWarp {
  static constexpr bool kTc = !std::is_same<T, float>::value;  // scores on the tensor cores
  static constexpr int E = D / 32;                             // elements per lane
  static_assert(GB <= 8, "a block's query heads are the rows g < 8 of an mma tile");
  uint32_t qa[kTc ? D / 16 : 1][2];  // q as mma A fragments (rows g < GB; 8-15 zero)
  float qf[kTc ? 1 : GB][E];         // this lane's E elements of each head
  float m[GB], l[GB], acc[GB][E];
  float m_own, l_own;
};

// q rows q_heads + gi * D, gi < n_heads (global or shared memory), into the
// warp's fragments; the state starts empty.
template <typename T, int D, int GB>
__device__ __forceinline__ void decode_init(DecodeWarp<T, D, GB>& st, const T* q_heads,
                                            int n_heads) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tg = lane & 3;
  if constexpr (DecodeWarp<T, D, GB>::kTc) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* row = q_heads + gr * D + kk * 16 + 2 * tg;
      st.qa[kk][0] = gr < n_heads ? *reinterpret_cast<const uint32_t*>(row) : 0u;
      st.qa[kk][1] = gr < n_heads ? *reinterpret_cast<const uint32_t*>(row + 8) : 0u;
    }
  } else {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (gi < n_heads) {
        load_f<T, E>(q_heads + gi * D + lane * E, st.qf[gi]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) st.qf[gi][e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    st.m[gi] = -CUDART_INF_F;
    st.l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[gi][e] = 0.f;
  }
  st.m_own = -CUDART_INF_F;
  st.l_own = 0.f;
}

// Folds the warp's slots u < nw (at most 8; Kt and Vt point at the first one's
// rows in a stage of row stride D + kPad) into its state. With kHoles, only
// the slots u with live[u] != 0 (K2's kv_valid flags of those slots); a head
// that has seen no live slot keeps m = -inf, l = 0, acc = 0. Without, every
// slot u < nw is live and live is not read.
template <bool kHoles, typename T, int D, int GB>
__device__ __forceinline__ void decode_attend8(DecodeWarp<T, D, GB>& st, const T* Kt,
                                               const T* Vt, int nw, const int* live,
                                               float scale) {
  constexpr int E = D / 32;
  constexpr int S = D + kPad;
  const float NEG_INF = -CUDART_INF_F;
  const int lane = threadIdx.x & 31, tg = lane & 3;
  const int d0 = lane * E;
  if (nw <= 0) return;
  if constexpr (DecodeWarp<T, D, GB>::kTc) {
    // S = q K^T: rows g < GB (heads) by the warp's 8 slots
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk2 = 0; kk2 < D / 32; ++kk2) {
      uint32_t b[4];
      ldsm_x4(b, Kt + (lane & 7) * S + kk2 * 32 + (lane >> 3) * 8);
      const uint32_t a0[4] = {st.qa[2 * kk2][0], 0u, st.qa[2 * kk2][1], 0u};
      const uint32_t a1[4] = {st.qa[2 * kk2 + 1][0], 0u, st.qa[2 * kk2 + 1][1], 0u};
      mma16816<T>(sc, a0, b[0], b[1]);
      mma16816<T>(sc, a1, b[2], b[3]);
    }
    // head g's scores of slots 2 tg and 2 tg + 1; its max over the 8
    float x[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = 2 * tg + i;
      x[i] = u < nw && (!kHoles || live[u] != 0) ? sc[i] * scale : NEG_INF;
    }
    float mx = fmaxf(x[0], x[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_own_new = fmaxf(st.m_own, mx);  // without holes slot 0 is live: finite
    float p[2] = {0.f, 0.f};
    if (!kHoles || m_own_new != NEG_INF) {  // head g has seen a live slot
      st.l_own *= expf(st.m_own - m_own_new);
      st.m_own = m_own_new;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = expf(x[i] - st.m_own);
        st.l_own += p[i];
      }
    }
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      const float m_new = fmaxf(st.m[gi], __shfl_sync(0xffffffffu, mx, 4 * gi));
      if (kHoles && m_new == NEG_INF) continue;  // the same in every lane
      const float alpha = expf(st.m[gi] - m_new);  // 0 when m was -inf
#pragma unroll
      for (int e = 0; e < E; ++e) st.acc[gi][e] *= alpha;
      st.m[gi] = m_new;
    }
    // P.V in f32: slot u's probability for head gi comes from lane 4 gi + u / 2
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u >= nw) break;
      float vf[E];
      load_f<T, E>(Vt + u * S + d0, vf);
      const float mine = (u & 1) ? p[1] : p[0];
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        const float pv = __shfl_sync(0xffffffffu, mine, 4 * gi + (u >> 1));
#pragma unroll
        for (int e = 0; e < E; ++e) st.acc[gi][e] = fmaf(pv, vf[e], st.acc[gi][e]);
      }
    }
  } else {
    // f32: a lane holds E elements of a slot row; each score is a warp sum
#pragma unroll
    for (int u0 = 0; u0 < 8; u0 += 4) {
      if (u0 >= nw) break;
      float sv[4][GB];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // the same for every lane of the warp
        const bool ok = u0 + u < nw && (!kHoles || live[u0 + u] != 0);
        float kf[E];
        if (ok) load_f<T, E>(Kt + (u0 + u) * S + d0, kf);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          float part = 0.f;
          if (ok) {
#pragma unroll
            for (int e = 0; e < E; ++e) part = fmaf(st.qf[gi][e], kf[e], part);
          }
          sv[u][gi] = ok ? warp_sum(part) * scale : NEG_INF;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float mx = st.m[gi];
#pragma unroll
        for (int u = 0; u < 4; ++u) mx = fmaxf(mx, sv[u][gi]);
        if (kHoles && mx == NEG_INF) continue;  // no live slot yet (warp-uniform)
        // 0 when m was -inf; without holes slot u0 is live
        const float alpha = expf(st.m[gi] - mx);
        st.l[gi] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) st.acc[gi][e] *= alpha;
        st.m[gi] = mx;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u0 + u >= nw) break;
        if (kHoles && live[u0 + u] == 0) continue;
        float vf[E];
        load_f<T, E>(Vt + (u0 + u) * S + d0, vf);
#pragma unroll
        for (int gi = 0; gi < GB; ++gi) {
          const float pv = expf(sv[u][gi] - st.m[gi]);
          st.l[gi] += pv;
#pragma unroll
          for (int e = 0; e < E; ++e) st.acc[gi][e] = fmaf(pv, vf[e], st.acc[gi][e]);
        }
      }
    }
  }
}

// The block's merge of its NW warps' states, in warp order.
template <int GB, int NW>
struct DecodeMergeSmem {
  float m[NW][GB];
  float l[NW][GB];
  float f[NW][GB];  // each warp's weight in the block's merge
  float ml[GB][2];  // the block's (m, l) per query head
};

// Stores every warp's state (acc into sm_acc, [NW][GB][D] floats over the
// spent stages) and forms each head's block max m, the warps' weights
// exp(m_w - m) and the block sum l; m starts from m_start(gi) (-inf: none).
// Ends synchronised; decode_block_acc then gives the block's P.V sums.
template <typename T, int D, int GB, int NW, typename MStart>
__device__ __forceinline__ void decode_block_merge(const DecodeWarp<T, D, GB>& st, float* sm_acc,
                                                   DecodeMergeSmem<GB, NW>& sm, MStart m_start) {
  constexpr int E = D / 32;
  const float NEG_INF = -CUDART_INF_F;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  if constexpr (DecodeWarp<T, D, GB>::kTc) {
    float l_own = st.l_own;
    l_own += __shfl_xor_sync(0xffffffffu, l_own, 1);
    l_own += __shfl_xor_sync(0xffffffffu, l_own, 2);
    if (tg == 0 && gr < GB) sm.l[w][gr] = l_own;
  } else if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) sm.l[w][gi] = st.l[gi];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) sm.m[w][gi] = st.m[gi];
  }
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    store_f<float, E>(sm_acc + (w * GB + gi) * D + lane * E, st.acc[gi]);
  }
  __syncthreads();
  if (tid < GB) {
    float mx = m_start(tid);
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) mx = fmaxf(mx, sm.m[ww][tid]);
    float L = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float f = sm.m[ww][tid] == NEG_INF ? 0.f : expf(sm.m[ww][tid] - mx);
      sm.f[ww][tid] = f;
      L = fmaf(sm.l[ww][tid], f, L);
    }
    sm.ml[tid][0] = mx;
    sm.ml[tid][1] = L;
  }
  __syncthreads();
}

// Element d of head gi of the block's merged P.V sum.
template <int D, int GB, int NW>
__device__ __forceinline__ float decode_block_acc(const float* sm_acc,
                                                  const DecodeMergeSmem<GB, NW>& sm, int gi,
                                                  int d) {
  float A = 0.f;
#pragma unroll
  for (int ww = 0; ww < NW; ++ww) A = fmaf(sm_acc[(ww * GB + gi) * D + d], sm.f[ww][gi], A);
  return A;
}
