// Fused single-token decode step: rotate-half rope on q and the new key,
// attention over the bhsd cache slots [start, pos) that kv_valid marks live
// plus the new token's own column, and the write of the roped key and the
// value into cache slot `pos`.
//
// Replaces transformers_tpu/ops/pallas/fused_decode.py
// (fused_decode_attention: _fused_decode_kernel_whole and the chunked,
// double-buffered _fused_decode_kernel) with one kernel for both.
//
// Bound on the H100: bytes. A step reads each live cache slot's key and value
// once (2 * D * sizeof(T) per slot, per batch row and kv head) and does 4 * G
// * D operations per slot, about one operation per byte, far below the card's
// ~295 operations per byte. The design therefore reads every K/V byte once:
// one block owns one (batch row, kv head) and holds up to GB = 4 of that kv
// head's G query heads, so a GQA group shares the stream (G > 4 takes
// ceil(G / 4) blocks per kv head). Each warp walks its own interleaved share
// of the slots with coalesced vector loads (a lane holds D / 32 neighbouring
// elements of a row), keeps a float online softmax, and the warps' partial
// states are merged in shared memory at the end, where the new token's column
// is scored last. The cache write happens here, not in a separate pass: the
// slot loop reads only slots < pos, and the block that writes slot pos of a
// (row, kv head) is the only one that owns it.
//
// Rope rounds once to the storage type, as the Pallas kernel does: f32 math
// on the T-valued q, k and cos/sin, then one cast to T. Probabilities stay in
// f32 for the P.V product (the Pallas kernel casts them to T first).
//
// K7, static_decode_kernel, is a second mode of the same slot loop: the
// static-cache decode of transformers_tpu/ops/pallas/decode_attention.py
// (decode_attention / _decode_kernel). Its cache is BSHD [B, S, KVH, D] (a
// slot stride of KVH * D, against K2's D), each row reads its live slots
// [valid_start, valid_end) (start = max(start, end - window) under a sliding
// window), and there is no rope, no new-token column and no cache write; a
// row with end <= start gives zeros. The Pallas kernel clamps its block
// index map so dead blocks cost no DMA; here a warp simply never loads a
// dead slot. Bound: bytes, 2 * D * sizeof(T) per live slot per (row, kv
// head), at one operation per byte or so, like K2.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kGB = 4;     // query heads per block
constexpr int kU = 4;      // slots each warp has in flight per iteration

// Float online-softmax state of one warp over the block's kGB query heads;
// a lane holds E = D / 32 neighbouring elements of each head's accumulator.
template <int E>
struct WarpState {
  float m[kGB], l[kGB], acc[kGB][E];
};

template <int E>
__device__ __forceinline__ void init_state(WarpState<E>& st) {
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    st.m[gi] = -CUDART_INF_F;
    st.l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[gi][e] = 0.f;
  }
}

// The slot loop both kernels share: warp w walks its interleaved share of
// the slots j in [st, en) for which live(j) holds, reading slot j's key and
// value row at kc / vc + j * slot_stride (this lane's D / 32 elements from
// d0), and folds them into its online softmax.
template <typename T, int D, typename Live>
__device__ __forceinline__ void attend_slots(const float (&qr)[kGB][D / 32],
                                             const T* __restrict__ kc,
                                             const T* __restrict__ vc, size_t slot_stride,
                                             int st, int en, Live live, float scale, int w,
                                             int d0, WarpState<D / 32>& ws) {
  constexpr int E = D / 32;
  const float NEG_INF = -CUDART_INF_F;
  for (int j0 = st + w * kU; j0 < en; j0 += kWarps * kU) {
    float kf[kU][E], vf[kU][E];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u;
      ok[u] = j < en && live(j);
      if (ok[u]) {
        load_f<T, E>(kc + (size_t)j * slot_stride + d0, kf[u]);
        load_f<T, E>(vc + (size_t)j * slot_stride + d0, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[kU][kGB];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int gi = 0; gi < kGB; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[gi][e], kf[u][e], part);
        s[u][gi] = ok[u] ? warp_sum(part) * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      float mx = ws.m[gi];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u][gi]);
      if (mx == NEG_INF) continue;  // nothing live yet (warp-uniform)
      const float alpha = expf(ws.m[gi] - mx);  // 0 when m was -inf
      ws.l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) ws.acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = ok[u] ? expf(s[u][gi] - mx) : 0.f;
        ws.l[gi] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) ws.acc[gi][e] = fmaf(p, vf[u][e], ws.acc[gi][e]);
      }
      ws.m[gi] = mx;
    }
  }
}

template <int D>
struct MergeSmem {
  float m[kWarps][kGB];
  float l[kWarps][kGB];
  float acc[kWarps][kGB][D];
  float snew[kGB];  // K2: the new token's score per head
  float vn[D];      // K2: the new token's value
};

// Stores this warp's state for the merge (the caller syncs after).
template <int D>
__device__ __forceinline__ void stash_state(const WarpState<D / 32>& ws, MergeSmem<D>& sm, int w,
                                            int lane, int d0) {
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
#pragma unroll
    for (int e = 0; e < D / 32; ++e) sm.acc[w][gi][d0 + e] = ws.acc[gi][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      sm.m[w][gi] = ws.m[gi];
      sm.l[w][gi] = ws.l[gi];
    }
  }
}

// Merges the warps' states and writes head g0 + gi of the group to
// out_heads + (g0 + gi) * D; with NEW the new token's column (sm.snew,
// sm.vn) joins last. A head that saw no slot gets zeros.
template <typename T, int D, bool NEW>
__device__ __forceinline__ void merge_store(const MergeSmem<D>& sm, T* __restrict__ out_heads,
                                            int G, int g0) {
  const float NEG_INF = -CUDART_INF_F;
  for (int idx = threadIdx.x; idx < kGB * D; idx += kWarps * 32) {
    const int gi = idx / D;
    const int d = idx % D;
    if (g0 + gi >= G) continue;
    float mx = NEW ? sm.snew[gi] : NEG_INF;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, sm.m[ww][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float mw = sm.m[ww][gi];
      if (mw == NEG_INF) continue;
      const float f = expf(mw - mx);
      L = fmaf(sm.l[ww][gi], f, L);
      A = fmaf(sm.acc[ww][gi][d], f, A);
    }
    if (NEW) {
      const float p_new = expf(sm.snew[gi] - mx);
      L += p_new;
      A = fmaf(p_new, sm.vn[d], A);
    }
    out_heads[(size_t)(g0 + gi) * D + d] = from_f<T>(L > 0.f ? A / L : 0.f);
  }
}

// ------------------------------------------------------------ K2 (+ K3)
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
fused_decode_kernel(const T* __restrict__ q,       // [B, 1, H, D] pre-rope
                    const T* __restrict__ k_new,   // [B, 1, KVH, D] pre-rope
                    const T* __restrict__ v_new,   // [B, 1, KVH, D]
                    const T* __restrict__ cos,     // [B, 1, D]
                    const T* __restrict__ sin,     // [B, 1, D]
                    T* __restrict__ k_cache,       // [B, KVH, S, D]
                    T* __restrict__ v_cache,       // [B, KVH, S, D]
                    const int* __restrict__ start,     // [B]
                    const int* __restrict__ kv_valid,  // [B, S]
                    T* __restrict__ out,           // [B, 1, H, D]
                    int H, int KVH, int S, int pos, float scale) {
  constexpr int E = D / 32;  // elements per lane
  const int G = H / KVH;
  const int n_gchunks = (G + kGB - 1) / kGB;
  const int kvh = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * kGB;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int d0 = lane * E;  // this lane's first element of a head row

  // ---- rope (every warp computes it; it is a few hundred bytes)
  float cs[E], sn[E];
  load_f<T, E>(cos + (size_t)b * D + d0, cs);
  load_f<T, E>(sin + (size_t)b * D + d0, sn);
  // rotate_half(x)[d] = -x[d + D/2] for d < D/2, x[d - D/2] otherwise; with
  // E elements per lane the partner of lane l is lane l ^ 16, same slot.
  auto rope = [&](const float (&x)[E], float (&y)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float partner = __shfl_xor_sync(0xffffffffu, x[e], 16);
      float r = lane < 16 ? -partner : partner;
      y[e] = round_to<T>(__fadd_rn(__fmul_rn(x[e], cs[e]), __fmul_rn(r, sn[e])));
    }
  };

  float qr[kGB][E];
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    float x[E];
    if (g0 + gi < G) {
      load_f<T, E>(q + ((size_t)b * H + kvh * G + g0 + gi) * D + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
    rope(x, qr[gi]);
  }
  float kn[E], knr[E], vn[E];
  load_f<T, E>(k_new + ((size_t)b * KVH + kvh) * D + d0, kn);
  rope(kn, knr);
  load_f<T, E>(v_new + ((size_t)b * KVH + kvh) * D + d0, vn);

  const size_t slab = ((size_t)b * KVH + kvh) * (size_t)S * D;
  if (w == 0 && g0 == 0) {
    store_f<T, E>(k_cache + slab + (size_t)pos * D + d0, knr);
    store_f<T, E>(v_cache + slab + (size_t)pos * D + d0, vn);
  }

  // ---- this warp's share of the live slots in [start, pos)
  const int* valid_row = kv_valid + (size_t)b * S;
  WarpState<E> ws;
  init_state(ws);
  attend_slots<T, D>(qr, k_cache + slab, v_cache + slab, D, max(start[b], 0), pos,
                     [&](int j) { return valid_row[j] != 0; }, scale, w, d0, ws);

  // ---- merge the warps' states, then the new token's own column
  __shared__ MergeSmem<D> sm;
  stash_state<D>(ws, sm, w, lane, d0);
  if (w == 0) {
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qr[gi][e], knr[e], part);
      part = warp_sum(part) * scale;
      if (lane == 0) sm.snew[gi] = part;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm.vn[d0 + e] = vn[e];
  }
  __syncthreads();
  merge_store<T, D, true>(sm, out + ((size_t)b * H + kvh * G) * D, G, g0);
}

// ------------------------------------------------------------------- K7
// Static-cache decode over a BSHD cache: query heads kvh * G + i of row b
// attend over the cache slots [start, end) of kv head kvh, start =
// max(valid_start, valid_end - window) under a window. No rope, no new-token
// column, no cache write: the K2 slot loop at a slot stride of KVH * D.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
static_decode_kernel(const T* __restrict__ q,            // [B, 1, H, D]
                     const T* __restrict__ k,            // [B, S, KVH, D]
                     const T* __restrict__ v,            // [B, S, KVH, D]
                     const int* __restrict__ valid_start,  // [B]
                     const int* __restrict__ valid_end,    // [B]
                     T* __restrict__ out,                // [B, 1, H, D]
                     int H, int KVH, int S, int window, float scale) {
  constexpr int E = D / 32;
  const int G = H / KVH;
  const int n_gchunks = (G + kGB - 1) / kGB;
  const int kvh = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * kGB;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int d0 = lane * E;

  float qr[kGB][E];
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    if (g0 + gi < G) {
      load_f<T, E>(q + ((size_t)b * H + kvh * G + g0 + gi) * D + d0, qr[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[gi][e] = 0.f;
    }
  }
  const int end = valid_end[b];
  int st = max(valid_start[b], 0);
  if (window > 0) st = max(st, end - window);
  const size_t head0 = ((size_t)b * S * KVH + kvh) * D;  // slot 0 of (b, kvh)

  WarpState<E> ws;
  init_state(ws);
  attend_slots<T, D>(qr, k + head0, v + head0, (size_t)KVH * D, st, min(end, S),
                     [](int) { return true; }, scale, w, d0, ws);

  __shared__ MergeSmem<D> sm;
  stash_state<D>(ws, sm, w, lane, d0);
  __syncthreads();
  merge_store<T, D, false>(sm, out + ((size_t)b * H + kvh * G) * D, G, g0);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* cos,
                   const void* sin, void* k_cache, void* v_cache, const int* start,
                   const int* kv_valid, void* out, int B, int H, int KVH, int S, int pos,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH * ((G + kGB - 1) / kGB), B);
  fused_decode_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(cos), static_cast<const T*>(sin), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), start, kv_valid, static_cast<T*>(out), H, KVH, S, pos, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_new, const void* v_new,
                     const void* cos, const void* sin, void* k_cache, void* v_cache,
                     const int* start, const int* kv_valid, void* out, int B, int H, int KVH,
                     int S, int pos, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_new, v_new, cos, sin, k_cache, v_cache, start, kv_valid, out,
                           B, H, KVH, S, pos, scale, stream);
    case 128:
      return launch<T, 128>(q, k_new, v_new, cos, sin, k_cache, v_cache, start, kv_valid,
                            out, B, H, KVH, S, pos, scale, stream);
    case 256:
      return launch<T, 256>(q, k_new, v_new, cos, sin, k_cache, v_cache, start, kv_valid,
                            out, B, H, KVH, S, pos, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_static(const void* q, const void* k, const void* v, const int* vs,
                          const int* ve, void* out, int B, int H, int KVH, int S, int window,
                          float scale, cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH * ((G + kGB - 1) / kGB), B);
  static_decode_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), vs, ve,
      static_cast<T*>(out), H, KVH, S, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_static_d(int D, const void* q, const void* k, const void* v, const int* vs,
                            const int* ve, void* out, int B, int H, int KVH, int S, int window,
                            float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_static<T, 64>(q, k, v, vs, ve, out, B, H, KVH, S, window, scale, stream);
    case 128:
      return launch_static<T, 128>(q, k, v, vs, ve, out, B, H, KVH, S, window, scale, stream);
    case 256:
      return launch_static<T, 256>(q, k, v, vs, ve, out, B, H, KVH, S, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int ttpu_fused_decode(const void* q, const void* k_new, const void* v_new,
                                 const void* cos, const void* sin, void* k_cache,
                                 void* v_cache, const void* start, const void* kv_valid,
                                 void* out, int B, int H, int KVH, int S, int D, int pos,
                                 float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(start);
  const int* kv = static_cast<const int*>(kv_valid);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<float>(D, q, k_new, v_new, cos, sin, k_cache, v_cache, s, kv, out, B, H,
                            KVH, S, pos, scale, st);
      break;
    case TTPU_BF16:
      err = launch_d<__nv_bfloat16>(D, q, k_new, v_new, cos, sin, k_cache, v_cache, s, kv,
                                    out, B, H, KVH, S, pos, scale, st);
      break;
    case TTPU_F16:
      err = launch_d<__half>(D, q, k_new, v_new, cos, sin, k_cache, v_cache, s, kv, out, B,
                             H, KVH, S, pos, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K7. window <= 0: no window. Returns the launch's cudaGetLastError() (0 on
// success).
extern "C" int ttpu_static_decode(const void* q, const void* k, const void* v,
                                  const void* valid_start, const void* valid_end, void* out,
                                  int B, int H, int KVH, int S, int D, int window, float scale,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vs = static_cast<const int*>(valid_start);
  const int* ve = static_cast<const int*>(valid_end);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_static_d<float>(D, q, k, v, vs, ve, out, B, H, KVH, S, window, scale, st);
      break;
    case TTPU_BF16:
      err = launch_static_d<__nv_bfloat16>(D, q, k, v, vs, ve, out, B, H, KVH, S, window,
                                           scale, st);
      break;
    case TTPU_F16:
      err = launch_static_d<__half>(D, q, k, v, vs, ve, out, B, H, KVH, S, window, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
