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

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kGB = 4;     // query heads per block
constexpr int kU = 4;      // slots each warp has in flight per iteration

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
  const float NEG_INF = -CUDART_INF_F;

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
  const T* kc = k_cache + slab;
  const T* vc = v_cache + slab;
  const int* valid_row = kv_valid + (size_t)b * S;
  const int st = max(start[b], 0);

  float m[kGB], l[kGB], acc[kGB][E];
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  for (int j0 = st + w * kU; j0 < pos; j0 += kWarps * kU) {
    float kf[kU][E], vf[kU][E];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u;
      ok[u] = j < pos && valid_row[j] != 0;
      if (ok[u]) {
        load_f<T, E>(kc + (size_t)j * D + d0, kf[u]);
        load_f<T, E>(vc + (size_t)j * D + d0, vf[u]);
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
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u][gi]);
      if (mx == NEG_INF) continue;  // nothing live yet (warp-uniform)
      const float alpha = expf(m[gi] - mx);  // 0 when m was -inf
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = ok[u] ? expf(s[u][gi] - mx) : 0.f;
        l[gi] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e]);
      }
      m[gi] = mx;
    }
  }

  // ---- merge the warps' states, then the new token's own column
  __shared__ float sm_m[kWarps][kGB];
  __shared__ float sm_l[kWarps][kGB];
  __shared__ float sm_acc[kWarps][kGB][D];
  __shared__ float sm_snew[kGB];
  __shared__ float sm_vn[D];
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[w][gi][d0 + e] = acc[gi][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      sm_m[w][gi] = m[gi];
      sm_l[w][gi] = l[gi];
    }
  }
  if (w == 0) {
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qr[gi][e], knr[e], part);
      part = warp_sum(part) * scale;
      if (lane == 0) sm_snew[gi] = part;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_vn[d0 + e] = vn[e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kGB * D; idx += kWarps * 32) {
    const int gi = idx / D;
    const int d = idx % D;
    if (g0 + gi >= G) continue;
    const float s_new = sm_snew[gi];
    float mx = s_new;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, sm_m[ww][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float mw = sm_m[ww][gi];
      if (mw == NEG_INF) continue;
      const float f = expf(mw - mx);
      L = fmaf(sm_l[ww][gi], f, L);
      A = fmaf(sm_acc[ww][gi][d], f, A);
    }
    const float p_new = expf(s_new - mx);
    L += p_new;
    A = fmaf(p_new, sm_vn[d], A);
    out[((size_t)b * H + kvh * G + g0 + gi) * D + d] = from_f<T>(A / L);
  }
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
