// Paged single-token decode attention: each row's query heads attend over the
// K/V slots [start, ctx) of that row, read page by page through its block
// table, with start = max(ctx - window, 0) under a sliding window and 0
// otherwise. A row with ctx = 0 gives zeros.
//
// Replaces transformers_tpu/ops/pallas/paged_attention.py
// (paged_decode_attention / _paged_decode_kernel). The Pallas kernel walks a
// row's pages in groups of 8 with double-buffered DMAs into VMEM and fetches
// dead pages (the null page) branch-free; here a block reads only live pages.
//
// Pools are [P, KVH, BS, D]: page `blk` of kv head `h` is the contiguous
// [BS, D] slab at pool + (blk * KVH + h) * BS * D.
//
// Bound on the H100: bytes. A step reads each live slot's key and value once
// (2 * D * sizeof(T) per slot and kv head) and does 4 * G * D operations per
// slot, about one operation per byte against the card's ~295. The design
// therefore reads every K/V byte once: one block owns one (row, kv head) and
// holds up to GB of that kv head's G query heads (GB = 4 for G <= 4, else 8;
// G > 8 takes ceil(G / 8) blocks per kv head). Each warp walks its own
// interleaved share of the live slots with coalesced vector loads (a lane
// holds D / 32 neighbouring elements of a slot's row) and keeps a float online
// softmax; the warps' states are merged in shared memory at the end, one
// query head at a time. Scores, probabilities and the P.V sums stay in f32;
// the output is rounded once to T.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,              // [N, 1, H, D]
                    const T* __restrict__ k_pool,         // [P, KVH, BS, D]
                    const T* __restrict__ v_pool,         // [P, KVH, BS, D]
                    const int* __restrict__ block_tables, // [N, MAXB]
                    const int* __restrict__ ctx_lens,     // [N]
                    T* __restrict__ out,                  // [N, 1, H, D]
                    int H, int KVH, int BS, int MAXB, int window, float scale) {
  constexpr int E = D / 32;  // elements per lane
  // slots each warp has in flight per iteration, fewer when the per-head
  // registers (GB * E floats each for q and the accumulator) are many
  constexpr int kU = GB * E >= 64 ? 1 : (GB * E >= 32 ? 2 : 4);
  const int G = H / KVH;
  const int n_gchunks = (G + GB - 1) / GB;
  const int kvh = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * GB;
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int d0 = lane * E;  // this lane's first element of a head row
  const float NEG_INF = -CUDART_INF_F;

  const int ctx = min(max(ctx_lens[n], 0), MAXB * BS);
  const int start = window > 0 ? max(ctx - window, 0) : 0;

  float qf[GB][E];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (g0 + gi < G) {
      load_f<T, E>(q + ((size_t)n * H + kvh * G + g0 + gi) * D + d0, qf[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[gi][e] = 0.f;
    }
  }

  const int* table = block_tables + (size_t)n * MAXB;
  const size_t page_stride = (size_t)KVH * BS * D;
  const size_t head_off = (size_t)kvh * BS * D + d0;

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  // ---- this warp's share of the live slots [start, ctx)
  for (int j0 = start + w * kU; j0 < ctx; j0 += kWarps * kU) {
    float kf[kU][E], vf[kU][E];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u;
      ok[u] = j < ctx;  // the same for every lane of the warp
      if (ok[u]) {
        const size_t off = (size_t)table[j / BS] * page_stride + head_off + (size_t)(j % BS) * D;
        load_f<T, E>(k_pool + off, kf[u]);
        load_f<T, E>(v_pool + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[kU][GB];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qf[gi][e], kf[u][e], part);
        s[u][gi] = ok[u] ? warp_sum(part) * scale : NEG_INF;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
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

  // ---- merge the warps' states, one query head at a time
  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      sm_m[w][gi] = m[gi];
      sm_l[w][gi] = l[gi];
    }
  }
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (g0 + gi >= G) break;  // the same for the whole block
    __syncthreads();  // the previous head's readers are done with sm_acc
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[w][d0 + e] = acc[gi][e];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kWarps * 32) {
      float mx = NEG_INF;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) mx = fmaxf(mx, sm_m[ww][gi]);
      float L = 0.f, A = 0.f;
      if (mx != NEG_INF) {
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) {
          const float mw = sm_m[ww][gi];
          if (mw == NEG_INF) continue;
          const float f = expf(mw - mx);
          L = fmaf(sm_l[ww][gi], f, L);
          A = fmaf(sm_acc[ww][d], f, A);
        }
      }
      out[((size_t)n * H + kvh * G + g0 + gi) * D + d] = from_f<T>(L > 0.f ? A / L : 0.f);
    }
  }
}

template <typename T, int D, int GB>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* ctx_lens, void* out, int N, int H, int KVH, int BS, int MAXB,
                   int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH * ((G + GB - 1) / GB), N);
  paged_decode_kernel<T, D, GB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, ctx_lens, static_cast<T*>(out), H, KVH, BS, MAXB, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                     const int* ctx_lens, void* out, int N, int H, int KVH, int BS, int MAXB,
                     int window, float scale, cudaStream_t stream) {
  if (H / KVH <= 4) {
    return launch<T, D, 4>(q, k_pool, v_pool, tables, ctx_lens, out, N, H, KVH, BS, MAXB,
                           window, scale, stream);
  }
  return launch<T, D, 8>(q, k_pool, v_pool, tables, ctx_lens, out, N, H, KVH, BS, MAXB,
                         window, scale, stream);
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_pool, const void* v_pool,
                     const int* tables, const int* ctx_lens, void* out, int N, int H, int KVH,
                     int BS, int MAXB, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_g<T, 64>(q, k_pool, v_pool, tables, ctx_lens, out, N, H, KVH, BS, MAXB,
                             window, scale, stream);
    case 128:
      return launch_g<T, 128>(q, k_pool, v_pool, tables, ctx_lens, out, N, H, KVH, BS, MAXB,
                              window, scale, stream);
    case 256:
      return launch_g<T, 256>(q, k_pool, v_pool, tables, ctx_lens, out, N, H, KVH, BS, MAXB,
                              window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success). window <= 0: none.
extern "C" int ttpu_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* block_tables, const void* ctx_lens, void* out,
                                 int N, int H, int KVH, int BS, int D, int MAXB, int window,
                                 float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(ctx_lens);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<float>(D, q, k_pool, v_pool, bt, cl, out, N, H, KVH, BS, MAXB, window,
                            scale, st);
      break;
    case TTPU_BF16:
      err = launch_d<__nv_bfloat16>(D, q, k_pool, v_pool, bt, cl, out, N, H, KVH, BS, MAXB,
                                    window, scale, st);
      break;
    case TTPU_F16:
      err = launch_d<__half>(D, q, k_pool, v_pool, bt, cl, out, N, H, KVH, BS, MAXB, window,
                             scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
