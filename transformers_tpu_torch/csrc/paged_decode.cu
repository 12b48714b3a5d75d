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
// therefore reads every K/V byte once and keeps enough of them in flight,
// with few instructions per byte:
//
// - Split-KV (paged_split_kernel). Each row's slots are cut into splits of
//   `split_slots` slots (a whole number of pages; the wrapper's SPLIT_SLOTS,
//   64, was the fastest at the continuous-batching shape, 8 rows of 64-576
//   slots, 32 query heads over 8 kv heads, D = 128, pages of 32: 32 / 64 /
//   128 / 256 / 640 slots took 0.0145 / 0.0118 / 0.0127 / 0.0182 / 0.0260 ms
//   with the merge, in a one-time sweep on an H100 80GB HBM3 at 700 W). One
//   block of 4 warps owns one split of one (row, kv head) and holds up to GB
//   of that kv head's G query heads (GB = 4 for G <= 4, else 8; G > 8 takes
//   ceil(G / 8) blocks per kv head), so each K/V byte is read once per
//   query-head group. Splits that lie wholly outside [start, ctx) return at
//   once.
// - No dependent load before each slot. A block reads its split's block-table
//   entries into shared memory once, in the same round trip as the row's
//   context length, then copies the split in stages of 32 slots of K and V
//   with cp.async into two stages (rows padded by 16 bytes), so the next
//   stage's copies are in flight while this one is scored.
// - Each warp scores 8 slots of a stage. In bf16/fp16 the scores of the
//   block's heads are one mma.sync m16n8k16 tile per 16 of D (q as the A
//   rows g < GB, K by ldmatrix as B; exact products, f32 sums); in f32 a lane
//   holds D / 32 elements of a slot's row and each score is a warp sum. The
//   softmax and P.V stay in f32 on the CUDA cores: a lane holds D / 32
//   elements of each head's output and takes each slot's probability from
//   the lane that scored it. The block's 4 warps are merged once, in shared
//   memory over the spent stages. (This scoring and merge are mma.cuh's
//   decode helpers, shared with K2 and K7 in fused_decode.cu.)
// - The merge (paged_combine_kernel). A row whose live slots fit in one
//   split gets its output from that split's block. Otherwise each split
//   writes its f32 (m, l, acc) partials to scratch the wrapper allocates, and
//   a second small kernel merges a row's splits in split order, so the output
//   is the same bit for bit from run to run. One C call launches both.
// The scores, probabilities and P.V sums are f32; the output is rounded once
// to T.

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 8 * kWarps;  // slots per copy stage, 8 a warp
constexpr int kMaxSplitPages = 64;  // block-table entries one split may span

// Dynamic shared memory of a split block: K and V stages, two each, with
// rows padded by kPad elements (ldmatrix reads K without bank conflicts).
// The block's merge of its warps reuses it (kWarps * GB * D floats fit).
template <typename T, int D>
constexpr size_t split_smem() {
  return (size_t)4 * kStage * (D + kPad) * sizeof(T);
}

// Live slots [start, ctx) of a row (ctx clamped to the table's slots) and
// the number of splits they touch.
struct RowSpan {
  int start, ctx, n_live;
};

__device__ __forceinline__ RowSpan row_span(int ctx_len, int max_slots, int window,
                                            int split_slots) {
  RowSpan r;
  r.ctx = min(max(ctx_len, 0), max_slots);
  r.start = window > 0 ? max(r.ctx - window, 0) : 0;
  r.n_live = r.ctx > r.start ? (r.ctx - 1) / split_slots - r.start / split_slots + 1 : 0;
  return r;
}

// Slots [c0, min(c0 + kStage, hi)) of one kv head into a K and a V stage
// (rows padded by kPad), asynchronously; tbl holds the block-table entries
// from page page_base on. One commit group.
template <typename T, int D>
__device__ __forceinline__ void copy_stage(T* ks, T* vs, const T* __restrict__ k_head,
                                           const T* __restrict__ v_head, const int* tbl, int c0,
                                           int hi, int page_base, int BS, int KVH) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = D / EPC;              // copies per slot row
  const size_t page_stride = (size_t)KVH * BS * D;
  const int rows = min(kStage, hi - c0);
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int col = (i % CPR) * EPC;
    const int j = c0 + r;
    const size_t off = (size_t)tbl[j / BS - page_base] * page_stride + (size_t)(j % BS) * D + col;
    cp_async16(ks + r * (D + kPad) + col, k_head + off, true);
    cp_async16(vs + r * (D + kPad) + col, v_head + off, true);
  }
  cp_async_commit();
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads, 1)  // min 1 block: ptxas spills some builds otherwise
paged_split_kernel(const T* __restrict__ q,              // [N, 1, H, D]
                   const T* __restrict__ k_pool,         // [P, KVH, BS, D]
                   const T* __restrict__ v_pool,         // [P, KVH, BS, D]
                   const int* __restrict__ block_tables, // [N, MAXB]
                   const int* __restrict__ ctx_lens,     // [N]
                   T* __restrict__ out,                  // [N, 1, H, D]
                   float* __restrict__ part_ml,          // [N, H, n_splits, 2]
                   float* __restrict__ part_acc,         // [N, H, n_splits, D]
                   int H, int KVH, int BS, int MAXB, int window, float scale, int split_slots,
                   int n_splits) {
  constexpr int S = D + kPad;  // row stride of the stages
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [2][kStage][S]
  T* Vs = Ks + 2 * kStage * S;         // [2][kStage][S]
  float* sm_acc = reinterpret_cast<float*>(smem);  // [kWarps][GB][D], over the stages at the end
  __shared__ int tbl[kMaxSplitPages];
  __shared__ DecodeMergeSmem<GB, kWarps> sm;

  const int G = H / KVH;
  const int n_gchunks = (G + GB - 1) / GB;
  const int kvh = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * GB;
  const int split = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5;
  const int n_heads = min(GB, G - g0);
  const size_t row_h0 = (size_t)n * H + kvh * G + g0;  // (row, first query head) of this block

  // the row's context and the split's block-table entries, read together
  const int page_base = split * (split_slots / BS);
  const int n_table = min(split_slots / BS, MAXB - page_base);
  for (int i = tid; i < n_table; i += kThreads) tbl[i] = block_tables[(size_t)n * MAXB + page_base + i];
  const RowSpan span = row_span(ctx_lens[n], MAXB * BS, window, split_slots);
  if (span.n_live == 0) {  // ctx 0: zeros, written by the first split's block
    if (split == 0) {
      for (int i = tid; i < n_heads * D; i += kThreads) out[row_h0 * D + i] = from_f<T>(0.f);
    }
    return;
  }
  const int lo = max(span.start, split * split_slots);
  const int hi = min(span.ctx, (split + 1) * split_slots);
  if (lo >= hi) return;  // the split lies outside [start, ctx)

  DecodeWarp<T, D, GB> st;
  decode_init(st, q + row_h0 * D, n_heads);
  __syncthreads();  // tbl

  const T* k_head = k_pool + (size_t)kvh * BS * D;  // page 0 of this kv head
  const T* v_head = v_pool + (size_t)kvh * BS * D;
  const int n_stages = (hi - lo + kStage - 1) / kStage;

  copy_stage<T, D>(Ks, Vs, k_head, v_head, tbl, lo, hi, page_base, BS, KVH);
  for (int c = 0; c < n_stages; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_stages) {
      const int c0 = lo + (c + 1) * kStage;
      copy_stage<T, D>(Ks + (stage ^ 1) * kStage * S, Vs + (stage ^ 1) * kStage * S, k_head,
                       v_head, tbl, c0, hi, page_base, BS, KVH);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nw = min(8, hi - (lo + c * kStage) - 8 * w);  // of the warp's 8 slots, live
    decode_attend8<false>(st, Ks + stage * kStage * S + 8 * w * S,
                          Vs + stage * kStage * S + 8 * w * S, nw, nullptr, scale);
    __syncthreads();  // this stage is refilled in the next iteration
  }

  // ---- the block's merge of its warps (over the stages), then the output
  // (the row's only split) or this split's partials
  decode_block_merge(st, sm_acc, sm, [](int) { return -CUDART_INF_F; });
  const bool direct = span.n_live == 1;
  for (int i = tid; i < n_heads * D; i += kThreads) {
    const int gi = i / D, d = i % D;
    const float A = decode_block_acc<D, GB, kWarps>(sm_acc, sm, gi, d);
    if (direct) {
      out[(row_h0 + gi) * D + d] = from_f<T>(__fdividef(A, sm.ml[gi][1]));  // l >= 1
    } else {
      part_acc[((row_h0 + gi) * n_splits + split) * D + d] = A;
    }
  }
  if (!direct && tid < n_heads) {
    const size_t part = (row_h0 + tid) * n_splits + split;
    part_ml[2 * part] = sm.ml[tid][0];
    part_ml[2 * part + 1] = sm.ml[tid][1];
  }
}

// One block per (query head, row): the row's splits merged in split order.
// Rows whose live slots fit in one split were written by the split kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const int* __restrict__ ctx_lens, const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out, int H, int D,
                     int max_slots, int window, int split_slots, int n_splits) {
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const RowSpan span = row_span(ctx_lens[n], max_slots, window, split_slots);
  if (span.n_live <= 1) return;
  const size_t row = (size_t)n * H + h;
  const size_t first = row * n_splits + span.start / split_slots;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < span.n_live; ++s) mx = fmaxf(mx, part_ml[2 * (first + s)]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < span.n_live; ++s) {
      const float f = expf(part_ml[2 * (first + s)] - mx);
      L = fmaf(part_ml[2 * (first + s) + 1], f, L);
      A = fmaf(part_acc[(first + s) * D + d], f, A);
    }
    out[row * D + d] = from_f<T>(__fdividef(A, L));  // L >= 1
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *tables, *ctx_lens;
  void* out;
  float *part_ml, *part_acc;
  int N, H, KVH, BS, MAXB, window;
  float scale;
  int split_slots, n_splits;
  cudaStream_t stream;
};

template <typename T, int D, int GB>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = split_smem<T, D>();
  static bool smem_set = false;  // once per instantiation (also keeps it out of graph capture)
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(paged_split_kernel<T, D, GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int G = a.H / a.KVH;
  dim3 grid(a.KVH * ((G + GB - 1) / GB), a.n_splits, a.N);
  paged_split_kernel<T, D, GB><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.tables, a.ctx_lens, static_cast<T*>(a.out), a.part_ml,
      a.part_acc, a.H, a.KVH, a.BS, a.MAXB, a.window, a.scale, a.split_slots, a.n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const Args& a) {
  return a.H / a.KVH <= 4 ? launch<T, D, 4>(a) : launch<T, D, 8>(a);
}

template <typename T>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch_g<T, 64>(a);
    case 96:
      return launch_g<T, 96>(a);
    case 128:
      return launch_g<T, 128>(a);
    case 256:
      return launch_g<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_combine(const int* ctx_lens, const float* part_ml, const float* part_acc,
                           void* out, int N, int H, int D, int max_slots, int window,
                           int split_slots, int n_splits, cudaStream_t stream) {
  paged_combine_kernel<T><<<dim3(H, N), kThreads, 0, stream>>>(
      ctx_lens, part_ml, part_acc, static_cast<T*>(out), H, D, max_slots, window, split_slots,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ttpu_paged_decode_combine(const void* ctx_lens, const void* part_ml,
                                         const void* part_acc, void* out, int N, int H, int D,
                                         int max_slots, int window, int split_slots,
                                         int n_splits, int dtype, void* stream);

// One decode step: the split pass, then the merge pass on the same stream,
// in one call (the host's cost per layer matters in a host-bound decode
// loop). split_slots: a multiple of BS, at most 64 pages; n_splits =
// ceil(MAXB * BS / split_slots). part_ml [N, H, n_splits, 2] and part_acc
// [N, H, n_splits, D] are f32 scratch. window <= 0: none. Returns the first
// launch error (0 on success).
extern "C" int ttpu_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* block_tables, const void* ctx_lens, void* out,
                                 void* part_ml, void* part_acc, int N, int H, int KVH, int BS,
                                 int D, int MAXB, int window, float scale, int split_slots,
                                 int n_splits, int dtype, void* stream) {
  if (split_slots <= 0 || split_slots % BS || split_slots / BS > kMaxSplitPages)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pool, v_pool, static_cast<const int*>(block_tables),
         static_cast<const int*>(ctx_lens), out, static_cast<float*>(part_ml),
         static_cast<float*>(part_acc), N, H, KVH, BS, MAXB, window, scale, split_slots,
         n_splits, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<float>(D, a);
      break;
    case TTPU_BF16:
      err = launch_d<__nv_bfloat16>(D, a);
      break;
    case TTPU_F16:
      err = launch_d<__half>(D, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return ttpu_paged_decode_combine(ctx_lens, part_ml, part_acc, out, N, H, D, MAXB * BS, window,
                                   split_slots, n_splits, dtype, stream);
}

// The merge pass alone over the split pass's partials: writes the rows whose
// live slots span more than one split. max_slots = MAXB * BS.
extern "C" int ttpu_paged_decode_combine(const void* ctx_lens, const void* part_ml,
                                         const void* part_acc, void* out, int N, int H, int D,
                                         int max_slots, int window, int split_slots,
                                         int n_splits, int dtype, void* stream) {
  const int* cl = static_cast<const int*>(ctx_lens);
  const float* ml = static_cast<const float*>(part_ml);
  const float* acc = static_cast<const float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_combine<float>(cl, ml, acc, out, N, H, D, max_slots, window, split_slots,
                                  n_splits, st);
      break;
    case TTPU_BF16:
      err = launch_combine<__nv_bfloat16>(cl, ml, acc, out, N, H, D, max_slots, window,
                                          split_slots, n_splits, st);
      break;
    case TTPU_F16:
      err = launch_combine<__half>(cl, ml, acc, out, N, H, D, max_slots, window, split_slots,
                                   n_splits, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
