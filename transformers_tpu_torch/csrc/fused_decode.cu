// Split-KV single-token decode for the H100, in two modes of one kernel body.
//
// K2 (+ K3), fused_decode_kernel: one decode step. Rotate-half rope on q and
// the new key, attention over the bhsd cache slots [start, pos) that kv_valid
// marks live plus the new token's own column, and the write of the roped key
// and the value into cache slot pos. Replaces
// transformers_tpu/ops/pallas/fused_decode.py (fused_decode_attention:
// _fused_decode_kernel_whole and the chunked, double-buffered
// _fused_decode_kernel). pos is read from device memory, as the Pallas kernel
// reads it by scalar prefetch, so a captured CUDA graph can replay the step
// at another slot.
//
// K7, static_decode_kernel: the static-cache decode of
// transformers_tpu/ops/pallas/decode_attention.py (decode_attention /
// _decode_kernel). Its cache is BSHD [B, S, KVH, D] (a slot stride of
// KVH * D, against K2's D); each row reads its live slots [valid_start,
// valid_end), start = max(valid_start, valid_end - window) under a sliding
// window; no rope, no new-token column, no cache write. A row with end <=
// start gives zeros.
//
// Bound on the H100: bytes. A step reads each live cache slot's key and value
// once (2 * D * sizeof(T) per slot, per row and kv head) and does 4 * G * D
// operations per slot, about one operation per byte against the card's ~295.
// At the generate shape that is ~5 MB, 0.0015 ms. The kernel before this
// design (one block of 8 warps per (row, kv head)) took 0.0188 ms there and
// K7's 0.0262 ms (chip_smoke.py, H100 80GB HBM3, 700 W; this design: 0.0085
// and 0.0086 ms): 64 blocks on 132 SMs, each warp with 4 slots of 8 bytes a
// lane in flight, every score a 5-shuffle warp sum, and a 16 KB merge of 8
// warps. The design, K6's split-KV scheme (csrc/paged_decode.cu; the
// per-warp scoring and the block's merge are shared through mma.cuh):
//
// - Split-KV. Each (row, kv head)'s slots are cut into splits of split_slots
//   (the wrappers' SPLIT_SLOTS); one block owns one split and holds up to GB
//   of that kv head's G query heads (GB = 4 for G <= 4, else 8; G > 8 takes
//   ceil(G / 8) blocks per kv head), so each K/V byte is read once per
//   query-head group. The grid is sized from the cache length S, not from
//   pos: splits that lie wholly outside a row's live range return at once.
// - Copies in flight. Right after reading its row's range, a block starts
//   copying its split with cp.async in stages of 8 slots a warp (K, V and
//   K2's kv_valid flags), double-buffered, rows padded by kPad so that
//   ldmatrix reads K without bank conflicts; the queries (K2: rope on q and
//   the new key) are set up while the first stage flies, every load of a
//   thread issued before the first is used. A block has 8 warps (64-slot
//   stages; 4 for f32 at head_dim 256, where two such stages would not fit
//   in 144 KB of shared memory): a one-split row of 160 slots takes 3
//   serial stages, not 5. A one-off build with K6's 4-warp blocks was
//   slower at both smoke shapes; one with four buffers a block, as fast
//   there and slower at S = 4096 (one block an SM).
// - Scores on the tensor cores in bf16/fp16 (mma.sync m16n8k16, the block's
//   heads as A rows, K by ldmatrix as B), by warp sums in f32. The softmax
//   and P.V stay in f32.
// - One launch, bitwise repeatable. A row whose live slots fit in one split
//   gets its output from that split's block. Otherwise each split writes f32
//   (m, l, acc) partials to scratch the wrapper allocates, and the last block
//   of a (row, kv head, head group) to finish, found by __threadfence() and
//   an atomic ticket, merges all the splits in split order (K2's new column
//   last) and resets its ticket to 0 for the next call or graph replay. The
//   output is the same bit for bit whichever block finishes last.
// - K2's cache write: the block of split pos / split_slots (first head
//   group) writes the roped key and the value into slot pos. No block reads
//   slot pos of the cache: the slot loop stops there, and the new column
//   comes from shared memory. A pos outside [0, S) writes no cache slot and
//   gives NaN outputs.
//
// K7 keeps these blocks over its strided BSHD rows: each slot row of a kv
// head is a contiguous D * sizeof(T) piece (256 bytes at D = 128 in bf16,
// two whole 128-byte lines), so the stride costs no extra DRAM traffic.
//
// The split size: a one-time sweep (decode_split_sweep.py, H100 80GB HBM3,
// 700 W) found 160-512 slots fastest at the generate shape and 224-512 at
// K7's smoke shape, where every row then fits in one split and skips the
// merge (smaller splits fill more SMs but pay the merge's round trips), and
// 512 fastest for K2 at S = 4096, pos = 4000 (smaller splits lengthen the
// last block's serial merge). The readings are beside SPLIT_SLOTS in
// ops/fused_decode.py and ops/decode_attention.py.
//
// Rope rounds once to the storage type, as the Pallas kernel does: f32 math
// on the T-valued q, k and cos/sin, then one cast to T. Scores,
// probabilities and P.V sums are f32 (the Pallas kernels cast the
// probabilities to T before P.V); the output is rounded once to T.

#include "mma.cuh"

namespace {

// Warps a block: eight (64-slot copy stages, 8 slots a warp) where the two
// stages of K and V fit in 144 KB of shared memory, else four (f32 at
// head_dim 256).
template <typename T, int D>
__host__ __device__ constexpr int decode_warps() {
  return 2 * 2 * 64 * (D + kPad) * sizeof(T) <= 144 * 1024 ? 8 : 4;
}

template <typename T, int D>
constexpr size_t decode_smem() {
  return (size_t)2 * 2 * 8 * decode_warps<T, D>() * (D + kPad) * sizeof(T);
}

// Arguments of both modes (K2: fused; K7: static).
struct DecArgs {
  const void* q;      // [B, 1, H, D] (K2: pre-rope)
  const void* k_new;  // K2: [B, 1, KVH, D] pre-rope
  const void* v_new;  // K2: [B, 1, KVH, D]
  const void* cos;    // K2: [B, 1, D]
  const void* sin;    // K2: [B, 1, D]
  void* k;            // K2: [B, KVH, S, D] (slot pos written); K7: [B, S, KVH, D]
  void* v;
  const int* start;      // [B] first live slot (K7: valid_start)
  const int* end;        // K7: [B] valid_end
  const int* kv_valid;   // K2: [B, S]
  const int* pos;        // K2: [1] the new token's cache slot
  void* out;             // [B, 1, H, D]
  float* part_acc;       // [B, H, n_splits, D]
  float* part_ml;        // [B, H, n_splits, 2]
  int* tickets;          // [B, gridDim.x], 0 between calls
  int H, KVH, S, window, split_slots, n_splits;
  float scale;
};

template <typename T, int D, int GB, bool kFused>
__device__ __forceinline__ void decode_split(const DecArgs& a) {
  constexpr int RS = D + kPad;  // row stride of the stages
  constexpr int E = D / 32;
  constexpr int NW = decode_warps<T, D>();  // warps
  constexpr int NT = 32 * NW;                // threads
  constexpr int ST = 8 * NW;                 // slots a copy stage
  const float NEG_INF = -CUDART_INF_F;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [2][ST][RS]
  T* Vs = Ks + 2 * ST * RS;            // [2][ST][RS]
  float* sm_acc = reinterpret_cast<float*>(smem);  // [NW][GB][D], over the stages at the end
  __shared__ DecodeMergeSmem<GB, NW> sm;
  // K2: the block's roped query heads and the roped new key, as T
  __shared__ __align__(16) unsigned char sq_raw[(kFused ? GB * D : 1) * sizeof(T)];
  __shared__ __align__(16) unsigned char skn_raw[(kFused ? D : 1) * sizeof(T)];
  T* sq = reinterpret_cast<T*>(sq_raw);
  T* skn = reinterpret_cast<T*>(skn_raw);
  __shared__ float svn[kFused ? D : 1];          // K2: the new value
  __shared__ float snew[GB];                     // K2: the new column's score per head
  __shared__ float spn[GB];                      // K2: its weight in the merge
  __shared__ int valid_s[kFused ? 2 * ST : 1];  // K2: the stages' kv_valid flags
  __shared__ int last_block;

  const int G = a.H / a.KVH;
  const int n_gchunks = (G + GB - 1) / GB;
  const int kvh = blockIdx.x / n_gchunks;
  const int g0 = (blockIdx.x % n_gchunks) * GB;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int n_heads = min(GB, G - g0);
  const int split_slots = a.split_slots;
  const size_t row_h0 = (size_t)b * a.H + kvh * G + g0;  // (row, first query head) of this block
  T* out = static_cast<T*>(a.out) + row_h0 * D;

  // ---- the row's live slots [lo, hi) and this split's share of them
  int lo, hi, pos = 0;
  if constexpr (kFused) {
    pos = *a.pos;
    if (pos < 0 || pos >= a.S) {  // no cache write; NaN outputs
      if (split == 0) {
        for (int i = tid; i < n_heads * D; i += NT) out[i] = from_f<T>(CUDART_NAN_F);
      }
      return;
    }
    lo = max(a.start[b], 0);
    hi = pos;
  } else {
    const int end = a.end[b];
    lo = max(a.start[b], 0);
    if (a.window > 0) lo = max(lo, end - a.window);
    hi = min(end, a.S);
  }
  const int n_live = hi > lo ? (hi - 1) / split_slots - lo / split_slots + 1 : 0;
  const int s_lo = max(lo, split * split_slots);
  const int s_hi = min(hi, (split + 1) * split_slots);
  // K2: the block that writes slot pos and, when no cache slot is live, the output
  const bool writer = kFused && split == pos / split_slots;
  if (s_lo >= s_hi) {
    if constexpr (!kFused) {
      if (n_live == 0 && split == 0) {  // no live slot: zeros
        for (int i = tid; i < n_heads * D; i += NT) out[i] = from_f<T>(0.f);
      }
      return;
    }
    if (!writer) return;
  }

  // ---- the split's first copies, in flight while the block sets up its queries
  size_t stride;  // elements from one slot's row to the next
  const T *k_rows, *v_rows;  // slot 0 of this (row, kv head)
  if constexpr (kFused) {
    stride = D;
    k_rows = static_cast<const T*>(a.k) + ((size_t)b * a.KVH + kvh) * a.S * D;
    v_rows = static_cast<const T*>(a.v) + ((size_t)b * a.KVH + kvh) * a.S * D;
  } else {
    stride = (size_t)a.KVH * D;
    k_rows = static_cast<const T*>(a.k) + ((size_t)b * a.S * a.KVH + kvh) * D;
    v_rows = static_cast<const T*>(a.v) + ((size_t)b * a.S * a.KVH + kvh) * D;
  }
  const int* valid_row = kFused ? a.kv_valid + (size_t)b * a.S : nullptr;
  // stage c (slots from s_lo + c * ST) into buffer c & 1; one commit group
  auto copy_stage = [&](int c) {
    const int c0 = s_lo + c * ST;
    const int buf = c & 1;
    const int rows = min(ST, s_hi - c0);
    cp_rows<T, D, ST, NT>(Ks + buf * ST * RS, k_rows + c0 * stride, stride, rows);
    cp_rows<T, D, ST, NT>(Vs + buf * ST * RS, v_rows + c0 * stride, stride, rows);
    if constexpr (kFused) cp_vals<ST>(valid_s + buf * ST, valid_row + c0, rows);
    cp_async_commit();
  };
  const int n_stages = s_lo < s_hi ? (s_hi - s_lo + ST - 1) / ST : 0;
  if (n_stages > 0) copy_stage(0);

  // ---- the block's query heads (K2: roped, in shared memory, with the new key)
  const T* q = static_cast<const T*>(a.q) + row_h0 * D;
  DecodeWarp<T, D, GB> st;
  if constexpr (kFused) {
    const T* cs = static_cast<const T*>(a.cos) + (size_t)b * D;
    const T* sn = static_cast<const T*>(a.sin) + (size_t)b * D;
    const size_t kv_row = ((size_t)b * a.KVH + kvh) * D;
    const T* kn = static_cast<const T*>(a.k_new) + kv_row;
    const T* vn = static_cast<const T*>(a.v_new) + kv_row;
    // element d of the GB heads and the new key (row GB): every load first,
    // then rotate_half(x)[d] = -x[d + D/2] for d < D/2, x[d - D/2] otherwise
    for (int d = tid; d < D; d += NT) {
      const int dp = d < D / 2 ? d + D / 2 : d - D / 2;  // (not d ^ D/2: D may be 96)
      float x[GB + 1], partner[GB + 1];
#pragma unroll
      for (int gi = 0; gi <= GB; ++gi) {
        const T* src = gi < GB ? q + gi * D : kn;
        const bool ok = gi == GB || gi < n_heads;
        x[gi] = ok ? to_f(src[d]) : 0.f;
        partner[gi] = ok ? to_f(src[dp]) : 0.f;
      }
      const float c = to_f(cs[d]), sgn = to_f(sn[d]);
      svn[d] = to_f(vn[d]);
#pragma unroll
      for (int gi = 0; gi <= GB; ++gi) {
        const float r = d < D / 2 ? -partner[gi] : partner[gi];
        const T y = from_f<T>(__fadd_rn(__fmul_rn(x[gi], c), __fmul_rn(r, sgn)));
        if (gi < GB) {
          sq[gi * D + d] = y;
        } else {
          skn[d] = y;
        }
      }
    }
    __syncthreads();
    if (writer && g0 == 0) {
      const size_t slot = (((size_t)b * a.KVH + kvh) * a.S + pos) * D;
      T* kc = static_cast<T*>(a.k) + slot;
      T* vc = static_cast<T*>(a.v) + slot;
      for (int d = tid; d < D; d += NT) {
        kc[d] = skn[d];
        vc[d] = from_f<T>(svn[d]);
      }
    }
    if (s_lo >= s_hi) {  // the writer split holds no live cache slot
      if (n_live == 0) {  // nor does the row: the new column alone
        for (int i = tid; i < n_heads * D; i += NT) out[i] = from_f<T>(svn[i % D]);
      }
      return;
    }
    // the new column's score per head (warp w: heads w, w + NW)
    for (int gi = w; gi < GB; gi += NW) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        part = fmaf(to_f(sq[gi * D + lane * E + e]), to_f(skn[lane * E + e]), part);
      }
      part = warp_sum(part) * a.scale;
      if (lane == 0) snew[gi] = part;
    }
    decode_init(st, sq, n_heads);
  } else {
    decode_init(st, q, n_heads);
  }

  // ---- the split's slots, the next stage's copies in flight while one is scored
  for (int c = 0; c < n_stages; ++c) {
    if (c + 1 < n_stages) {
      copy_stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = c & 1;
    const int nw = min(8, s_hi - (s_lo + c * ST) - 8 * w);  // of the warp's 8 slots, live
    decode_attend8<kFused>(st, Ks + (buf * ST + 8 * w) * RS, Vs + (buf * ST + 8 * w) * RS, nw,
                           valid_s + (kFused ? buf * ST + 8 * w : 0), a.scale);
    __syncthreads();  // this buffer is refilled in the next iteration
  }

  // ---- the block's merge of its warps; with one live split, the output
  // (K2: the new column joins here)
  const bool direct = n_live == 1;
  decode_block_merge(st, sm_acc, sm,
                     [&](int gi) { return kFused && direct ? snew[gi] : NEG_INF; });
  if (direct) {
    for (int i = tid; i < n_heads * D; i += NT) {
      const int gi = i / D, d = i % D;
      float A = decode_block_acc<D, GB, NW>(sm_acc, sm, gi, d);
      float L = sm.ml[gi][1];
      if constexpr (kFused) {
        const float p_new = expf(snew[gi] - sm.ml[gi][0]);
        A = fmaf(p_new, svn[d], A);
        L += p_new;
      }
      out[i] = from_f<T>(__fdividef(A, L));  // L >= 1: the largest score's weight is 1
    }
    return;
  }

  // ---- this split's partials; the last block of the (row, kv head, head
  // group) merges them all in split order
  const size_t part0 = row_h0 * a.n_splits;  // (row, first head, split 0)
  for (int i = tid; i < n_heads * D; i += NT) {
    const int gi = i / D, d = i % D;
    a.part_acc[(part0 + (size_t)gi * a.n_splits + split) * D + d] =
        decode_block_acc<D, GB, NW>(sm_acc, sm, gi, d);
  }
  if (tid < n_heads) {
    const size_t p = part0 + (size_t)tid * a.n_splits + split;
    a.part_ml[2 * p] = sm.ml[tid][0];
    a.part_ml[2 * p + 1] = sm.ml[tid][1];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = a.tickets + (size_t)b * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(ticket, 1) == n_live - 1;
    if (last) atomicExch(ticket, 0);  // clean for the next call or graph replay
    last_block = last;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int first = lo / split_slots;
  if (tid < n_heads) {
    const float* ml = a.part_ml + 2 * (part0 + (size_t)tid * a.n_splits + first);
    float mx = kFused ? snew[tid] : NEG_INF;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    float L = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float m_s = __ldcg(ml + 2 * s);
      L = fmaf(__ldcg(ml + 2 * s + 1), m_s == NEG_INF ? 0.f : expf(m_s - mx), L);
    }
    if constexpr (kFused) {
      spn[tid] = expf(snew[tid] - mx);
      L += spn[tid];
    }
    sm.ml[tid][0] = mx;
    sm.ml[tid][1] = L;
  }
  __syncthreads();
  for (int i = tid; i < n_heads * D; i += NT) {
    const int gi = i / D, d = i % D;
    const size_t p = part0 + (size_t)gi * a.n_splits + first;
    const float mx = sm.ml[gi][0];
    float A = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float m_s = __ldcg(a.part_ml + 2 * (p + s));
      A = fmaf(__ldcg(a.part_acc + (p + s) * D + d), m_s == NEG_INF ? 0.f : expf(m_s - mx), A);
    }
    if constexpr (kFused) A = fmaf(spn[gi], svn[d], A);
    out[i] = from_f<T>(__fdividef(A, sm.ml[gi][1]));  // L >= 1
  }
}

template <typename T, int D, int GB>
// min 1 block a multiprocessor, as K6's split kernel (which spilled without it)
__global__ void __launch_bounds__(decode_warps<T, D>() * 32, 1)
fused_decode_kernel(const DecArgs a) {
  decode_split<T, D, GB, true>(a);
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(decode_warps<T, D>() * 32, 1)
static_decode_kernel(const DecArgs a) {
  decode_split<T, D, GB, false>(a);
}

template <typename T, int D, int GB, bool kFused>
cudaError_t launch(const DecArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = decode_smem<T, D>();
  void (*kernel)(const DecArgs) = fused_decode_kernel<T, D, GB>;
  if constexpr (!kFused) kernel = static_decode_kernel<T, D, GB>;
  static bool smem_set = false;  // once per instantiation (also keeps it out of graph capture)
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int G = a.H / a.KVH;
  dim3 grid(a.KVH * ((G + GB - 1) / GB), a.n_splits, B);
  kernel<<<grid, decode_warps<T, D>() * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kFused>
cudaError_t launch_d(int D, const DecArgs& a, int B, cudaStream_t stream) {
  const bool g4 = a.H / a.KVH <= 4;
  switch (D) {
    case 64:
      return g4 ? launch<T, 64, 4, kFused>(a, B, stream) : launch<T, 64, 8, kFused>(a, B, stream);
    case 96:  // Phi-3's head_dim: K2 only (K7 serves no path)
      if constexpr (kFused) {
        return g4 ? launch<T, 96, 4, kFused>(a, B, stream)
                  : launch<T, 96, 8, kFused>(a, B, stream);
      }
      return cudaErrorInvalidValue;
    case 128:
      return g4 ? launch<T, 128, 4, kFused>(a, B, stream)
                : launch<T, 128, 8, kFused>(a, B, stream);
    case 256:
      return g4 ? launch<T, 256, 4, kFused>(a, B, stream)
                : launch<T, 256, 8, kFused>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kFused>
int launch_typed(int dtype, int D, DecArgs& a, void* scratch, int B, int split_slots,
                 cudaStream_t stream) {
  if (split_slots <= 0 || a.KVH <= 0 || a.H % a.KVH) return static_cast<int>(cudaErrorInvalidValue);
  a.split_slots = split_slots;
  a.n_splits = (a.S + split_slots - 1) / split_slots;
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = a.part_acc + (size_t)B * a.H * a.n_splits * D;
  cudaError_t err;
  switch (dtype) {
    case TTPU_F32:
      err = launch_d<float, kFused>(D, a, B, stream);
      break;
    case TTPU_BF16:
      err = launch_d<__nv_bfloat16, kFused>(D, a, B, stream);
      break;
    case TTPU_F16:
      err = launch_d<__half, kFused>(D, a, B, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// K2. pos: a device int32, the new token's cache slot. scratch: f32, B * H *
// n_splits * (D + 2) (the partials' acc, then their (m, l)), n_splits =
// ceil(S / split_slots); tickets: int32, B * H, all 0 (and left so). Returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int ttpu_fused_decode(const void* q, const void* k_new, const void* v_new,
                                 const void* cos, const void* sin, void* k_cache,
                                 void* v_cache, const void* start, const void* kv_valid,
                                 const void* pos, void* out, void* scratch, void* tickets, int B,
                                 int H, int KVH, int S, int D, int split_slots, float scale,
                                 int dtype, void* stream) {
  DecArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.cos = cos;
  a.sin = sin;
  a.k = k_cache;
  a.v = v_cache;
  a.start = static_cast<const int*>(start);
  a.kv_valid = static_cast<const int*>(kv_valid);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.tickets = static_cast<int*>(tickets);
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.scale = scale;
  return launch_typed<true>(dtype, D, a, scratch, B, split_slots,
                            static_cast<cudaStream_t>(stream));
}

// K7. window <= 0: no window. scratch and tickets as for K2. Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int ttpu_static_decode(const void* q, const void* k, const void* v,
                                  const void* valid_start, const void* valid_end, void* out,
                                  void* scratch, void* tickets, int B, int H, int KVH, int S,
                                  int D, int window, int split_slots, float scale, int dtype,
                                  void* stream) {
  DecArgs a{};
  a.q = q;
  a.k = const_cast<void*>(k);
  a.v = const_cast<void*>(v);
  a.start = static_cast<const int*>(valid_start);
  a.end = static_cast<const int*>(valid_end);
  a.out = out;
  a.tickets = static_cast<int*>(tickets);
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.window = window;
  a.scale = scale;
  return launch_typed<false>(dtype, D, a, scratch, B, split_slots,
                             static_cast<cudaStream_t>(stream));
}
