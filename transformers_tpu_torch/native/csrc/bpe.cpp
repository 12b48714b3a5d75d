// BPE encoder over token ids: the tokenizer's merge loop on the host.
//
// Port of transformers_tpu/native/csrc/bpe.cpp. The Python engine's plain
// version (transformers_tpu_torch/tokenization/engine.py,
// BPEModel.merge_plain) rescans every adjacent pair after each merge; this
// keeps the pairs in a priority queue over a linked list of symbols, ranks
// first and positions breaking ties left to right, as the scan does.
//
// C ABI for ctypes: create a table of (left_id, right_id) -> (rank,
// merged_id), then encode id sequences.

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct MergeInfo {
  int32_t rank;
  int32_t merged_id;
};

struct BpeHandle {
  std::unordered_map<uint64_t, MergeInfo> ranks;
};

inline uint64_t pair_key(int32_t l, int32_t r) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(l)) << 32) |
         static_cast<uint32_t>(r);
}

struct HeapItem {
  int32_t rank;
  int32_t pos;      // index of the left element at push time
  int32_t left_id;  // snapshot for staleness detection
  int32_t right_id;
  bool operator>(const HeapItem& o) const {
    if (rank != o.rank) return rank > o.rank;
    return pos > o.pos;  // ties broken left-to-right like the scan
  }
};

}  // namespace

extern "C" {

void* ttpu_bpe_create(const int32_t* lefts, const int32_t* rights,
                      const int32_t* merged, int32_t n_merges) {
  auto* h = new BpeHandle();
  h->ranks.reserve(static_cast<size_t>(n_merges) * 2);
  for (int32_t i = 0; i < n_merges; ++i) {
    h->ranks.emplace(pair_key(lefts[i], rights[i]), MergeInfo{i, merged[i]});
  }
  return h;
}

void ttpu_bpe_free(void* handle) { delete static_cast<BpeHandle*>(handle); }

// Encode one word: `ids[0..n)` initial symbol ids -> merged ids written to
// `out` (capacity >= n). Returns the output length.
int32_t ttpu_bpe_encode(void* handle, const int32_t* ids, int32_t n,
                        int32_t* out) {
  auto* h = static_cast<BpeHandle*>(handle);
  if (n <= 1) {
    if (n == 1) out[0] = ids[0];
    return n;
  }
  std::vector<int32_t> sym(ids, ids + n);
  std::vector<int32_t> prev(n), next(n);
  for (int32_t i = 0; i < n; ++i) {
    prev[i] = i - 1;
    next[i] = (i + 1 < n) ? i + 1 : -1;
  }
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap;
  auto push_pair = [&](int32_t pos) {
    int32_t nx = next[pos];
    if (nx < 0) return;
    auto it = h->ranks.find(pair_key(sym[pos], sym[nx]));
    if (it != h->ranks.end()) {
      heap.push(HeapItem{it->second.rank, pos, sym[pos], sym[nx]});
    }
  };
  for (int32_t i = 0; i + 1 < n; ++i) push_pair(i);

  std::vector<bool> alive(n, true);
  while (!heap.empty()) {
    HeapItem item = heap.top();
    heap.pop();
    int32_t pos = item.pos;
    if (!alive[pos]) continue;
    int32_t nx = next[pos];
    if (nx < 0 || sym[pos] != item.left_id || sym[nx] != item.right_id) {
      continue;  // stale entry
    }
    auto it = h->ranks.find(pair_key(sym[pos], sym[nx]));
    if (it == h->ranks.end() || it->second.rank != item.rank) continue;
    // merge nx into pos
    sym[pos] = it->second.merged_id;
    alive[nx] = false;
    int32_t nn = next[nx];
    next[pos] = nn;
    if (nn >= 0) prev[nn] = pos;
    // new neighbor pairs
    if (prev[pos] >= 0) push_pair(prev[pos]);
    push_pair(pos);
  }
  int32_t count = 0;
  for (int32_t i = 0; i >= 0; i = next[i]) out[count++] = sym[i];
  return count;
}

}  // extern "C"
