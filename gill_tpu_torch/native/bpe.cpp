// Byte-pair-encoding merge engine (tokenizer hot path).
//
// The Python layer does the (cheap, cached) regex split and byte->unicode
// mapping, and hands each pretoken to this engine as a sequence of initial
// symbol ids; the O(n * merges) merge loop — the hot part when tokenizing
// CC3M-scale caption corpora — runs here. Merge rules are provided as
// (left_id, right_id) -> merged_id triples ranked by priority, which is a
// faithful int-space encoding of GPT-2/CLIP BPE (every merge result is
// itself a vocab entry).
//
// C ABI only (loaded via ctypes; no pybind11 in this image).

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct Rule {
  int32_t merged;
  int32_t rank;
};

struct Engine {
  // key: (uint64)left << 32 | right
  std::unordered_map<uint64_t, Rule> rules;
};

inline uint64_t key(int32_t left, int32_t right) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(left)) << 32) |
         static_cast<uint32_t>(right);
}

}  // namespace

extern "C" {

void* bpe_new(const int32_t* left, const int32_t* right,
              const int32_t* merged, int32_t n) {
  auto* e = new Engine();
  e->rules.reserve(static_cast<size_t>(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    e->rules.emplace(key(left[i], right[i]), Rule{merged[i], i});
  }
  return e;
}

void bpe_free(void* handle) { delete static_cast<Engine*>(handle); }

// Encodes one pretoken: applies merges in rank order until none apply.
// Returns the output length (<= n). out must have capacity n.
int32_t bpe_encode(void* handle, const int32_t* syms, int32_t n,
                   int32_t* out) {
  auto* e = static_cast<Engine*>(handle);
  std::vector<int32_t> word(syms, syms + n);
  while (word.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_pos = 0;
    int32_t best_merged = -1;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = e->rules.find(key(word[i], word[i + 1]));
      if (it != e->rules.end() && it->second.rank < best_rank) {
        best_rank = it->second.rank;
        best_pos = i;
        best_merged = it->second.merged;
      }
    }
    if (best_merged < 0) break;
    // Merge ALL occurrences of this pair (left-to-right, non-overlapping),
    // matching the reference BPE semantics.
    std::vector<int32_t> next;
    next.reserve(word.size());
    int32_t l = word[best_pos], r = word[best_pos + 1];
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && word[i] == l && word[i + 1] == r) {
        next.push_back(best_merged);
        i += 2;
      } else {
        next.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(next);
  }
  for (size_t i = 0; i < word.size(); ++i) out[i] = word[i];
  return static_cast<int32_t>(word.size());
}

}  // extern "C"
