// Online multi-sequence suffix tree for suffix decoding (host code).
//
// The port's copy of arcticinference_tpu/csrc/suffix_tree.cc, unchanged
// below this header, so both packages draft the same tokens.  A rebuild
// of the data structure behind ArcticInference's suffix decoding
// (reference: csrc/suffix_cache/suffix_tree.{h,cc}).  Same
// capability — amortized O(depth) online insertion with a per-sequence
// sliding window of active suffixes, greedy path speculation and best-first
// tree speculation — but a different implementation: nodes live in a
// contiguous arena addressed by int32 ids (cache-friendly, trivially
// serialisable, no per-node heap allocation), and the interface is a flat
// C ABI consumed through ctypes from the host-side Python scheduler.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC suffix_tree.cc -o libsuffixtree.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t kNil = -1;

// One tree node.  The node's edge label is tokens
// seqs[seq_id][start : start + length].  `hits` counts how many window
// suffixes end at or pass through this node; child edges are keyed by their
// first token.
struct Node {
  int32_t parent = kNil;
  int32_t seq_id = kNil;
  int32_t start = 0;
  int32_t length = 0;
  int64_t hits = 0;
  std::unordered_map<int32_t, int32_t> children;
};

struct SpecResult {
  std::vector<int32_t> tokens;
  std::vector<int32_t> parents;
  std::vector<float> probs;
  float score = 0.0f;
  int32_t match_len = 0;
};

class SuffixTree {
 public:
  explicit SuffixTree(int max_depth) : max_depth_(max_depth) {
    root_ = new_node();
  }

  int num_seqs() const { return static_cast<int>(seqs_.size()); }

  void append(int32_t seq_id, int32_t token) {
    auto& seq = seqs_[seq_id];
    auto& window = active_[seq_id];
    // Start tracking a fresh suffix rooted at the root; retire the oldest
    // once more than max_depth suffixes are live, which bounds tree depth.
    window.push_back(root_);
    node(root_).hits += 1;
    if (static_cast<int>(window.size()) > max_depth_) window.pop_front();
    seq.push_back(token);
    const int32_t end = static_cast<int32_t>(seq.size());

    for (auto& locus : window) {
      locus = advance(locus, seq_id, token, end);
    }
  }

  void extend(int32_t seq_id, const int32_t* tokens, int n) {
    for (int i = 0; i < n; ++i) append(seq_id, tokens[i]);
  }

  // Try every suffix of `pattern` (longest first would be equivalent; we take
  // the best-scoring continuation over all match lengths, like the reference
  // suffix_tree.cc:135-165).
  SpecResult speculate(const int32_t* pattern, int n, int max_spec_tokens,
                       float max_spec_factor, float max_spec_offset,
                       float min_token_prob, bool tree_spec) const {
    SpecResult best;
    int lo = std::max(n - max_depth_, 0);
    for (int s = lo; s < n; ++s) {
      const int match_len = n - s;
      // Exact branch-and-bound: a candidate's score is a sum of
      // per-token probabilities <= 1 over at most
      // min(max_spec_tokens, match_len*factor+offset) tokens, and that
      // bound decreases monotonically as the match shortens.  Once the
      // incumbent reaches the bound, no later (shorter-match) start can
      // strictly beat it, so stop — in the hot serving case (a full-
      // depth match whose path carries probability 1.0) this prunes the
      // entire remaining O(depth^2) scan after the first start.
      int bound = std::min(
          max_spec_tokens,
          static_cast<int>(match_len * max_spec_factor + max_spec_offset +
                           1e-6f));
      if (bound < 0) bound = 0;
      // (monotonicity needs factor >= 0; a negative factor is
      // pathological config but must not mis-prune)
      if (max_spec_factor >= 0.0f &&
          best.score >= static_cast<float>(bound)) {
        break;
      }
      int32_t nid;
      int32_t off;
      if (!walk(pattern + s, n - s, &nid, &off)) continue;
      int budget = bound;
      SpecResult cand = tree_spec
                            ? speculate_tree(nid, off, budget, min_token_prob)
                            : speculate_path(nid, off, budget, min_token_prob);
      if (cand.score > best.score) {
        best = std::move(cand);
        best.match_len = match_len;
      }
    }
    return best;
  }

 private:
  Node& node(int32_t id) { return arena_[id]; }
  const Node& node(int32_t id) const { return arena_[id]; }

  int32_t new_node() {
    arena_.emplace_back();
    return static_cast<int32_t>(arena_.size()) - 1;
  }

  int32_t first_token(int32_t id) const {
    const Node& nd = node(id);
    return seqs_.at(nd.seq_id)[nd.start];
  }

  // Move one suffix locus forward by `token`.  Loci always sit at the end of
  // a node's edge label; the cases below restore that invariant after the
  // extension, splitting / extending / fusing edges as needed.
  int32_t advance(int32_t locus, int32_t seq_id, int32_t token, int32_t end) {
    Node& nd = node(locus);
    auto it = nd.children.find(token);

    if (it == nd.children.end()) {
      if (nd.hits == 1 && locus != root_) {
        // Sole-owner leaf: grow its label in place.
        nd.length += 1;
        nd.seq_id = seq_id;
        nd.start = end - nd.length;
        return locus;
      }
      // Branch: new leaf holding just this token.
      int32_t leaf = new_node();
      Node& lf = node(leaf);
      lf.parent = locus;
      lf.hits = 1;
      lf.seq_id = seq_id;
      lf.start = end - 1;
      lf.length = 1;
      node(locus).children.emplace(token, leaf);
      return leaf;
    }

    int32_t child = it->second;
    Node& ch = node(child);

    if (locus != root_ && nd.hits == ch.hits + 1 &&
        nd.children.size() == 1) {
      // Exactly one suffix terminates at this node and everything else
      // continues into its single child: slide the node/child boundary one
      // token to the right instead of splitting.
      if (ch.length == 1) {
        // Child collapses into the extended node: merge the two edges.
        int32_t parent = nd.parent;
        ch.hits += 1;
        ch.length = nd.length + 1;
        ch.seq_id = seq_id;
        ch.start = end - ch.length;
        ch.parent = parent;
        int32_t edge_tok =
            seqs_.at(node(child).seq_id)[node(child).start];
        node(parent).children[edge_tok] = child;
        // `locus` node is now orphaned; recycle it lazily (arena keeps it).
        free_list_.push_back(locus);
        node(locus).children.clear();
        return child;
      }
      nd.length += 1;
      nd.seq_id = seq_id;
      nd.start = end - nd.length;
      ch.start += 1;
      ch.length -= 1;
      int32_t new_key = seqs_.at(ch.seq_id)[ch.start];
      if (new_key != token) {
        Node& parent_again = node(locus);
        parent_again.children.erase(token);
        parent_again.children.emplace(new_key, child);
      }
      return locus;
    }

    if (ch.length == 1) {
      ch.hits += 1;
      return child;
    }
    // Split the child's edge after its first token; locus lands on the new
    // intermediate node.
    int32_t mid = new_node();
    Node& md = node(mid);
    Node& ch2 = node(child);
    md.parent = locus;
    md.hits = ch2.hits + 1;
    md.seq_id = seq_id;
    md.start = end - 1;
    md.length = 1;
    int32_t rest_key = seqs_.at(ch2.seq_id)[ch2.start + 1];
    md.children.emplace(rest_key, child);
    node(locus).children[token] = mid;
    ch2.parent = mid;
    ch2.start += 1;
    ch2.length -= 1;
    return mid;
  }

  // Follow `pattern` from the root; returns the (node, offset) locus of the
  // full match or false if the pattern is absent.
  bool walk(const int32_t* pattern, int n, int32_t* out_node,
            int32_t* out_off) const {
    int32_t nid = root_;
    int32_t off = 0;
    for (int i = 0; i < n; ++i) {
      const Node* nd = &node(nid);
      if (off >= nd->length) {
        auto it = nd->children.find(pattern[i]);
        if (it == nd->children.end()) return false;
        nid = it->second;
        nd = &node(nid);
        off = 0;
      }
      if (seqs_.at(nd->seq_id)[nd->start + off] != pattern[i]) return false;
      off += 1;
    }
    *out_node = nid;
    *out_off = off;
    return true;
  }

  // Greedy single-path continuation: at each branch follow the most frequent
  // child; token probability is the product of branch frequencies.
  SpecResult speculate_path(int32_t nid, int32_t off, int budget,
                            float min_prob) const {
    SpecResult out;
    float p = 1.0f;
    while (static_cast<int>(out.tokens.size()) < budget && p >= min_prob) {
      const Node& nd = node(nid);
      if (off < nd.length) {
        out.parents.push_back(static_cast<int32_t>(out.tokens.size()) - 1);
        out.tokens.push_back(seqs_.at(nd.seq_id)[nd.start + off]);
        out.probs.push_back(p);
        out.score += p;
        off += 1;
        continue;
      }
      int32_t best_child = kNil;
      int64_t best_hits = 0;
      for (const auto& kv : nd.children) {
        if (node(kv.second).hits > best_hits) {
          best_hits = node(kv.second).hits;
          best_child = kv.second;
        }
      }
      if (best_child == kNil) break;
      p *= static_cast<float>(best_hits) / static_cast<float>(nd.hits);
      nid = best_child;
      off = 0;
    }
    return out;
  }

  // Best-first expansion producing a token *tree* (parent-linked), highest
  // estimated probability first.
  SpecResult speculate_tree(int32_t nid, int32_t off, int budget,
                            float min_prob) const {
    SpecResult out;
    struct Item {
      float prob;
      int32_t nid;
      int32_t off;
      int32_t parent;
    };
    auto cmp = [](const Item& a, const Item& b) { return a.prob < b.prob; };
    std::priority_queue<Item, std::vector<Item>, decltype(cmp)> pq(cmp);
    pq.push({1.0f, nid, off, kNil});
    while (static_cast<int>(out.tokens.size()) < budget && !pq.empty()) {
      Item item = pq.top();
      pq.pop();
      const Node& nd = node(item.nid);
      if (item.off < nd.length) {
        out.tokens.push_back(seqs_.at(nd.seq_id)[nd.start + item.off]);
        out.parents.push_back(item.parent);
        out.probs.push_back(item.prob);
        out.score += item.prob;
        pq.push({item.prob, item.nid, item.off + 1,
                 static_cast<int32_t>(out.tokens.size()) - 1});
      } else {
        for (const auto& kv : nd.children) {
          float p = item.prob * static_cast<float>(node(kv.second).hits) /
                    static_cast<float>(nd.hits);
          if (p >= min_prob) pq.push({p, kv.second, 0, item.parent});
        }
      }
    }
    return out;
  }

  int max_depth_;
  int32_t root_;
  std::vector<Node> arena_;
  std::vector<int32_t> free_list_;
  std::unordered_map<int32_t, std::vector<int32_t>> seqs_;
  std::unordered_map<int32_t, std::deque<int32_t>> active_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

#define SXT_EXPORT __attribute__((visibility("default")))

extern "C" {

SXT_EXPORT void* sxt_new(int max_depth) { return new SuffixTree(max_depth); }

SXT_EXPORT void sxt_free(void* tree) { delete static_cast<SuffixTree*>(tree); }

SXT_EXPORT int sxt_num_seqs(void* tree) {
  return static_cast<SuffixTree*>(tree)->num_seqs();
}

SXT_EXPORT void sxt_append(void* tree, int seq_id, int token) {
  static_cast<SuffixTree*>(tree)->append(seq_id, token);
}

SXT_EXPORT void sxt_extend(void* tree, int seq_id, const int32_t* tokens,
                           int n) {
  static_cast<SuffixTree*>(tree)->extend(seq_id, tokens, n);
}

// Speculate a continuation of `pattern`.  Output arrays must have space for
// `max_spec_tokens` entries.  Returns the number of speculated tokens and
// writes the candidate's score / match_len through the out pointers.
SXT_EXPORT int sxt_speculate(void* tree, const int32_t* pattern, int n,
                  int max_spec_tokens, float max_spec_factor,
                  float max_spec_offset, float min_token_prob, int tree_spec,
                  int32_t* out_tokens, int32_t* out_parents, float* out_probs,
                  float* out_score, int* out_match_len) {
  SpecResult r = static_cast<SuffixTree*>(tree)->speculate(
      pattern, n, max_spec_tokens, max_spec_factor, max_spec_offset,
      min_token_prob, tree_spec != 0);
  int m = static_cast<int>(r.tokens.size());
  std::memcpy(out_tokens, r.tokens.data(), m * sizeof(int32_t));
  std::memcpy(out_parents, r.parents.data(), m * sizeof(int32_t));
  std::memcpy(out_probs, r.probs.data(), m * sizeof(float));
  *out_score = r.score;
  *out_match_len = r.match_len;
  return m;
}

// Batched speculate over `b` items — one ctypes round-trip per serving
// step instead of two per slot.  Each item walks its private prompt tree
// (entry may be NULL) and then the shared response tree, keeping the
// better-scoring candidate: the SuffixCache.speculate composition
// (suffix_cache.py:139-148) moved into native code, because at batch
// 32-64 the per-call ctypes/marshalling overhead (~20us) dominated the
// walks themselves.  `patterns` is a padded [b, pat_stride] row matrix;
// outputs are [b, cap_stride] rows.  All trees are only *read*.
SXT_EXPORT void sxt_speculate_batch(
    void* response_tree, void** prompt_trees, const int32_t* patterns,
    const int32_t* pat_lens, int b, int pat_stride,
    const int32_t* max_spec_tokens, float max_spec_factor,
    float max_spec_offset, float min_token_prob, int tree_spec,
    int cap_stride, int32_t* out_tokens, int32_t* out_parents,
    float* out_probs, float* out_scores, int32_t* out_match_lens,
    int32_t* out_ns) {
  SuffixTree* resp = static_cast<SuffixTree*>(response_tree);
  for (int i = 0; i < b; ++i) {
    const int32_t* pat = patterns + static_cast<std::ptrdiff_t>(i) * pat_stride;
    const int n = pat_lens[i];
    const int cap = max_spec_tokens[i];
    SpecResult best;
    SuffixTree* prompt = static_cast<SuffixTree*>(prompt_trees[i]);
    if (prompt != nullptr) {
      best = prompt->speculate(pat, n, cap, max_spec_factor,
                               max_spec_offset, min_token_prob,
                               tree_spec != 0);
    }
    SpecResult cand = resp->speculate(pat, n, cap, max_spec_factor,
                                      max_spec_offset, min_token_prob,
                                      tree_spec != 0);
    if (cand.score > best.score) best = std::move(cand);
    const int m = static_cast<int>(best.tokens.size());
    const std::ptrdiff_t row = static_cast<std::ptrdiff_t>(i) * cap_stride;
    std::memcpy(out_tokens + row, best.tokens.data(), m * sizeof(int32_t));
    std::memcpy(out_parents + row, best.parents.data(),
                m * sizeof(int32_t));
    std::memcpy(out_probs + row, best.probs.data(), m * sizeof(float));
    out_scores[i] = best.score;
    out_match_lens[i] = best.match_len;
    out_ns[i] = m;
  }
}

}  // extern "C"
