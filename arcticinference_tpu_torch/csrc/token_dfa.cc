// Token-level DFA sweeper for grammar-guided decoding.
//
// Given a codepoint DFA (compiled in Python, serving/regex_dfa.py) and
// the tokenizer vocabulary (each token as a codepoint sequence), computes
// per-DFA-state *vocab bitmasks*: bit t set iff feeding token t's text
// from that state keeps the automaton alive.  The masks are applied to
// the logits on device so constrained sampling is exact (the
// xgrammar/outlines bitmask design the reference inherits from vLLM's
// guided-decoding backends).
//
// The sweep walks a trie over the vocabulary (built once per
// vocab+DFA pairing) in product with the DFA, so shared token prefixes
// are walked once and dead branches prune whole subtrees — O(live trie
// nodes) per state instead of O(vocab * token_len).
//
// Plain C ABI (ctypes, no pybind11), mirroring csrc/suffix_tree.cc.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct TokenDfa {
  // DFA ------------------------------------------------------------
  int32_t n_states = 0;
  std::vector<uint8_t> accept;
  std::vector<int32_t> offs;   // [S+1] into lo/hi/nxt
  std::vector<uint32_t> lo, hi;
  std::vector<int32_t> nxt;

  // Vocab trie ------------------------------------------------------
  int32_t vocab = 0;
  std::vector<int64_t> tok_offs;     // [V+1] into tok_cps
  std::vector<uint32_t> tok_cps;
  std::vector<int32_t> child_head;   // per node: first child edge (-1)
  std::vector<int32_t> edge_next;    // per edge: next sibling edge (-1)
  std::vector<uint32_t> edge_cp;     // per edge: codepoint
  std::vector<int32_t> edge_node;    // per edge: target node
  std::vector<int32_t> term_head;    // per node: head into term lists
  std::vector<int32_t> term_tok, term_next;

  int32_t dfa_step(int32_t state, uint32_t cp) const {
    const int32_t a = offs[state], b = offs[state + 1];
    // Binary search for the last interval with lo <= cp.
    int32_t l = a, r = b;
    while (l < r) {
      const int32_t m = (l + r) / 2;
      if (lo[m] <= cp)
        l = m + 1;
      else
        r = m;
    }
    if (l > a && cp <= hi[l - 1]) return nxt[l - 1];
    return -1;
  }
};

struct StackItem {
  int32_t edge;
  int32_t state;
};

}  // namespace

#define TDFA_EXPORT __attribute__((visibility("default")))

extern "C" {

// Builds the combined DFA + vocab-trie structure.
//  tokens are flattened codepoint sequences: token t owns
//  cps[tok_offs[t] : tok_offs[t+1]].  Zero-length tokens are never
//  allowed by any mask (they would stall the automaton).
TDFA_EXPORT void* tdfa_create(int32_t n_states, const uint8_t* accept,
                  const int32_t* offs, const uint32_t* lo,
                  const uint32_t* hi, const int32_t* nxt, int32_t n_trans,
                  int32_t vocab, const int64_t* tok_offs,
                  const uint32_t* cps) {
  auto* d = new TokenDfa();
  d->n_states = n_states;
  d->accept.assign(accept, accept + n_states);
  d->offs.assign(offs, offs + n_states + 1);
  d->lo.assign(lo, lo + n_trans);
  d->hi.assign(hi, hi + n_trans);
  d->nxt.assign(nxt, nxt + n_trans);
  d->vocab = vocab;
  d->tok_offs.assign(tok_offs, tok_offs + vocab + 1);
  d->tok_cps.assign(cps, cps + tok_offs[vocab]);

  d->child_head.push_back(-1);  // root
  d->term_head.push_back(-1);
  std::unordered_map<uint64_t, int32_t> edge_map;
  edge_map.reserve(size_t(vocab) * 2);
  for (int32_t t = 0; t < vocab; ++t) {
    int32_t node = 0;
    const int64_t a = tok_offs[t], b = tok_offs[t + 1];
    if (a == b) continue;  // zero-length token: excluded
    for (int64_t i = a; i < b; ++i) {
      const uint32_t cp = cps[i];
      const uint64_t key = (uint64_t(node) << 21) | cp;
      auto it = edge_map.find(key);
      if (it == edge_map.end()) {
        const int32_t nn = int32_t(d->child_head.size());
        d->child_head.push_back(-1);
        d->term_head.push_back(-1);
        const int32_t ne = int32_t(d->edge_cp.size());
        d->edge_cp.push_back(cp);
        d->edge_node.push_back(nn);
        d->edge_next.push_back(d->child_head[node]);
        d->child_head[node] = ne;
        edge_map.emplace(key, nn);
        node = nn;
      } else {
        node = it->second;
      }
    }
    d->term_next.push_back(d->term_head[node]);
    d->term_tok.push_back(t);
    d->term_head[node] = int32_t(d->term_tok.size()) - 1;
  }
  return d;
}

TDFA_EXPORT void tdfa_destroy(void* h) { delete static_cast<TokenDfa*>(h); }

// Vocab bitmask for `state`: out_words must hold ceil(vocab/32) u32,
// zero-filled by the callee.  Returns the number of allowed tokens.
TDFA_EXPORT int64_t tdfa_mask(void* h, int32_t state, uint32_t* out_words) {
  const auto* d = static_cast<TokenDfa*>(h);
  std::memset(out_words, 0, size_t((d->vocab + 31) / 32) * 4);
  if (state < 0 || state >= d->n_states) return 0;
  int64_t count = 0;
  std::vector<StackItem> stack;
  stack.reserve(256);
  for (int32_t e = d->child_head[0]; e >= 0; e = d->edge_next[e])
    stack.push_back({e, state});
  while (!stack.empty()) {
    const StackItem it = stack.back();
    stack.pop_back();
    const int32_t ns = d->dfa_step(it.state, d->edge_cp[it.edge]);
    if (ns < 0) continue;  // dead: prune the whole subtree
    const int32_t node = d->edge_node[it.edge];
    for (int32_t t = d->term_head[node]; t >= 0; t = d->term_next[t]) {
      const int32_t tok = d->term_tok[t];
      out_words[tok >> 5] |= (1u << (tok & 31));
      ++count;
    }
    for (int32_t e = d->child_head[node]; e >= 0; e = d->edge_next[e])
      stack.push_back({e, ns});
  }
  return count;
}

// Advance `state` by token `tok`'s codepoints; -1 when dead/invalid.
TDFA_EXPORT int32_t tdfa_advance(void* h, int32_t state, int32_t tok) {
  const auto* d = static_cast<TokenDfa*>(h);
  if (state < 0 || tok < 0 || tok >= d->vocab) return -1;
  for (int64_t i = d->tok_offs[tok]; i < d->tok_offs[tok + 1]; ++i) {
    state = d->dfa_step(state, d->tok_cps[i]);
    if (state < 0) return -1;
  }
  return state;
}

// Masks for every state in [s_begin, s_end): out holds
// (s_end - s_begin) * ceil(vocab/32) u32 rows (device mask-table export
// for pipelined guided decoding).
TDFA_EXPORT void tdfa_all_masks(void* h, int32_t s_begin, int32_t s_end,
                                uint32_t* out) {
  const auto* d = static_cast<TokenDfa*>(h);
  const size_t words = size_t((d->vocab + 31) / 32);
  for (int32_t s = s_begin; s < s_end; ++s)
    tdfa_mask(h, s, out + size_t(s - s_begin) * words);
}

// Whether `state` is an accept state (consumed text IS a full match).
TDFA_EXPORT int32_t tdfa_is_accept(void* h, int32_t state) {
  const auto* d = static_cast<TokenDfa*>(h);
  return state >= 0 && state < d->n_states && d->accept[state] ? 1 : 0;
}

}  // extern "C"
