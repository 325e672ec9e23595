"""Regex → DFA compiler for grammar-guided decoding.

The port's copy of ``arcticinference_tpu/serving/regex_dfa.py`` (numpy
only).

Compiles the regex subset emitted by ``schema_regex.schema_to_regex``
(plus common user patterns for ``guided_regex``) into an explicit DFA
over Unicode codepoints.  The DFA enables the xgrammar/outlines-style
guided-decoding path (reference delegates to vLLM's guided backends,
``tests/benchmarks/test_benchmarks.py:46-76``): per-state *vocab
bitmasks* computed by sweeping the tokenizer vocabulary through the
automaton (``guided_dfa.py`` / ``csrc/token_dfa.cc``), applied to the
logits **on device** so constrained sampling is exact — the model
samples from the true renormalised masked distribution instead of a
host-filtered top-K.

Semantics match ``regex.fullmatch(pattern, text, partial=True)``:

- a state is *live* while some extension of the consumed text can still
  complete a full match;
- ``accept`` marks states whose consumed text IS a full match
  (generation finishes at the first accept, the decoder's greedy-stop
  convention).

Transitions are interval sets over codepoints, so large classes
(``[^"\\]``) stay O(1) edges.  Unsupported constructs (backrefs,
lookaround, word boundaries) raise :class:`UnsupportedRegex` and the
caller falls back to the partial-matching decoder in ``structured.py``.

Character-class escapes (``\\w``/``\\s``/``\\d``) use their ASCII
definitions; patterns relying on Unicode-aware classes fall outside the
compiled subset (the generated JSON grammar never uses them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MAX_CP = 0x10FFFF


class UnsupportedRegex(ValueError):
    """Pattern uses a construct outside the compilable subset."""


# --------------------------------------------------------------------- #
# Codepoint interval sets: sorted, disjoint, inclusive (lo, hi) pairs.
# --------------------------------------------------------------------- #

def _norm(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [ivs[0]]
    for lo, hi in ivs[1:]:
        plo, phi = out[-1]
        if lo <= phi + 1:
            out[-1] = (plo, max(phi, hi))
        else:
            out.append((lo, hi))
    return out


def _complement(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out = []
    prev = 0
    for lo, hi in _norm(ivs):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= MAX_CP:
        out.append((prev, MAX_CP))
    return out


_D = [(48, 57)]
_W = [(48, 57), (65, 90), (95, 95), (97, 122)]
_S = [(9, 13), (32, 32)]
_DOT = _complement([(10, 10)])


# --------------------------------------------------------------------- #
# Parser: pattern -> AST
#   ('lit', intervals) ('cat', [nodes]) ('alt', [nodes])
#   ('rep', node, min, max|None)
# --------------------------------------------------------------------- #

class _Parser:

    def __init__(self, pat: str):
        self.pat = pat
        self.i = 0

    def error(self, msg: str):
        raise UnsupportedRegex(f"{msg} at {self.i} in {self.pat!r}")

    def peek(self) -> str:
        return self.pat[self.i] if self.i < len(self.pat) else ""

    def take(self) -> str:
        ch = self.peek()
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.pat):
            self.error("trailing input")
        return node

    def _alt(self):
        parts = [self._cat()]
        while self.peek() == "|":
            self.take()
            parts.append(self._cat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def _cat(self):
        parts = []
        while True:
            ch = self.peek()
            if ch in ("", "|", ")"):
                break
            parts.append(self._repeat())
        if not parts:
            return ("cat", [])
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                save = self.i
                self.take()
                m, n = self._braces()
                if m is None:           # literal '{'
                    self.i = save
                    break
                node = ("rep", node, m, n)
            else:
                break
            # Lazy / possessive modifiers don't change the language.
            if self.peek() in ("?", "+"):
                self.take()
        return node

    def _braces(self):
        """Parse after '{'; returns (min, max|None) or (None, None) if the
        brace isn't a quantifier (treated as a literal by `regex`)."""
        j = self.i
        digits = ""
        while j < len(self.pat) and self.pat[j].isdigit():
            digits += self.pat[j]
            j += 1
        if j < len(self.pat) and self.pat[j] == "}" and digits:
            self.i = j + 1
            return int(digits), int(digits)
        if j < len(self.pat) and self.pat[j] == ",":
            j += 1
            digits2 = ""
            while j < len(self.pat) and self.pat[j].isdigit():
                digits2 += self.pat[j]
                j += 1
            # '{m,n}', '{m,}', '{,n}' and even '{,}' are all
            # quantifiers in re/regex ('{,}' == {0,inf}); only a brace
            # with no comma and no digits is a literal '{'.
            if j < len(self.pat) and self.pat[j] == "}":
                self.i = j + 1
                m = int(digits) if digits else 0
                n = int(digits2) if digits2 else None
                if n is not None and n < m:
                    # re/regex reject reversed bounds; compiling them as
                    # anything else would enforce the wrong language.
                    raise UnsupportedRegex(
                        f"reversed quantifier bounds {{{m},{n}}}")
                return m, n
        return None, None

    def _atom(self):
        ch = self.take()
        if ch == "(":
            if self.peek() == "?":
                self.take()
                nxt = self.peek()
                if nxt == ":":
                    self.take()
                elif nxt == "P":
                    self.take()
                    if self.take() != "<":
                        self.error("unsupported (?P...) form")
                    while self.peek() not in (">", ""):
                        self.take()
                    if self.take() != ">":
                        self.error("unterminated group name")
                else:
                    self.error(f"unsupported group (?{nxt}")
            node = self._alt()
            if self.take() != ")":
                self.error("unbalanced group")
            return node
        if ch == "[":
            return ("lit", self._char_class())
        if ch == ".":
            return ("lit", _DOT)
        if ch == "\\":
            return ("lit", self._escape(in_class=False))
        if ch in ("*", "+", "?"):
            self.error(f"dangling quantifier {ch!r}")
        if ch in ("^", "$"):
            # Anchors are no-ops for fullmatch semantics at the ends;
            # elsewhere they make the language empty — unsupported.
            if (ch == "^" and self.i == 1) or \
                    (ch == "$" and self.i == len(self.pat)):
                return ("cat", [])
            self.error(f"mid-pattern anchor {ch!r}")
        return ("lit", [(ord(ch), ord(ch))])

    def _escape(self, in_class: bool) -> list[tuple[int, int]]:
        ch = self.take()
        if ch == "":
            self.error("trailing backslash")
        if ch == "d":
            return list(_D)
        if ch == "D":
            return _complement(_D)
        if ch == "w":
            return list(_W)
        if ch == "W":
            return _complement(_W)
        if ch == "s":
            return list(_S)
        if ch == "S":
            return _complement(_S)
        simple = {"n": 10, "r": 13, "t": 9, "f": 12, "v": 11, "a": 7,
                  "e": 27, "0": 0}
        if ch in simple:
            c = simple[ch]
            return [(c, c)]
        if ch == "x":
            h = self.take() + self.take()
            try:
                c = int(h, 16)
            except ValueError:
                self.error(f"bad \\x escape {h!r}")
            return [(c, c)]
        if ch == "u":
            h = "".join(self.take() for _ in range(4))
            try:
                c = int(h, 16)
            except ValueError:
                self.error(f"bad \\u escape {h!r}")
            return [(c, c)]
        if ch in ("b", "B", "A", "Z", "z", "G", "K"):
            self.error(f"unsupported escape \\{ch}")
        if ch.isdigit():
            self.error(f"backreference \\{ch}")
        if ch.isalpha():
            self.error(f"unknown escape \\{ch}")
        return [(ord(ch), ord(ch))]

    def _char_class(self) -> list[tuple[int, int]]:
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        ivs: list[tuple[int, int]] = []
        first = True
        while True:
            ch = self.peek()
            if ch == "":
                self.error("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                sub = self._escape(in_class=True)
                if len(sub) == 1 and sub[0][0] == sub[0][1] and \
                        self.peek() == "-" and \
                        self.i + 1 < len(self.pat) and \
                        self.pat[self.i + 1] != "]":
                    self.take()
                    hi = self._class_endpoint()
                    ivs.append((sub[0][0], hi))
                else:
                    ivs.extend(sub)
                continue
            self.take()
            lo = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.pat) and \
                    self.pat[self.i + 1] != "]":
                self.take()
                hi = self._class_endpoint()
                ivs.append((lo, hi))
            else:
                ivs.append((lo, lo))
        ivs = _norm(ivs)
        return _complement(ivs) if negate else ivs

    def _class_endpoint(self) -> int:
        ch = self.take()
        if ch == "\\":
            sub = self._escape(in_class=True)
            if len(sub) != 1 or sub[0][0] != sub[0][1]:
                self.error("class shorthand as range endpoint")
            return sub[0][0]
        return ord(ch)


# --------------------------------------------------------------------- #
# Thompson NFA
# --------------------------------------------------------------------- #

class _Nfa:

    def __init__(self, max_states: int):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[int, int, int]]] = []
        self.max_states = max_states

    def new(self) -> int:
        if len(self.eps) >= self.max_states:
            raise UnsupportedRegex("NFA too large (quantifier blowup)")
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node) -> tuple[int, int]:
        """Returns (entry, exit) fragment states."""
        kind = node[0]
        if kind == "lit":
            s, t = self.new(), self.new()
            for lo, hi in node[1]:
                self.edges[s].append((lo, hi, t))
            return s, t
        if kind == "cat":
            s = t = self.new()
            for sub in node[1]:
                a, b = self.build(sub)
                self.eps[t].append(a)
                t = b
            return s, t
        if kind == "alt":
            s, t = self.new(), self.new()
            for sub in node[1]:
                a, b = self.build(sub)
                self.eps[s].append(a)
                self.eps[b].append(t)
            return s, t
        if kind == "rep":
            _, sub, m, n = node
            s = t = self.new()
            for _ in range(m):
                a, b = self.build(sub)
                self.eps[t].append(a)
                t = b
            if n is None:               # unbounded tail: one looping copy
                a, b = self.build(sub)
                self.eps[t].append(a)
                self.eps[b].append(a)
                end = self.new()
                self.eps[t].append(end)
                self.eps[b].append(end)
                return s, end
            for _ in range(n - m):      # optional copies
                a, b = self.build(sub)
                self.eps[t].append(a)
                nt = self.new()
                self.eps[t].append(nt)
                self.eps[b].append(nt)
                t = nt
            return s, t
        raise AssertionError(kind)


# --------------------------------------------------------------------- #
# DFA (subset construction)
# --------------------------------------------------------------------- #

class Dfa:
    """Explicit DFA with interval transitions.

    Arrays (ctypes/device-exportable):
      ``accept``       bool[S]
      ``trans_offsets`` int32[S+1] — state s owns rows [offs[s], offs[s+1])
      ``trans_lo/hi``  uint32[I]   — inclusive codepoint intervals, sorted
      ``trans_next``   int32[I]
    Dead state is represented as -1 (no explicit sink row).
    """

    def __init__(self, accept, offsets, lo, hi, nxt, pattern: str):
        self.accept = accept
        self.trans_offsets = offsets
        self.trans_lo = lo
        self.trans_hi = hi
        self.trans_next = nxt
        self.pattern = pattern
        self.start = 0
        self.n_states = len(accept)

    def step(self, state: int, cp: int) -> int:
        if state < 0:
            return -1
        a, b = self.trans_offsets[state], self.trans_offsets[state + 1]
        j = int(np.searchsorted(self.trans_lo[a:b], cp, side="right")) - 1
        if j >= 0 and cp <= self.trans_hi[a + j]:
            return int(self.trans_next[a + j])
        return -1

    def walk(self, state: int, text: str) -> int:
        for ch in text:
            state = self.step(state, ord(ch))
            if state < 0:
                return -1
        return state

    def is_accept(self, state: int) -> bool:
        return state >= 0 and bool(self.accept[state])


def compile_dfa(pattern: str, max_states: int = 20000,
                max_nfa: int = 200000) -> Dfa:
    """Compile ``pattern`` (fullmatch semantics) to a :class:`Dfa`.

    Raises :class:`UnsupportedRegex` for constructs outside the subset or
    when the automaton exceeds the state caps.
    """
    ast = _Parser(pattern).parse()
    nfa = _Nfa(max_nfa)
    start, final = nfa.build(ast)

    eps = nfa.eps

    def closure(states: frozenset[int]) -> frozenset[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    index: dict[frozenset[int], int] = {start_set: 0}
    ordered = [start_set]
    accept = [final in start_set]
    trans: list[list[tuple[int, int, int]]] = [[]]

    qi = 0
    while qi < len(ordered):
        cur = ordered[qi]
        my = trans[qi]
        qi += 1
        # Local alphabet partition from this state's outgoing edges.
        edges = [e for s in cur for e in nfa.edges[s]]
        if not edges:
            continue
        bounds = set()
        for lo, hi, _ in edges:
            bounds.add(lo)
            bounds.add(hi + 1)
        bl = sorted(bounds)
        for i in range(len(bl) - 1):
            lo, hi = bl[i], bl[i + 1] - 1
            tgt = frozenset(t for elo, ehi, t in edges
                            if elo <= lo and hi <= ehi)
            if not tgt:
                continue
            tgt = closure(tgt)
            j = index.get(tgt)
            if j is None:
                if len(ordered) >= max_states:
                    raise UnsupportedRegex(
                        f"DFA exceeds {max_states} states")
                j = len(ordered)
                index[tgt] = j
                ordered.append(tgt)
                accept.append(final in tgt)
                trans.append([])
            my.append((lo, hi, j))

    # Co-accessibility prune: drop states that cannot reach an accept
    # state (partial-match semantics: a prefix is live only if some
    # extension completes a full match; without the prune a mask could
    # admit a token that wedges generation in a dead-end).
    n = len(ordered)
    rev: list[list[int]] = [[] for _ in range(n)]
    for i, tlist in enumerate(trans):
        for _, _, j in tlist:
            rev[j].append(i)
    coacc = [bool(a) for a in accept]
    stack = [i for i in range(n) if coacc[i]]
    while stack:
        j = stack.pop()
        for i in rev[j]:
            if not coacc[i]:
                coacc[i] = True
                stack.append(i)
    if not coacc[0]:
        raise UnsupportedRegex("pattern matches nothing")
    remap = np.full(n, -1, np.int64)
    keep = [i for i in range(n) if coacc[i]]
    for new, old in enumerate(keep):
        remap[old] = new
    accept = [accept[i] for i in keep]
    trans = [[(lo, hi, int(remap[j])) for lo, hi, j in trans[i]
              if coacc[j]] for i in keep]

    offsets = np.zeros(len(accept) + 1, np.int32)
    rows = []
    for i, tlist in enumerate(trans):
        # Merge adjacent segments that lead to the same target state.
        tlist.sort()
        merged: list[tuple[int, int, int]] = []
        for lo, hi, j in tlist:
            if merged and merged[-1][2] == j and merged[-1][1] + 1 == lo:
                merged[-1] = (merged[-1][0], hi, j)
            else:
                merged.append((lo, hi, j))
        rows.extend(merged)
        offsets[i + 1] = len(rows)
    lo = np.asarray([r[0] for r in rows], np.uint32)
    hi = np.asarray([r[1] for r in rows], np.uint32)
    nxt = np.asarray([r[2] for r in rows], np.int32)
    return Dfa(np.asarray(accept, bool), offsets, lo, hi, nxt, pattern)
