"""SuffixTree: ctypes binding to the native arena tree + a pure-Python twin.

The port's copy of ``arcticinference_tpu/spec/suffix_tree.py``.  The
native library (``csrc/suffix_tree.cc``, built by ``spec/build.py``) is the
engine's path: it runs in the host scheduler, off the device's critical
path.  The pure-Python twin is an independent oracle for differential
tests, and is chosen only on request (``force_python=True`` or
``ARCTIC_TPU_PURE_PYTHON_SUFFIX=1``): a native build that fails raises
with the compiler's output rather than handing back the twin.
"""

from __future__ import annotations

import ctypes
import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from arcticinference_tpu_torch import envs

PURE_PYTHON_ENV = "ARCTIC_TPU_PURE_PYTHON_SUFFIX"


@dataclass
class Candidate:
    """A speculation candidate (token tree encoded by parent links)."""

    token_ids: list[int] = field(default_factory=list)
    parents: list[int] = field(default_factory=list)
    probs: list[float] = field(default_factory=list)
    score: float = 0.0
    match_len: int = 0


# ---------------------------------------------------------------------------
# Native binding
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def load_native() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    from arcticinference_tpu_torch.spec.build import build

    lib = ctypes.CDLL(str(build()))
    lib.sxt_new.restype = ctypes.c_void_p
    lib.sxt_new.argtypes = [ctypes.c_int]
    lib.sxt_free.argtypes = [ctypes.c_void_p]
    lib.sxt_num_seqs.restype = ctypes.c_int
    lib.sxt_num_seqs.argtypes = [ctypes.c_void_p]
    lib.sxt_append.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sxt_extend.argtypes = [ctypes.c_void_p, ctypes.c_int, _I32P,
                               ctypes.c_int]
    lib.sxt_speculate.restype = ctypes.c_int
    lib.sxt_speculate.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _I32P, _I32P, _F32P, _F32P, ctypes.POINTER(ctypes.c_int),
    ]
    lib.sxt_speculate_batch.restype = None
    lib.sxt_speculate_batch.argtypes = [
        ctypes.c_void_p,                    # response tree
        ctypes.POINTER(ctypes.c_void_p),    # prompt trees (NULLable)
        _I32P, _I32P,                       # patterns [b, pat_stride], lens
        ctypes.c_int, ctypes.c_int,         # b, pat_stride
        _I32P,                              # max_spec_tokens [b]
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # factor/off/prob
        ctypes.c_int, ctypes.c_int,         # tree_spec, cap_stride
        _I32P, _I32P, _F32P,                # out toks/parents/probs
        _F32P, _I32P, _I32P,                # out scores, match_lens, ns
    ]
    _lib = lib
    return lib


class NativeSuffixTree:
    def __init__(self, max_depth: int, lib: ctypes.CDLL):
        self._lib = lib
        self._handle = lib.sxt_new(max_depth)
        self._max_depth = max_depth

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.sxt_free(handle)
            self._handle = None

    def num_seqs(self) -> int:
        return self._lib.sxt_num_seqs(self._handle)

    def append(self, seq_id: int, token: int) -> None:
        self._lib.sxt_append(self._handle, seq_id, token)

    def extend(self, seq_id: int, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=np.int32)
        if arr.size == 0:
            return
        self._lib.sxt_extend(self._handle, seq_id,
                             arr.ctypes.data_as(_I32P), arr.size)

    def speculate(self, pattern: Sequence[int], max_spec_tokens: int,
                  max_spec_factor: float = 1.0, max_spec_offset: float = 0.0,
                  min_token_prob: float = 0.1,
                  use_tree_spec: bool = False) -> Candidate:
        pat = np.asarray(pattern, dtype=np.int32)
        cap = max(max_spec_tokens, 0)
        toks = np.empty(cap + 1, dtype=np.int32)
        parents = np.empty(cap + 1, dtype=np.int32)
        probs = np.empty(cap + 1, dtype=np.float32)
        score = ctypes.c_float()
        match_len = ctypes.c_int()
        n = self._lib.sxt_speculate(
            self._handle, pat.ctypes.data_as(_I32P), pat.size,
            max_spec_tokens, max_spec_factor, max_spec_offset, min_token_prob,
            1 if use_tree_spec else 0, toks.ctypes.data_as(_I32P),
            parents.ctypes.data_as(_I32P), probs.ctypes.data_as(_F32P),
            ctypes.byref(score), ctypes.byref(match_len))
        return Candidate(token_ids=toks[:n].tolist(),
                         parents=parents[:n].tolist(),
                         probs=probs[:n].tolist(), score=score.value,
                         match_len=match_len.value)


# ---------------------------------------------------------------------------
# Pure-Python twin (differential-test oracle)
# ---------------------------------------------------------------------------

class _PyNode:
    __slots__ = ("parent", "children", "hits", "seq_id", "start", "length")

    def __init__(self) -> None:
        self.parent: Optional[_PyNode] = None
        self.children: dict[int, _PyNode] = {}
        self.hits = 0
        self.seq_id = -1
        self.start = 0
        self.length = 0


class PySuffixTree:
    """Same online sliding-window suffix tree, in Python."""

    def __init__(self, max_depth: int):
        self._max_depth = max_depth
        self._root = _PyNode()
        self._seqs: dict[int, list[int]] = {}
        self._active: dict[int, deque[_PyNode]] = {}

    def num_seqs(self) -> int:
        return len(self._seqs)

    def append(self, seq_id: int, token: int) -> None:
        seq = self._seqs.setdefault(seq_id, [])
        window = self._active.setdefault(seq_id, deque())
        window.append(self._root)
        self._root.hits += 1
        if len(window) > self._max_depth:
            window.popleft()
        seq.append(token)
        end = len(seq)
        for i, locus in enumerate(window):
            window[i] = self._advance(locus, seq_id, token, end)

    def extend(self, seq_id: int, tokens: Sequence[int]) -> None:
        for t in tokens:
            self.append(seq_id, int(t))

    def _advance(self, nd: _PyNode, seq_id: int, token: int,
                 end: int) -> _PyNode:
        seq = self._seqs[seq_id]
        child = nd.children.get(token)
        if child is None:
            if nd.hits == 1 and nd is not self._root:
                nd.length += 1
                nd.seq_id = seq_id
                nd.start = end - nd.length
                return nd
            leaf = _PyNode()
            leaf.parent = nd
            leaf.hits = 1
            leaf.seq_id = seq_id
            leaf.start = end - 1
            leaf.length = 1
            nd.children[token] = leaf
            return leaf

        if (nd is not self._root and nd.hits == child.hits + 1
                and len(nd.children) == 1):
            if child.length == 1:
                parent = nd.parent
                child.hits += 1
                child.length = nd.length + 1
                child.seq_id = seq_id
                child.start = end - child.length
                child.parent = parent
                edge_tok = seq[child.start]
                assert parent is not None
                parent.children[edge_tok] = child
                nd.children.clear()
                return child
            nd.length += 1
            nd.seq_id = seq_id
            nd.start = end - nd.length
            child.start += 1
            child.length -= 1
            new_key = self._seqs[child.seq_id][child.start]
            if new_key != token:
                del nd.children[token]
                nd.children[new_key] = child
            return nd

        if child.length == 1:
            child.hits += 1
            return child
        mid = _PyNode()
        mid.parent = nd
        mid.hits = child.hits + 1
        mid.seq_id = seq_id
        mid.start = end - 1
        mid.length = 1
        rest_key = self._seqs[child.seq_id][child.start + 1]
        mid.children[rest_key] = child
        nd.children[token] = mid
        child.parent = mid
        child.start += 1
        child.length -= 1
        return mid

    def _walk(self, pattern: Sequence[int],
              start: int) -> Optional[tuple[_PyNode, int]]:
        nd = self._root
        off = 0
        for i in range(start, len(pattern)):
            tok = pattern[i]
            if off >= nd.length:
                child = nd.children.get(tok)
                if child is None:
                    return None
                nd = child
                off = 0
            if self._seqs[nd.seq_id][nd.start + off] != tok:
                return None
            off += 1
        return nd, off

    def speculate(self, pattern: Sequence[int], max_spec_tokens: int,
                  max_spec_factor: float = 1.0, max_spec_offset: float = 0.0,
                  min_token_prob: float = 0.1,
                  use_tree_spec: bool = False) -> Candidate:
        best = Candidate()
        pattern = [int(t) for t in pattern]
        lo = max(len(pattern) - self._max_depth, 0)
        for s in range(lo, len(pattern)):
            hit = self._walk(pattern, s)
            if hit is None:
                continue
            nd, off = hit
            match_len = len(pattern) - s
            budget = min(
                max_spec_tokens,
                int(match_len * max_spec_factor + max_spec_offset + 1e-6))
            budget = max(budget, 0)
            if use_tree_spec:
                cand = self._spec_tree(nd, off, budget, min_token_prob)
            else:
                cand = self._spec_path(nd, off, budget, min_token_prob)
            if cand.score > best.score:
                cand.match_len = match_len
                best = cand
        return best

    def _spec_path(self, nd: _PyNode, off: int, budget: int,
                   min_prob: float) -> Candidate:
        out = Candidate()
        p = 1.0
        while len(out.token_ids) < budget and p >= min_prob:
            if off < nd.length:
                out.parents.append(len(out.token_ids) - 1)
                out.token_ids.append(self._seqs[nd.seq_id][nd.start + off])
                out.probs.append(p)
                out.score += p
                off += 1
                continue
            best_child = None
            best_hits = 0
            for ch in nd.children.values():
                if ch.hits > best_hits:
                    best_hits = ch.hits
                    best_child = ch
            if best_child is None:
                break
            p *= best_hits / nd.hits
            nd = best_child
            off = 0
        return out

    def _spec_tree(self, nd: _PyNode, off: int, budget: int,
                   min_prob: float) -> Candidate:
        out = Candidate()
        counter = 0  # tie-break for the heap
        heap = [(-1.0, counter, nd, off, -1)]
        while len(out.token_ids) < budget and heap:
            negp, _, node, o, parent = heapq.heappop(heap)
            p = -negp
            if o < node.length:
                out.token_ids.append(self._seqs[node.seq_id][node.start + o])
                out.parents.append(parent)
                out.probs.append(p)
                out.score += p
                counter += 1
                heapq.heappush(
                    heap, (negp, counter, node, o + 1, len(out.token_ids) - 1))
            else:
                for ch in node.children.values():
                    cp = p * ch.hits / node.hits
                    if cp >= min_prob:
                        counter += 1
                        heapq.heappush(heap, (-cp, counter, ch, 0, parent))
        return out


def SuffixTree(max_depth: int, force_python: bool = False):
    """The native tree, or the Python twin when ``force_python`` is set or
    ``ARCTIC_TPU_PURE_PYTHON_SUFFIX=1``; a native build that fails raises.

    Both expose ``num_seqs()``, ``append(seq_id, token)``,
    ``extend(seq_id, tokens)`` and ``speculate(...) -> Candidate``.
    """
    if force_python or envs.ARCTIC_TPU_PURE_PYTHON_SUFFIX:
        return PySuffixTree(max_depth)
    return NativeSuffixTree(max_depth, load_native())
