"""SuffixCache: the host-side speculation source for suffix decoding.

The port's copy of ``arcticinference_tpu/spec/suffix_cache.py``, itself a
capability mirror of reference ``common/suffix_cache/suffix_cache.py:57-222``:
one *global* tree accumulates all responses across requests, and each live
request optionally gets a private tree over its own prompt; speculation
takes the better-scoring candidate of the two.  The score approximates the
expected number of accepted tokens (sum of per-token estimated
probabilities).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Hashable, List, Optional, Sequence, Union

import numpy as np

from arcticinference_tpu_torch.spec.suffix_tree import (Candidate,
                                                        NativeSuffixTree,
                                                        SuffixTree)


@dataclass
class SuffixSpecResult:
    """Result of a suffix-decoding speculation.

    ``parents[i]`` is the index (into ``token_ids``) of token i's parent in
    the speculation tree, or -1 for roots; a pure path has parents
    ``[-1, 0, 1, ...]``.
    """

    token_ids: List[int] = field(default_factory=list)
    parents: List[int] = field(default_factory=list)
    probs: List[float] = field(default_factory=list)
    score: float = 0.0
    match_len: int = 0

    @staticmethod
    def from_candidate(c: Candidate) -> "SuffixSpecResult":
        return SuffixSpecResult(
            token_ids=list(c.token_ids), parents=list(c.parents),
            probs=list(c.probs), score=c.score, match_len=c.match_len)


class SuffixCache:

    def __init__(self, max_depth: int = 64, force_python: bool = False):
        self._max_depth = max_depth
        self._force_python = force_python
        self._response_tree = SuffixTree(max_depth, force_python=force_python)
        self._prompt_trees: dict[Hashable, object] = {}
        self._req_to_seq_id: dict[Hashable, int] = {}

    @property
    def max_depth(self) -> int:
        return self._max_depth

    def has_cached_prompt(self, req_id: Hashable) -> bool:
        return req_id in self._prompt_trees

    def cached_prompt_ids(self) -> list[Hashable]:
        return list(self._prompt_trees)

    def build_prompt_tree(self, prompt_token_ids: Sequence[int]):
        """Build (but do not install) a private prompt tree.

        Split from :meth:`cache_prompt` so the engine can run the
        O(len(prompt) * depth) build on a worker thread during prefill
        (the ctypes tree calls release the GIL) and install the finished
        tree when the request commits its first token.
        """
        tree = SuffixTree(self._max_depth, force_python=self._force_python)
        tree.extend(0, prompt_token_ids)
        return tree

    def install_prompt_tree(self, req_id: Hashable, tree) -> None:
        if req_id in self._prompt_trees:
            raise ValueError(f"Prompt already cached for request {req_id!r}")
        self._prompt_trees[req_id] = tree

    def cache_prompt(self, req_id: Hashable,
                     prompt_token_ids: Sequence[int]) -> None:
        """Index a request's prompt so its own text can seed drafts.

        Must be paired with :meth:`evict_prompt` when the request finishes.
        """
        self.install_prompt_tree(req_id,
                                 self.build_prompt_tree(prompt_token_ids))

    def evict_prompt(self, req_id: Hashable) -> None:
        if req_id not in self._prompt_trees:
            raise ValueError(f"No cached prompt for request {req_id!r}")
        del self._prompt_trees[req_id]

    def _seq_id(self, req_id: Hashable) -> int:
        if req_id not in self._req_to_seq_id:
            self._req_to_seq_id[req_id] = len(self._req_to_seq_id)
        return self._req_to_seq_id[req_id]

    def update_response(self, req_id: Hashable,
                        token_ids: Union[int, Sequence[int]]) -> None:
        """Append generated token(s) to the request's response sequence.

        Feeds both the global response tree (visible to all requests) and,
        if present, the request's prompt tree.
        """
        seq_id = self._seq_id(req_id)
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        self._response_tree.extend(seq_id, token_ids)
        tree = self._prompt_trees.get(req_id)
        if tree is not None:
            tree.extend(0, token_ids)

    def speculate(
        self,
        req_id: Hashable,
        pattern: Sequence[int],
        max_spec_tokens: Optional[int] = None,
        max_spec_factor: float = 1.0,
        max_spec_offset: float = 0.0,
        min_token_prob: float = 0.1,
        use_tree_spec: bool = False,
        use_cached_prompt: bool = True,
    ) -> SuffixSpecResult:
        """Best continuation of ``pattern`` from the prompt + response trees."""
        if use_cached_prompt and req_id not in self._prompt_trees:
            raise ValueError(f"No cached prompt for request {req_id!r}")
        if not pattern:
            raise ValueError("Pattern must not be empty")
        if max_spec_tokens is None:
            max_spec_tokens = self._max_depth
        if len(pattern) > self._max_depth:
            pattern = pattern[-self._max_depth:]

        result = SuffixSpecResult()
        if use_cached_prompt:
            cand = self._prompt_trees[req_id].speculate(
                pattern, max_spec_tokens, max_spec_factor, max_spec_offset,
                min_token_prob, use_tree_spec)
            result = SuffixSpecResult.from_candidate(cand)
        cand = self._response_tree.speculate(
            pattern, max_spec_tokens, max_spec_factor, max_spec_offset,
            min_token_prob, use_tree_spec)
        if cand.score > result.score:
            result = SuffixSpecResult.from_candidate(cand)
        return result

    def is_native(self) -> bool:
        """True when the response tree is the C++ arena tree (whose
        ctypes calls release the GIL)."""
        return isinstance(self._response_tree, NativeSuffixTree)

    def speculate_batch(self, items, pool=None,
                        chunk_threshold: int = 32) -> dict:
        """Run many :meth:`speculate` calls; returns ``{key: result}``.

        ``items`` is a list of ``(key, kwargs)`` pairs, each ``kwargs`` a
        full keyword set for :meth:`speculate`.  With the native tree the
        whole batch is ONE C call (``sxt_speculate_batch``): at batch
        32-64 the per-call ctypes overhead (two trees per slot) outweighs
        the walks.  Large batches are further chunked over ``pool`` (a
        ``ThreadPoolExecutor``): the C call releases the GIL and only
        *reads* the trees, so concurrent chunk walks are safe as long as
        the calling thread is the only one that updates the trees.

        Every item must share ``max_spec_factor`` / ``max_spec_offset`` /
        ``min_token_prob`` / ``use_tree_spec``; per-item
        ``max_spec_tokens`` may vary.
        """
        if not items:
            return {}
        if not self.is_native():
            return {key: self.speculate(**kw) for key, kw in items}
        if pool is not None and len(items) >= 2 * chunk_threshold:
            n_chunks = min(4, -(-len(items) // chunk_threshold))
            size = -(-len(items) // n_chunks)
            futs = [pool.submit(self._speculate_batch_native,
                                items[i:i + size])
                    for i in range(0, len(items), size)]
            out: dict = {}
            for f in futs:
                out.update(f.result())
            return out
        return self._speculate_batch_native(items)

    def _speculate_batch_native(self, items) -> dict:
        first = items[0][1]
        factor = first.get("max_spec_factor", 1.0)
        offset = first.get("max_spec_offset", 0.0)
        min_prob = first.get("min_token_prob", 0.1)
        tree_spec = first.get("use_tree_spec", False)
        b = len(items)
        handles = (ctypes.c_void_p * b)()
        caps = np.empty(b, np.int32)
        pat_rows = []
        for j, (key, kw) in enumerate(items):
            if (kw.get("max_spec_factor", 1.0) != factor
                    or kw.get("max_spec_offset", 0.0) != offset
                    or kw.get("min_token_prob", 0.1) != min_prob
                    or kw.get("use_tree_spec", False) != tree_spec):
                # Mixed per-item constants: serial calls.
                return {k: self.speculate(**w) for k, w in items}
            req_id = kw["req_id"]
            use_prompt = kw.get("use_cached_prompt", True)
            if use_prompt and req_id not in self._prompt_trees:
                raise ValueError(
                    f"No cached prompt for request {req_id!r}")
            pattern = kw["pattern"]
            if not pattern:
                raise ValueError("Pattern must not be empty")
            if len(pattern) > self._max_depth:
                pattern = pattern[-self._max_depth:]
            pat_rows.append(np.asarray(pattern, dtype=np.int32))
            cap = kw.get("max_spec_tokens")
            caps[j] = self._max_depth if cap is None else cap
            handles[j] = (self._prompt_trees[req_id]._handle
                          if use_prompt else None)
        pat_stride = max(r.size for r in pat_rows)
        patterns = np.zeros((b, pat_stride), np.int32)
        pat_lens = np.empty(b, np.int32)
        for j, r in enumerate(pat_rows):
            patterns[j, :r.size] = r
            pat_lens[j] = r.size
        cap_stride = max(1, int(caps.max()) + 1)
        toks = np.empty((b, cap_stride), np.int32)
        parents = np.empty((b, cap_stride), np.int32)
        probs = np.empty((b, cap_stride), np.float32)
        scores = np.empty(b, np.float32)
        match_lens = np.empty(b, np.int32)
        ns = np.empty(b, np.int32)
        rt = self._response_tree
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        rt._lib.sxt_speculate_batch(
            rt._handle, handles, patterns.ctypes.data_as(i32p),
            pat_lens.ctypes.data_as(i32p), b, pat_stride,
            caps.ctypes.data_as(i32p), factor, offset, min_prob,
            1 if tree_spec else 0, cap_stride,
            toks.ctypes.data_as(i32p), parents.ctypes.data_as(i32p),
            probs.ctypes.data_as(f32p), scores.ctypes.data_as(f32p),
            match_lens.ctypes.data_as(i32p), ns.ctypes.data_as(i32p))
        out = {}
        for j, (key, _) in enumerate(items):
            n = int(ns[j])
            out[key] = SuffixSpecResult(
                token_ids=toks[j, :n].tolist(),
                parents=parents[j, :n].tolist(),
                probs=probs[j, :n].tolist(),
                score=float(scores[j]),
                match_len=int(match_lens[j]))
        return out
