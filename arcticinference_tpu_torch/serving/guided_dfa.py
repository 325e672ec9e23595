"""DFA-backed guided decoding: per-state vocab bitmasks, device-applied.

The port's copy of ``arcticinference_tpu/serving/guided_dfa.py``.  A
grammar (regex / choice list / JSON schema via ``schema_regex``) is
compiled to a codepoint DFA (``regex_dfa.py``); the native sweeper
(``csrc/token_dfa.cc``, built by ``spec/build.py`` with g++ at first
use) walks a vocab trie in product with the DFA to produce, for any
automaton state, a ``ceil(V/32)``-word bitmask of tokens that keep the
output completable.  The engine ships the current state's mask with the
step inputs (or, on the pipelined step, keeps every state's mask in a
device pool, ``ops/guided.py``) and the device masks the logits before
sampling: constrained sampling is exact (the true renormalised
distribution), not a host-filtered top-K.

A native build that fails raises :class:`NativeBuildError`; the
pure-Python sweeper (same answers, for tiny test vocabularies) runs only
with ``force_python=True``.  A pattern outside the compilable subset
raises :class:`UnsupportedRegex`, and ``structured.py`` then takes the
partial-matching decoders.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from arcticinference_tpu_torch.serving.regex_dfa import (Dfa,
                                                         UnsupportedRegex,
                                                         compile_dfa)
from arcticinference_tpu_torch.spec.build import NativeBuildError, build

__all__ = ["DfaGuidedDecoder", "VocabCodepoints", "TokenDfaIndex",
           "compile_guided_dfa", "UnsupportedRegex", "NativeBuildError"]


# --------------------------------------------------------------------- #
# Vocab codepoint table (cached per tokenizer)
# --------------------------------------------------------------------- #

# Padding codepoint for the device token matrix: above any valid
# Unicode codepoint (0x10FFFF) but below 2^21 so packed (state, cp) keys
# stay within int32.
PAD_CP = 0x1FFFFF
# Tokens longer than this many codepoints are excluded from device-side
# guided decoding (their advance walk wouldn't fit the fixed unroll);
# they are simply masked out of every state's allowed set.
DEVICE_LMAX = 32


class VocabCodepoints:
    """Flattened per-token codepoint sequences for a tokenizer.

    Token text comes from single-token ``decode`` — the same convention
    the partial-matching decoders use, so both paths see identical token
    surfaces.  Zero-length tokens (specials that decode to "") are
    recorded as empty and never allowed by any mask.
    """

    def __init__(self, tokenizer, vocab_size: int):
        texts = _decode_vocab(tokenizer, vocab_size)
        lengths = np.asarray([len(t) for t in texts], np.int64)
        self.offsets = np.zeros(vocab_size + 1, np.int64)
        np.cumsum(lengths, out=self.offsets[1:])
        self.cps = np.zeros(int(self.offsets[-1]), np.uint32)
        for i, t in enumerate(texts):
            if t:
                self.cps[self.offsets[i]:self.offsets[i + 1]] = [
                    ord(c) for c in t]
        self.vocab_size = vocab_size

    def token_cps(self, tok: int) -> np.ndarray:
        return self.cps[self.offsets[tok]:self.offsets[tok + 1]]

    def cps_matrix(self, lmax: int = DEVICE_LMAX) -> np.ndarray:
        """[V, lmax] uint32 codepoint matrix, ``PAD_CP``-padded; rows of
        tokens longer than ``lmax`` are all-PAD (those tokens must be
        masked out of device-side guided decoding)."""
        cached = getattr(self, "_cps_matrix", None)
        if cached is not None and cached.shape[1] == lmax:
            return cached
        v = self.vocab_size
        out = np.full((v, lmax), PAD_CP, np.uint32)
        for t in range(v):
            cps = self.token_cps(t)
            if 0 < len(cps) <= lmax:
                out[t, :len(cps)] = cps
        self._cps_matrix = out
        return out

    def too_long(self, lmax: int = DEVICE_LMAX) -> np.ndarray:
        """bool[V]: tokens whose codepoint sequence exceeds ``lmax``."""
        lens = np.diff(self.offsets)
        return lens > lmax


def _decode_vocab(tokenizer, vocab_size: int) -> list[str]:
    # Per-id decode (not convert_ids_to_tokens, whose raw merges carry
    # Ġ/▁ whitespace markers) so the DFA sees the same token surfaces as
    # the partial-matching decoders.  One-time cost per tokenizer.
    return [tokenizer.decode([i]) for i in range(vocab_size)]


# Values hold a strong reference to the tokenizer: the cache is keyed
# by id(), and without the reference a collected tokenizer's address
# could be reused by a new object that would silently inherit masks
# built for a different vocabulary.
_VOCAB_CACHE: dict[int, tuple[object, VocabCodepoints]] = {}
_VOCAB_LOCK = threading.Lock()


def vocab_codepoints(tokenizer, vocab_size: int) -> VocabCodepoints:
    key = id(tokenizer)
    with _VOCAB_LOCK:
        entry = _VOCAB_CACHE.get(key)
        if entry is None or entry[0] is not tokenizer or \
                entry[1].vocab_size != vocab_size:
            vc = VocabCodepoints(tokenizer, vocab_size)
            while len(_VOCAB_CACHE) > 8:   # bound the strong refs
                # Evict oldest entries only (insertion order); clearing
                # everything would force full vocab re-decodes for
                # tokenizers still in active use.
                _VOCAB_CACHE.pop(next(iter(_VOCAB_CACHE)))
            _VOCAB_CACHE[key] = (tokenizer, vc)
        else:
            vc = entry[1]
        return vc


# --------------------------------------------------------------------- #
# Native sweeper (ctypes) and its pure-Python twin
# --------------------------------------------------------------------- #

_LIB = None
_LIB_LOCK = threading.Lock()


def _load_lib():
    """The native sweeper, built at first use; a failed build raises
    :class:`NativeBuildError` (and is tried again at the next call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build("token_dfa.cc")))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tdfa_create.restype = ctypes.c_void_p
        lib.tdfa_create.argtypes = [
            ctypes.c_int32, u8p, i32p, u32p, u32p, i32p, ctypes.c_int32,
            ctypes.c_int32, i64p, u32p]
        lib.tdfa_destroy.argtypes = [ctypes.c_void_p]
        lib.tdfa_mask.restype = ctypes.c_int64
        lib.tdfa_mask.argtypes = [ctypes.c_void_p, ctypes.c_int32, u32p]
        lib.tdfa_advance.restype = ctypes.c_int32
        lib.tdfa_advance.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                     ctypes.c_int32]
        lib.tdfa_is_accept.restype = ctypes.c_int32
        lib.tdfa_is_accept.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tdfa_all_masks.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32, u32p]
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class TokenDfaIndex:
    """DFA × vocabulary product: per-state mask + advance.

    One instance per (pattern, tokenizer) pair — shareable across
    requests; all methods are thread-compatible (read-only after init)
    except the per-instance mask cache, which is lock-protected.
    """

    def __init__(self, dfa: Dfa, vocab: VocabCodepoints,
                 force_python: bool = False):
        self.dfa = dfa
        self.vocab = vocab
        self.n_words = (vocab.vocab_size + 31) // 32
        self._mask_cache: dict[int, np.ndarray] = {}
        self._cache_lock = threading.Lock()
        self._handle = None
        lib = None if force_python else _load_lib()
        if lib is not None:
            accept = dfa.accept.astype(np.uint8)
            offsets = np.ascontiguousarray(dfa.trans_offsets, np.int32)
            lo = np.ascontiguousarray(dfa.trans_lo, np.uint32)
            hi = np.ascontiguousarray(dfa.trans_hi, np.uint32)
            nxt = np.ascontiguousarray(dfa.trans_next, np.int32)
            offs = np.ascontiguousarray(vocab.offsets, np.int64)
            cps = np.ascontiguousarray(vocab.cps, np.uint32)
            handle = lib.tdfa_create(
                dfa.n_states, _ptr(accept, ctypes.c_uint8),
                _ptr(offsets, ctypes.c_int32), _ptr(lo, ctypes.c_uint32),
                _ptr(hi, ctypes.c_uint32), _ptr(nxt, ctypes.c_int32),
                len(lo), vocab.vocab_size, _ptr(offs, ctypes.c_int64),
                _ptr(cps, ctypes.c_uint32))
            self._lib = lib
            self._handle = ctypes.c_void_p(handle)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            try:
                self._lib.tdfa_destroy(h)
            except Exception:
                pass

    # -- queries ---------------------------------------------------------

    def mask(self, state: int) -> np.ndarray:
        """uint32[n_words] bitmask of tokens allowed from ``state``."""
        with self._cache_lock:
            m = self._mask_cache.get(state)
            if m is not None:
                return m
        if self._handle is not None:
            out = np.zeros(self.n_words, np.uint32)
            self._lib.tdfa_mask(self._handle, state,
                                _ptr(out, ctypes.c_uint32))
        else:
            out = self._mask_python(state)
        with self._cache_lock:
            if len(self._mask_cache) > 4096:
                self._mask_cache.clear()
            self._mask_cache[state] = out
        return out

    def _mask_python(self, state: int) -> np.ndarray:
        out = np.zeros(self.n_words, np.uint32)
        if state < 0:
            return out
        v = self.vocab
        for t in range(v.vocab_size):
            cps = v.token_cps(t)
            if len(cps) == 0:
                continue
            s = state
            for cp in cps:
                s = self.dfa.step(s, int(cp))
                if s < 0:
                    break
            if s >= 0:
                out[t >> 5] |= np.uint32(1 << (t & 31))
        return out

    def device_tables(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """Full-grammar export for the device-resident guided path.

        Returns ``(masks [S, W] uint32, keys [I] int32, hi [I] int32,
        nxt [I] int32)`` where ``keys[i] = state << 21 | interval_lo``
        (globally sorted, so one searchsorted resolves a (state, cp)
        transition).  Tokens longer than ``DEVICE_LMAX`` codepoints are
        masked out of every state; all-zero mask rows get bit 0 set so
        device sampling stays defined after grammar completion (the host
        discards any overshoot tokens at drain time).
        """
        cached = getattr(self, "_device_tables", None)
        if cached is not None:
            return cached
        dfa = self.dfa
        masks = self._all_masks().copy()
        empty = ~masks.any(axis=1)
        masks[empty, 0] |= np.uint32(1)

        lo = dfa.trans_lo.astype(np.int64)
        offs = dfa.trans_offsets
        state_of = np.repeat(np.arange(dfa.n_states, dtype=np.int64),
                             np.diff(offs))
        keys = ((state_of << 21) | lo).astype(np.int32)
        hi = dfa.trans_hi.astype(np.int32)
        nxt = dfa.trans_next.astype(np.int32)
        self._device_tables = (masks, keys, hi, nxt)
        return self._device_tables

    def _all_masks(self) -> np.ndarray:
        """[S, n_words] uint32 per-state masks with over-long tokens
        cleared (device-representable allowed sets)."""
        cached = getattr(self, "_all_masks_arr", None)
        if cached is not None:
            return cached
        s_count = self.dfa.n_states
        masks = np.zeros((s_count, self.n_words), np.uint32)
        if self._handle is not None:
            self._lib.tdfa_all_masks(
                self._handle, 0, s_count,
                masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        else:
            for s in range(s_count):
                masks[s] = self.mask(s)
        long_toks = np.nonzero(self.vocab.too_long())[0]
        for t in long_toks:
            masks[:, t >> 5] &= ~np.uint32(1 << (t & 31))
        self._all_masks_arr = masks
        return masks

    def token_dead_ends(self) -> bool:
        """True when some non-accept DFA state has NO allowed token.

        The codepoint DFA is pruned (every state reaches accept at the
        character level) but the *token* product can still dead-end when
        the characters a state needs appear in no in-vocab token — e.g.
        a grammar whose alphabet lies outside the model's vocabulary.
        From such a state the device mask is all-zero and sampling would
        emit the bit-0 sentinel, killing the grammar and trimming the
        output to empty (the silent-empty-200 failure the reference's
        backends never exhibit).  Callers must treat ``True`` as
        "outside the compilable subset" and use the partial-match
        decoders, which force tokens host-side instead.
        """
        cached = getattr(self, "_token_dead_ends", None)
        if cached is None:
            if self._handle is None and \
                    self.dfa.n_states * self.vocab.vocab_size > 2_000_000:
                # No native sweeper and a big product: the full sweep is
                # the O(S*V*len) pure-Python loop — minutes at real
                # vocab sizes.  Bounded BFS from the start state over
                # codepoint transitions, masking each visited state: a
                # dead end inside the budget is detected exactly; if the
                # budget runs out before full coverage, answer True
                # conservatively (host-side partial-match decoding)
                # rather than risk a runtime dead state surfacing as an
                # HTTP 500 abort.
                budget = max(1, 2_000_000 // max(self.vocab.vocab_size, 1))
                cached = self._dead_end_bfs(budget)
            else:
                empty = ~self._all_masks().any(axis=1)
                live_accept = self.dfa.accept.astype(bool)
                cached = bool((empty & ~live_accept).any())
            self._token_dead_ends = cached
        return cached

    def _dead_end_bfs(self, budget: int) -> bool:
        """Bounded BFS from the start state over codepoint-reachable DFA
        states, computing each visited state's token mask.  Returns True
        on the first non-accept state with an empty mask, or — if the
        state budget runs out before full coverage — True conservatively
        (callers then route the grammar to the host-side partial-match
        decoders instead of the device path)."""
        dfa = self.dfa
        seen = {int(dfa.start)}
        queue = [int(dfa.start)]
        visited = 0
        while queue:
            if visited >= budget:
                return True          # coverage incomplete: can't certify
            s = queue.pop()
            visited += 1
            if not bool(dfa.accept[s]) and not self.mask(s).any():
                return True
            a, b = int(dfa.trans_offsets[s]), int(dfa.trans_offsets[s + 1])
            for nxt in np.unique(dfa.trans_next[a:b]):
                nxt = int(nxt)
                if nxt >= 0 and nxt not in seen:
                    seen.add(nxt)
                    queue.append(nxt)
        return False

    def advance(self, state: int, tok: int) -> int:
        if self._handle is not None:
            return int(self._lib.tdfa_advance(self._handle, state, tok))
        s = state
        for cp in self.vocab.token_cps(tok):
            s = self.dfa.step(s, int(cp))
            if s < 0:
                return -1
        return s

    def is_accept(self, state: int) -> bool:
        return self.dfa.is_accept(state)


# Values carry the tokenizer (strong ref) for the same id()-reuse
# reason as _VOCAB_CACHE.
_INDEX_CACHE: dict[tuple[int, int, str], tuple[object, TokenDfaIndex]] = {}
_INDEX_LOCK = threading.Lock()


def compile_guided_dfa(tokenizer, vocab_size: int, pattern: str,
                       force_python: bool = False) -> TokenDfaIndex:
    """Compile + index ``pattern`` against ``tokenizer``'s vocabulary.

    Raises :class:`UnsupportedRegex` when the pattern is outside the
    compilable subset; results are cached per (tokenizer, pattern).
    """
    key = (id(tokenizer), int(vocab_size), pattern)
    with _INDEX_LOCK:
        entry = _INDEX_CACHE.get(key)
    if entry is not None and entry[0] is tokenizer:
        return entry[1]
    dfa = compile_dfa(pattern)
    vocab = vocab_codepoints(tokenizer, vocab_size)
    idx = TokenDfaIndex(dfa, vocab, force_python=force_python)
    with _INDEX_LOCK:
        if len(_INDEX_CACHE) > 256:
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = (tokenizer, idx)
    return idx


# --------------------------------------------------------------------- #
# Engine-facing decoder
# --------------------------------------------------------------------- #

class DfaGuidedDecoder:
    """Guided decoder backed by a token DFA.

    Implements the engine's guided protocol (``pick`` / ``fallback_token``
    / ``advance_token`` / ``finished``) **plus** the mask interface
    (``mask_words``) that lets the runner apply the constraint on device.
    When the device applies the mask, the sampled token is valid by
    construction and ``pick`` never rejects it.
    """

    def __init__(self, index: TokenDfaIndex,
                 schema: Optional[dict] = None):
        self.index = index
        self.state = index.dfa.start
        self.schema = schema
        self.schema_ok: Optional[bool] = None
        self._text_parts: list[str] = []
        self._tokens: list[int] = []

    def clone(self) -> "DfaGuidedDecoder":
        """Fresh-state decoder over the same compiled grammar (n>1
        fan-out: each child needs its own automaton state)."""
        return DfaGuidedDecoder(self.index, schema=self.schema)

    # mask interface -----------------------------------------------------

    def mask_words(self) -> np.ndarray:
        return self.index.mask(self.state)

    # guided protocol ----------------------------------------------------

    def allows_token(self, token_id: int) -> bool:
        if self.finished():
            return False
        m = self.index.mask(self.state)
        return bool((m[token_id >> 5] >> (token_id & 31)) & 1)

    def advance_token(self, token_id: int) -> None:
        self.state = self.index.advance(self.state, token_id)
        self._tokens.append(int(token_id))

    def finished(self) -> bool:
        done = self.index.is_accept(self.state)
        if done and self.schema is not None and self.schema_ok is None:
            self._validate_schema()
        return done

    def fallback_token(self) -> Optional[int]:
        m = self.index.mask(self.state)
        nz = np.nonzero(m)[0]
        if len(nz) == 0:
            return None
        w = int(nz[0])
        b = int(m[w])
        return w * 32 + ((b & -b).bit_length() - 1)

    def pick(self, candidates: Sequence[int]) -> Optional[int]:
        m = self.index.mask(self.state)
        for tok in candidates:
            t = int(tok)
            if (m[t >> 5] >> (t & 31)) & 1:
                return t
        return None

    # -------------------------------------------------------------------

    def _validate_schema(self) -> None:
        try:
            import json as _json

            import jsonschema

            # Re-derive text from the consumed tokens via the vocab
            # codepoint table (no tokenizer needed at this point).
            v = self.index.vocab
            text = "".join(
                "".join(chr(c) for c in v.token_cps(t))
                for t in self._tokens)
            jsonschema.validate(_json.loads(text), self.schema)
            self.schema_ok = True
        except Exception:
            self.schema_ok = False
