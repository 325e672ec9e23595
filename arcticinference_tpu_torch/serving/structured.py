"""Structured output (JSON mode): grammar-guided decoding.

The port's copy of ``arcticinference_tpu/serving/structured.py``.
:func:`make_guided_decoder` turns a vLLM-style guided spec (``json`` /
``regex`` / ``choice``) into a decoder.  Grammars inside the
DFA-compilable subset get the token-bitmask decoder
(``guided_dfa.DfaGuidedDecoder``), whose masks the device applies to the
logits.  The others get the partial-matching decoders below: the device
returns its top-K candidates per sample row and the host picks the first
candidate whose text keeps the output valid (falling back to a
grammar-chosen token when all K are invalid).  They need the ``regex``
module (and ``jsonschema`` to record a schema's conformance), imported
when such a decoder is built.

``JsonPrefixValidator`` is an incremental pushdown validator: feed text,
it tracks whether the prefix can still extend to valid JSON and whether
it is already complete.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

_WS = " \t\n\r"
_DIGITS = "0123456789"


class GuidedDecoder(Protocol):
    def allows(self, text: str) -> bool: ...
    def advance(self, text: str) -> None: ...
    def finished(self) -> bool: ...
    def fallback_text(self) -> str: ...


class JsonPrefixValidator:
    """Incremental validity of a JSON-document prefix.

    States are tracked with an explicit container stack plus a small
    scalar state machine; `copy()` is cheap so candidate tokens can be
    tested speculatively.
    """

    def __init__(self) -> None:
        # stack entries: 'O' object, 'A' array
        self.stack: list[str] = []
        # mode: what we expect next
        #  'value'      start of a value
        #  'obj_key'    '"' starting a key (or '}' if allow_close)
        #  'obj_colon'  ':'
        #  'obj_next'   ',' or '}'
        #  'arr_next'   ',' or ']'
        #  'str' / 'str_esc'  inside a string (value or key)
        #  'num' ...    inside a number
        #  'lit'        inside true/false/null
        #  'done'       a complete document
        self.mode = "value"
        self.allow_close = False   # '}'/']' legal right now (empty or post)
        self.str_is_key = False
        self.lit_target = ""
        self.lit_pos = 0
        self.num_state = ""        # progress marker inside a number
        self.dead = False
        self.text = ""             # accumulated (committed) document text
        self.started = False       # first non-whitespace char seen

    def copy(self) -> "JsonPrefixValidator":
        c = JsonPrefixValidator.__new__(JsonPrefixValidator)
        c.stack = self.stack[:]
        c.mode = self.mode
        c.allow_close = self.allow_close
        c.str_is_key = self.str_is_key
        c.lit_target = self.lit_target
        c.lit_pos = self.lit_pos
        c.num_state = self.num_state
        c.dead = self.dead
        c.text = self.text
        c.started = self.started
        return c

    # -- public ----------------------------------------------------------

    def feed(self, text: str) -> bool:
        """Consume text; returns False (and goes dead) on invalid prefix."""
        for ch in text:
            if not self._feed_char(ch):
                self.dead = True
                return False
            self.text += ch
            if ch not in _WS:
                self.started = True
        return True

    def accepts(self, text: str) -> bool:
        return self.copy().feed(text)

    @property
    def complete(self) -> bool:
        return self.mode == "done" and not self.dead

    # -- internals -------------------------------------------------------

    def _close_value(self) -> None:
        """A value just finished; figure out what comes next."""
        if not self.stack:
            self.mode = "done"
        elif self.stack[-1] == "O":
            self.mode = "obj_next"
        else:
            self.mode = "arr_next"

    def _feed_char(self, ch: str) -> bool:  # noqa: C901 (FSM)
        if self.dead:
            return False
        m = self.mode

        if m == "str" :
            if ch == "\\":
                self.mode = "str_esc"
            elif ch == '"':
                if self.str_is_key:
                    self.mode = "obj_colon"
                else:
                    self._close_value()
            elif ch in "\n\r":
                return False
            return True
        if m == "str_esc":
            if ch in '"\\/bfnrtu':
                self.mode = "str"   # (u-escape hex digits pass the b-check)
                return True
            return False

        if m == "num":
            if ch in _DIGITS:
                if self.num_state == "frac_start":
                    self.num_state = "frac"
                elif self.num_state == "exp_start":
                    self.num_state = "exp"
                return True
            if ch == "." and self.num_state == "int":
                self.num_state = "frac_start"
                return True
            if ch in "eE" and self.num_state in ("int", "frac"):
                self.num_state = "exp_start"
                return True
            if ch in "+-" and self.num_state == "exp_start":
                self.num_state = "exp"
                return True
            if self.num_state in ("frac_start", "exp_start") \
                    and ch not in _DIGITS:
                return False
            # Number ended; re-dispatch ch in the post-value mode.
            self._close_value()
            return self._feed_char(ch)

        if m == "lit":
            want = self.lit_target[self.lit_pos]
            if ch != want:
                return False
            self.lit_pos += 1
            if self.lit_pos == len(self.lit_target):
                self._close_value()
            return True

        if ch in _WS:
            return m != "num"  # ws is fine between tokens

        if m == "value":
            if ch == "{":
                self.stack.append("O")
                self.mode = "obj_key"
                self.allow_close = True
                return True
            if ch == "[":
                self.stack.append("A")
                self.mode = "value"
                self.allow_close = True
                return True
            if ch == "]" and self.allow_close and self.stack and \
                    self.stack[-1] == "A":
                self.stack.pop()
                self.allow_close = False
                self._close_value()
                return True
            if ch == '"':
                self.mode = "str"
                self.str_is_key = False
                self.allow_close = False
                return True
            if ch == "-" or ch in _DIGITS:
                self.mode = "num"
                self.num_state = "int"
                self.allow_close = False
                return True
            for lit in ("true", "false", "null"):
                if ch == lit[0]:
                    self.mode = "lit"
                    self.lit_target = lit
                    self.lit_pos = 1
                    self.allow_close = False
                    return True
            return False

        if m == "obj_key":
            if ch == '"':
                self.mode = "str"
                self.str_is_key = True
                return True
            if ch == "}" and self.allow_close:
                self.stack.pop()
                self.allow_close = False
                self._close_value()
                return True
            return False

        if m == "obj_colon":
            if ch == ":":
                self.mode = "value"
                self.allow_close = False
                return True
            return False

        if m == "obj_next":
            if ch == ",":
                self.mode = "obj_key"
                self.allow_close = False
                return True
            if ch == "}":
                self.stack.pop()
                self._close_value()
                return True
            return False

        if m == "arr_next":
            if ch == ",":
                self.mode = "value"
                self.allow_close = False
                return True
            if ch == "]":
                self.stack.pop()
                self._close_value()
                return True
            return False

        if m == "done":
            return False
        return False

    def suggest_char(self) -> str:
        """A character that legally extends the current prefix."""
        m = self.mode
        if m == "str":
            return '"'
        if m == "str_esc":
            return "n"
        if m == "num":
            return "0" if self.num_state.endswith("_start") else \
                ("}" if self.stack and self.stack[-1] == "O" else
                 "]" if self.stack else "0")
        if m == "lit":
            return self.lit_target[self.lit_pos]
        if m == "value":
            return "{"
        if m == "obj_key":
            return '"'
        if m == "obj_colon":
            return ":"
        if m == "obj_next":
            return "}"
        if m == "arr_next":
            return "]"
        return ""


class JsonGuidedDecoder:
    """GuidedDecoder enforcing syntactically valid JSON output."""

    def __init__(self, tokenizer) -> None:
        self.tokenizer = tokenizer
        self.validator = JsonPrefixValidator()
        self._cache: dict[int, str] = {}

    def _text(self, token_id: int) -> str:
        t = self._cache.get(token_id)
        if t is None:
            t = self.tokenizer.decode([token_id])
            self._cache[token_id] = t
        return t

    def allows_token(self, token_id: int) -> bool:
        if self.validator.complete:
            return False
        return self.validator.accepts(self._text(token_id))

    def advance_token(self, token_id: int) -> None:
        self.validator.feed(self._text(token_id))

    def finished(self) -> bool:
        return self.validator.complete

    def fallback_token(self) -> Optional[int]:
        ch = self.validator.suggest_char()
        if not ch:
            return None
        ids = self.tokenizer.encode(ch, add_special_tokens=False)
        return ids[0] if ids else None

    def pick(self, candidates: Sequence[int]) -> Optional[int]:
        """First candidate that keeps the prefix valid; None if none do."""
        for tok in candidates:
            if self.allows_token(int(tok)):
                return int(tok)
        return None


class _TokenTextDecoder:
    """Shared token layer: decode cache + top-K candidate picking.
    Subclasses implement text-level accepts/feed/complete/suggest."""

    def __init__(self, tokenizer) -> None:
        self.tokenizer = tokenizer
        self._cache: dict[int, str] = {}

    def _text(self, token_id: int) -> str:
        t = self._cache.get(token_id)
        if t is None:
            t = self.tokenizer.decode([token_id])
            self._cache[token_id] = t
        return t

    # text-level hooks --------------------------------------------------
    def accepts_text(self, text: str) -> bool:
        raise NotImplementedError

    def feed_text(self, text: str) -> None:
        raise NotImplementedError

    def finished(self) -> bool:
        raise NotImplementedError

    def suggest_text(self) -> str:
        return ""

    # token layer (engine interface) ------------------------------------
    def allows_token(self, token_id: int) -> bool:
        if self.finished():
            return False
        return self.accepts_text(self._text(token_id))

    def advance_token(self, token_id: int) -> None:
        self.feed_text(self._text(token_id))

    def fallback_token(self) -> Optional[int]:
        s = self.suggest_text()
        if not s:
            return None
        ids = self.tokenizer.encode(s, add_special_tokens=False)
        return ids[0] if ids else None

    def pick(self, candidates: Sequence[int]) -> Optional[int]:
        for tok in candidates:
            if self.allows_token(int(tok)):
                return int(tok)
        return None


class RegexGuidedDecoder(_TokenTextDecoder):
    """Regex-constrained decoding (vLLM ``guided_regex`` equivalent).

    Prefix validity uses the ``regex`` module's partial matching: a
    candidate extension is allowed iff the new text can still extend to
    a full match.  Generation finishes at the first complete match
    (greedy-stop semantics)."""

    _PROBE = ('"', "0", "1", "a", "e", " ", "-", ".", ",", ":", "{", "}",
              "[", "]", "t", "f", "n", "A", "_", "/")

    def __init__(self, tokenizer, pattern: str) -> None:
        import regex as _regex

        super().__init__(tokenizer)
        self._re = _regex.compile(pattern)
        self.text = ""

    def _ok(self, text: str):
        return self._re.fullmatch(text, partial=True)

    def accepts_text(self, text: str) -> bool:
        return bool(self._ok(self.text + text))

    def feed_text(self, text: str) -> None:
        self.text += text

    def finished(self) -> bool:
        m = self._re.fullmatch(self.text)
        return bool(m) and not m.partial

    def suggest_text(self) -> str:
        for ch in self._PROBE:
            if self._ok(self.text + ch):
                return ch
        # Exhaustive fallback over the printable range.
        for code in range(32, 127):
            ch = chr(code)
            if self._ok(self.text + ch):
                return ch
        return ""


class ChoiceGuidedDecoder(_TokenTextDecoder):
    """Constrain output to one of N fixed strings (vLLM
    ``guided_choice`` equivalent)."""

    def __init__(self, tokenizer, choices: Sequence[str]) -> None:
        super().__init__(tokenizer)
        if not choices:
            raise ValueError("choices must be non-empty")
        self.choices = [str(c) for c in choices]
        self.text = ""

    def accepts_text(self, text: str) -> bool:
        new = self.text + text
        return any(c.startswith(new) for c in self.choices)

    def feed_text(self, text: str) -> None:
        self.text += text

    def finished(self) -> bool:
        # Finished once the prefix equals a choice that no other choice
        # strictly extends (unambiguous longest-match).
        if self.text not in self.choices:
            return False
        return not any(c != self.text and c.startswith(self.text)
                       for c in self.choices)

    def suggest_text(self) -> str:
        for c in self.choices:
            if c.startswith(self.text) and len(c) > len(self.text):
                return c[len(self.text)]
        return ""


class JsonSchemaGuidedDecoder(JsonGuidedDecoder):
    """JSON-schema mode with per-token schema enforcement.

    The schema is compiled to a regex (``schema_regex.schema_to_regex``,
    outlines-style) and enforced per token through partial matching, so
    conforming output is *guaranteed* for the supported keyword subset —
    parity with vLLM's guided-decoding backends (reference
    ``test_json_mode``, ``tests/benchmarks/test_benchmarks.py:46-76``).
    Schemas outside the subset fall back to syntactic-JSON guidance with
    post-hoc validation; either way the completed document's conformance
    is recorded in ``schema_ok``.  If tokens are force-fed past the
    compiled grammar (``advance_token`` with a disallowed token), the
    regex goes dead and filtering degrades to the syntactic fallback
    rather than wedging the request.
    """

    def __init__(self, tokenizer, schema: dict) -> None:
        super().__init__(tokenizer)
        self.schema = schema or {}
        self.schema_ok: Optional[bool] = None
        root = self.schema.get("type")
        self._root_first = {"object": "{", "array": "[",
                            "string": '"'}.get(root)
        self._re = None
        self._retext = ""
        try:
            from arcticinference_tpu_torch.serving.schema_regex import (
                schema_to_regex)
            import regex as _regex

            self._re = _regex.compile(schema_to_regex(self.schema))
        except Exception:
            self._re = None   # unsupported subset: post-hoc validation only

    # -- compiled-grammar layer ------------------------------------------

    def _re_ok(self, text: str) -> bool:
        return bool(self._re.fullmatch(text, partial=True))

    def _re_complete(self) -> bool:
        m = self._re.fullmatch(self._retext)
        return bool(m) and not m.partial

    def allows_token(self, token_id: int) -> bool:
        if self._re is not None:
            if self._re_complete():
                return False
            return self._re_ok(self._retext + self._text(token_id))
        if self._root_first and not self.validator.started:
            txt = self._text(token_id).lstrip(_WS)
            if txt and not txt.startswith(self._root_first):
                return False
        return super().allows_token(token_id)

    def advance_token(self, token_id: int) -> None:
        if self._re is not None:
            new = self._retext + self._text(token_id)
            if self._re_ok(new):
                self._retext = new
            else:
                self._re = None   # force-fed off-grammar: degrade
        super().advance_token(token_id)

    def fallback_token(self) -> Optional[int]:
        if self._re is not None:
            for code in list(range(32, 127)) + [10, 9]:
                ch = chr(code)
                if self._re_ok(self._retext + ch):
                    ids = self.tokenizer.encode(ch,
                                                add_special_tokens=False)
                    if ids:
                        return ids[0]
            return None
        return super().fallback_token()

    def finished(self) -> bool:
        # With a live compiled grammar, completion is regex completion
        # (the syntactic validator can't know a root-level number ended);
        # otherwise fall back to syntactic completion.
        if self._re is not None:
            done = self._re_complete()
            text = self._retext
        else:
            done = super().finished()
            text = self.validator.text
        if done and self.schema_ok is None:
            try:
                import json as _json

                import jsonschema

                jsonschema.validate(_json.loads(text), self.schema)
                self.schema_ok = True
            except Exception:
                self.schema_ok = False
        return done


def _try_dfa_decoder(tokenizer, pattern: str, schema=None,
                     vocab_size=None):
    """DFA-compiled decoder (device-applied vocab bitmasks), or None when
    the pattern is outside the compilable subset (:class:`UnsupportedRegex`)
    or the grammar dead-ends in the vocabulary (some non-accepting state
    has no allowed token, e.g. its characters lie past ``vocab_size``).
    Anything else, a failed build of the native sweeper included,
    propagates."""
    from arcticinference_tpu_torch import envs
    from arcticinference_tpu_torch.serving.guided_dfa import (
        DfaGuidedDecoder, UnsupportedRegex, compile_guided_dfa)

    if envs.ARCTIC_TPU_DISABLE_GUIDED_DFA:
        return None
    if vocab_size is None:
        vocab_size = len(tokenizer)
    try:
        idx = compile_guided_dfa(tokenizer, int(vocab_size), pattern)
    except UnsupportedRegex:
        return None
    if idx.token_dead_ends():
        # The mask path would dead-end into a silently empty output; the
        # partial-match decoders force tokens host-side and stay correct.
        return None
    return DfaGuidedDecoder(idx, schema=schema)


def make_guided_decoder(tokenizer, spec, vocab_size=None) -> object:
    """Factory mirroring vLLM's GuidedDecodingParams surface:
    ``{"json": schema|True}`` / ``{"regex": pat}`` / ``{"choice": [..]}``
    or an already-built decoder (returned as-is).

    Grammars inside the DFA-compilable subset get the token-bitmask
    decoder (``guided_dfa.DfaGuidedDecoder``): exact constrained
    sampling with the mask applied on device.  Everything else uses the
    partial-matching decoders below.  ``vocab_size`` should be the
    model's logits width when it exceeds ``len(tokenizer)``.
    """
    if hasattr(spec, "pick"):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(f"unsupported guided spec {spec!r}")
    if "regex" in spec:
        d = _try_dfa_decoder(tokenizer, spec["regex"],
                             vocab_size=vocab_size)
        return d or RegexGuidedDecoder(tokenizer, spec["regex"])
    if "choice" in spec:
        choices = spec["choice"]
        if choices:
            import re as _re

            pat = "(?:" + "|".join(_re.escape(str(c))
                                   for c in choices) + ")"
            d = _try_dfa_decoder(tokenizer, pat, vocab_size=vocab_size)
            if d is not None:
                return d
        return ChoiceGuidedDecoder(tokenizer, choices)
    if "json" in spec:
        schema = spec["json"]
        if isinstance(schema, dict):
            from arcticinference_tpu_torch.serving.schema_regex import (
                UnsupportedSchema, schema_to_regex)
            try:
                pat = schema_to_regex(schema)
            except UnsupportedSchema:
                pat = None
            if pat is not None:
                d = _try_dfa_decoder(tokenizer, pat, schema=schema,
                                     vocab_size=vocab_size)
                if d is not None:
                    return d
            return JsonSchemaGuidedDecoder(tokenizer, schema)
        return JsonGuidedDecoder(tokenizer)
    raise ValueError(f"unsupported guided spec keys {sorted(spec)}")
