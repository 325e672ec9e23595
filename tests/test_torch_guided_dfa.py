"""The port's guided-decoding compilers and token sweeper against the JAX
package's (``serving/regex_dfa.py``, ``schema_regex.py``,
``guided_dfa.py``, ``structured.py``; ``csrc/token_dfa.cc``).

On the schemas and the small byte tokenizer of ``tests/test_guided_dfa.py``
(copied here), everything is integer or string logic and must match
exactly: the regex of each schema, the compiled DFA's tables, every
reachable state's token mask and advance (native sweeper against native
sweeper, Python twin against Python twin), the device tables, the
dead-end check and the decoder class ``make_guided_decoder`` picks.  A
native sweeper that fails to build raises; the twin runs only when asked.
"""

import numpy as np
import pytest

from arcticinference_tpu.serving import guided_dfa as jgd
from arcticinference_tpu.serving import structured as jst
from arcticinference_tpu.serving.regex_dfa import compile_dfa as j_compile
from arcticinference_tpu.serving.schema_regex import (
    schema_to_regex as j_schema_to_regex)
from arcticinference_tpu_torch.serving import guided_dfa as tgd
from arcticinference_tpu_torch.serving import structured as tst
from arcticinference_tpu_torch.serving.regex_dfa import (UnsupportedRegex,
                                                         compile_dfa)
from arcticinference_tpu_torch.serving.schema_regex import schema_to_regex
from arcticinference_tpu_torch.spec import build as sbuild

SCHEMAS = [
    {"type": "object",
     "properties": {"a": {"type": "integer"},
                    "b": {"type": "boolean"}},
     "required": ["a", "b"]},
    {"type": "object",
     "properties": {"name": {"type": "string", "maxLength": 8},
                    "tags": {"type": "array",
                             "items": {"enum": ["x", "y"]},
                             "maxItems": 3}},
     "required": ["name"]},
    {"type": "array", "items": {"type": "number"}, "minItems": 1,
     "maxItems": 4},
    {"enum": ["red", "green", "blue", 17, None]},
]

PATTERNS = [schema_to_regex(s) for s in SCHEMAS] + [
    r"\d{4}-\d{2}-\d{2}", "(?:alpha|beta|gamma)", r"a{,3}b", r"[^\"\\]+x"]


class ByteTokenizer:
    """ids 0..127 are char codes; a few multi-char merges on top."""

    MERGES = ['{"', '":', '", "', "true", "false", "null", '"}',
              "12", "3.5", '{"a": ', '"b": ']

    def __init__(self):
        self.vocab = [chr(i) for i in range(128)] + self.MERGES

    def __len__(self):
        return len(self.vocab)

    def decode(self, ids, **kw):
        return "".join(self.vocab[i] for i in ids)

    def encode(self, text, **kw):
        return [ord(c) for c in text]


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_regex_matches_jax(i):
    assert schema_to_regex(SCHEMAS[i]) == j_schema_to_regex(SCHEMAS[i])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compiled_tables_match_jax(pattern):
    t, j = compile_dfa(pattern), j_compile(pattern)
    assert (t.n_states, t.start) == (j.n_states, j.start)
    for name in ("accept", "trans_offsets", "trans_lo", "trans_hi",
                 "trans_next"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_unsupported_constructs_raise():
    for pat in (r"(a)\1", r"a(?=b)", r"\bword\b", r"a^b", r"a{3,1}"):
        with pytest.raises(UnsupportedRegex):
            compile_dfa(pat)


def _reachable(idx, vocab: int, limit: int = 200) -> list[int]:
    frontier, seen = [idx.dfa.start], []
    while frontier and len(seen) < limit:
        s = frontier.pop()
        if s in seen:
            continue
        seen.append(s)
        frontier.extend(ns for t in range(vocab)
                        if (ns := idx.advance(s, t)) >= 0 and ns not in seen)
    return seen


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "twin"])
@pytest.mark.parametrize("i", [0, 1, 3])
def test_masks_and_device_tables_match_jax(i, force_python):
    tok = ByteTokenizer()
    pat = schema_to_regex(SCHEMAS[i])
    tidx = tgd.TokenDfaIndex(compile_dfa(pat),
                             tgd.VocabCodepoints(tok, len(tok)),
                             force_python=force_python)
    jidx = jgd.TokenDfaIndex(j_compile(pat),
                             jgd.VocabCodepoints(tok, len(tok)),
                             force_python=force_python)
    assert (tidx._handle is None) == force_python
    assert (jidx._handle is None) == force_python
    states = _reachable(tidx, len(tok))
    assert len(states) > 5
    for s in states + [-1]:
        np.testing.assert_array_equal(tidx.mask(s), jidx.mask(s),
                                      err_msg=str(s))
        for t in range(len(tok)):
            assert tidx.advance(s, t) == jidx.advance(s, t), (s, t)
    for a, b in zip(tidx.device_tables(), jidx.device_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tidx.vocab.cps_matrix(),
                                  jidx.vocab.cps_matrix())
    assert tidx.token_dead_ends() == jidx.token_dead_ends()


@pytest.mark.parametrize("vocab,pattern", [(139, "abc"), (98, "abc"),
                                           (97, "(?:alpha|beta)"),
                                           (60, r"id-\d+")])
def test_token_dead_ends_match_jax(vocab, pattern):
    tok = ByteTokenizer()
    t = tgd.compile_guided_dfa(tok, vocab, pattern)
    j = jgd.compile_guided_dfa(tok, vocab, pattern)
    assert t.token_dead_ends() == j.token_dead_ends()
    assert t.token_dead_ends() == (vocab < 139)


FACTORY_CASES = [
    ({"regex": "ab+c"}, None),
    ({"choice": ["alpha", "beta"]}, None),
    ({"json": SCHEMAS[0]}, None),
    ({"json": SCHEMAS[3]}, None),
    ({"json": True}, None),
    ({"regex": r"a(?=b)c"}, None),
    ({"choice": ["alpha", "beta"]}, 97),
    ({"regex": r"id-\d+"}, 60),
    ({"json": {"type": "object", "properties": {"a": {"not": {}}}}}, None),
]


@pytest.mark.parametrize("disable", [False, True],
                         ids=["dfa", "dfa_disabled"])
@pytest.mark.parametrize("case", range(len(FACTORY_CASES)))
def test_factory_picks_the_decoder_of_jax(case, disable, monkeypatch):
    if disable:
        monkeypatch.setenv("ARCTIC_TPU_DISABLE_GUIDED_DFA", "1")
    spec, vocab = FACTORY_CASES[case]
    tok = ByteTokenizer()
    t = tst.make_guided_decoder(tok, spec, vocab_size=vocab)
    j = jst.make_guided_decoder(tok, spec, vocab_size=vocab)
    assert type(t).__name__ == type(j).__name__
    if isinstance(t, tgd.DfaGuidedDecoder):
        assert not disable
        np.testing.assert_array_equal(t.mask_words(), j.mask_words())


def test_clone_has_its_own_state():
    tok = ByteTokenizer()
    d = tst.make_guided_decoder(tok, {"choice": ["alpha", "beta"]})
    d.advance_token(ord("a"))
    c = d.clone()
    assert c.index is d.index and c.state == d.index.dfa.start
    assert d.state != c.state


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A sweeper that does not build raises with the compiler's output;
    neither the Python twin nor the partial-matching decoders stand in."""
    monkeypatch.setattr(sbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tgd, "_LIB", None)
    monkeypatch.setenv("CXX", "/bin/false")
    tok = ByteTokenizer()
    vc = tgd.VocabCodepoints(tok, len(tok))
    with pytest.raises(sbuild.NativeBuildError, match="false"):
        tgd.TokenDfaIndex(compile_dfa("ab+c"), vc)
    with pytest.raises(sbuild.NativeBuildError):
        tst.make_guided_decoder(ByteTokenizer(), {"regex": "ab+c"})
    assert tgd.TokenDfaIndex(compile_dfa("ab+c"), vc,
                             force_python=True)._handle is None
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_library_is_built_into_the_build_dir():
    tok = ByteTokenizer()
    idx = tgd.TokenDfaIndex(compile_dfa("ab+c"),
                            tgd.VocabCodepoints(tok, len(tok)))
    assert idx._handle is not None
    path = sbuild.library_path("token_dfa.cc")
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libtokendfa-")
