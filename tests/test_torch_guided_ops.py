"""The port's guided ops (``ops/guided.py``) and vocab mask
(``ops/sampling.py::apply_vocab_mask``) against the JAX package's, on
seeded random pools, states, tokens and masks with padding rows; integer
results, so they must match exactly.  The pools hold real grammars'
device tables (the byte tokenizer of ``tests/test_torch_guided_dfa.py``)
beside random ones, and the states include dead (-1), padding and
out-of-range rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu.ops import guided as jguided
from arcticinference_tpu.ops import sampling as jsampling
from arcticinference_tpu_torch.ops import guided as tguided
from arcticinference_tpu_torch.ops import sampling as tsampling
from arcticinference_tpu_torch.serving.guided_dfa import compile_guided_dfa
from arcticinference_tpu_torch.serving.schema_regex import schema_to_regex

from tests.test_torch_guided_dfa import SCHEMAS, ByteTokenizer

P, S_PAD, I_PAD = 4, 64, 512


def grammar_pool():
    """A [P]-slot pool as the runner lays it out: slots 0-2 hold three
    grammars' tables, slot 3 random tables."""
    tok = ByteTokenizer()
    v, w = len(tok), (len(tok) + 31) // 32
    masks = np.zeros((P, S_PAD, w), np.int32)
    keys = np.full((P, I_PAD), np.iinfo(np.int32).max, np.int32)
    hi = np.full((P, I_PAD), -1, np.int32)
    nxt = np.full((P, I_PAD), -1, np.int32)
    n_states = []
    for slot, pat in enumerate((schema_to_regex(SCHEMAS[0]),
                                schema_to_regex(SCHEMAS[3]),
                                r"\d{4}-\d{2}-\d{2}")):
        idx = compile_guided_dfa(tok, v, pat)
        m, k, h, n = idx.device_tables()
        assert m.shape[0] <= S_PAD and len(k) <= I_PAD
        masks[slot, :m.shape[0]] = m.view(np.int32)
        keys[slot, :len(k)], hi[slot, :len(h)], nxt[slot, :len(n)] = k, h, n
        n_states.append(m.shape[0])
        cps = idx.vocab.cps_matrix().view(np.int32)
    rng = np.random.default_rng(0)
    masks[3] = rng.integers(-2 ** 31, 2 ** 31, (S_PAD, w), dtype=np.int64)
    st = np.sort(rng.integers(0, 40, 300))
    lo = rng.integers(0, 130, 300)
    order = np.lexsort((lo, st))
    keys[3, :300] = (st[order] << 21) | lo[order]
    hi[3, :300] = lo[order] + rng.integers(0, 5, 300)
    nxt[3, :300] = rng.integers(-1, 40, 300)
    n_states.append(40)
    return (masks, keys, hi, nxt, cps), n_states, v


@pytest.mark.parametrize("g", [1, 8, 64])
def test_guided_mask_rows_and_advance_match_jax(g):
    (masks, keys, hi, nxt, cps), n_states, v = grammar_pool()
    rng = np.random.default_rng(g)
    slots = rng.integers(-1, P, g).astype(np.int32)
    states = np.asarray([rng.integers(-1, n_states[s] + 2) if s >= 0 else
                         -1 for s in slots], np.int32)
    tokens = rng.integers(0, v, g).astype(np.int32)
    t = [torch.from_numpy(x) for x in (states, slots, tokens, masks, cps,
                                       keys, hi, nxt)]
    j = [jnp.asarray(x) for x in (states, slots, tokens, masks, cps,
                                  keys, hi, nxt)]
    np.testing.assert_array_equal(
        tguided.guided_mask_rows(t[0], t[1], t[3]).numpy(),
        np.asarray(jguided.guided_mask_rows(j[0], j[1], j[3])))
    out = tguided.guided_advance(t[0], t[1], t[2], *t[4:])
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jguided.guided_advance(j[0], j[1], j[2],
                                                       *j[4:])))


def test_guided_advance_walks_the_grammar():
    """Each state advanced on the device equals the host index's walk."""
    tok = ByteTokenizer()
    idx = compile_guided_dfa(tok, len(tok), schema_to_regex(SCHEMAS[0]))
    m, k, h, n = idx.device_tables()
    cps = torch.from_numpy(idx.vocab.cps_matrix().view(np.int32))
    pool = [torch.from_numpy(x)[None] for x in (k, h, n)]
    states = np.repeat(np.arange(idx.dfa.n_states, dtype=np.int32),
                       len(tok))
    tokens = np.tile(np.arange(len(tok), dtype=np.int32), idx.dfa.n_states)
    out = tguided.guided_advance(torch.from_numpy(states),
                                 torch.zeros(len(states), dtype=torch.int32),
                                 torch.from_numpy(tokens), cps, *pool)
    want = [idx.advance(int(s), int(t)) for s, t in zip(states, tokens)]
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("v", [33, 139, 1000])
def test_apply_vocab_mask_matches_jax_with_padding(v):
    rng = np.random.default_rng(v)
    n, g, w = 16, 8, (v + 31) // 32
    logits = rng.normal(0, 2, (n, v)).astype(np.float32)
    rows = np.full(g, -1, np.int32)
    rows[:5] = rng.choice(n, 5, replace=False)
    words = rng.integers(-2 ** 31, 2 ** 31, (g, w), dtype=np.int64) \
        .astype(np.int32)
    words[0] = 0                      # a row that allows nothing
    got = tsampling.apply_vocab_mask(torch.from_numpy(logits),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(words)).numpy()
    want = np.asarray(jsampling.apply_vocab_mask(
        jnp.asarray(logits), jnp.asarray(rows), jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)
    untouched = np.setdiff1d(np.arange(n), rows[:5])
    np.testing.assert_array_equal(got[untouched], logits[untouched])


def test_seeded_rows_come_from_host_arrays():
    """Seeds and counters as numpy arrays give the stream of CPU tensors;
    a device tensor (here on the meta device) is refused rather than
    read back."""
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(0, 1, (4, 50)).astype(np.float32))
    temp = torch.full((4,), 0.8)
    args = (logits, temp, torch.zeros(4, dtype=torch.int32),
            torch.ones(4))
    seeds = np.asarray([3, -1, 7, 3], np.int32)
    counters = np.asarray([5, 0, 9, 6], np.int32)
    a = tsampling.sample(*args, torch.Generator().manual_seed(0),
                         seeds=seeds, counters=counters)
    b = tsampling.sample(*args, torch.Generator().manual_seed(1),
                         seeds=torch.from_numpy(seeds),
                         counters=torch.from_numpy(counters))
    np.testing.assert_array_equal(a[[0, 2, 3]].numpy(),
                                  b[[0, 2, 3]].numpy())
    with pytest.raises(ValueError, match="host"):
        tsampling._row_uniforms(4, 50, torch.Generator(), logits.device,
                                torch.empty(4, device="meta"), None)
