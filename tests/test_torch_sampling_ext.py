"""Penalties, vocab masks, verification and logprobs of the port against
the JAX package.

- The sampling ops (``ops/sampling.py``): ``apply_penalties`` exact to
  1e-6 in float32 (with -1 padding and repeated tokens),
  ``apply_vocab_mask`` and ``verify_greedy`` exact, ``verify_stochastic``
  on cases whose outcome does not depend on the random numbers (torch's
  and JAX's generators differ).
- The runner's penalty rows and token histories equal the JAX runner's.
- On the trained tiny Llama checkpoint, against the JAX engine: greedy
  tokens with penalties are equal; ``logprobs=5`` gives the same ids in
  the same order, with log-probabilities within 1e-3; a
  suffix-speculation engine keeps such requests on the synchronous step,
  with the same tokens, and commits logprobs for accepted drafts.

Why 1e-3 and not float32's 1e-5: both engines keep K/V in a bf16 cache.
The two float32 forwards differ by ~1e-5 on this checkpoint (9e-6 on its
logits through a float32 cache, each ~5e-6 from a float64 forward), and
a K or V value that lies that close to a bf16 rounding boundary rounds
one way in one engine and the other way in the other: one bf16 ulp
(2^-8 relative).  That moves later logits by up to ~2e-4 (measured over
the top 16 candidates of these prompts without penalties); 1e-3 is the
bound ``tests/test_torch_model.py`` gives bf16 rounding differences.

The JAX runs' top-2 margins are checked at every emitted token first, so
a near tie cannot make a token comparison flaky.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu.ops import sampling as jsampling
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.fused_decode import FusedDecodeLoop
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import (Request,
                                                      SamplingParams)
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.engine.scheduler import Scheduler
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.ops import sampling as tsampling

from tests.test_torch_engine import TINY, config_dict, trained  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its steps are hundreds of
    small ops, for which a thread pool only adds synchronisation."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def both(fn_j, fn_t, *arrays):
    """The JAX op and the port's on the same numpy arrays, as numpy."""
    j = fn_j(*(jnp.asarray(a) for a in arrays))
    t = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays))
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, v, lo, la = 6, 50, 12, 20
    logits = rng.normal(0, 3, (n, v)).astype(np.float32)
    # Histories with repeats (tokens from a small range) and -1 padding.
    out_t = rng.integers(0, 10, (n, lo)).astype(np.int32)
    all_t = rng.integers(0, 25, (n, la)).astype(np.int32)
    for r in range(n):
        out_t[r, rng.integers(0, lo):] = -1
        all_t[r, rng.integers(lo, la):] = -1
    out_t[0] = -1                        # a row without output yet
    rep = rng.uniform(0.5, 2.0, n).astype(np.float32)
    pres = rng.uniform(-1, 1, n).astype(np.float32)
    freq = rng.uniform(-1, 1, n).astype(np.float32)
    rep[1], pres[1], freq[1] = 1.0, 0.0, 0.0      # a neutral row
    j, t = both(jsampling.apply_penalties, tsampling.apply_penalties,
                logits, out_t, all_t, rep, pres, freq)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[1], logits[1])
    assert np.abs(t - logits).max() > 0.1


@pytest.mark.parametrize("v", [64, 77])
def test_apply_vocab_mask_matches_jax(v):
    rng = np.random.default_rng(v)
    n, w = 8, -(-v // 32)
    logits = rng.normal(0, 1, (n, v)).astype(np.float32)
    rows = np.array([3, -1, 0, 6, -1], np.int32)
    words = rng.integers(-2 ** 31, 2 ** 31, (len(rows), w)).astype(np.int32)
    words[2] = 0                        # a row that allows nothing
    j, t = both(jsampling.apply_vocab_mask, tsampling.apply_vocab_mask,
                logits, rows, words)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[[1, 2, 4, 5, 7]], logits[[1, 2, 4, 5, 7]])
    assert (t[0] == np.finfo(np.float32).min).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_verify_greedy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, k = 16, 5
    argmax = rng.integers(0, 4, (b, k + 1)).astype(np.int32)
    drafts = np.where(rng.random((b, k)) < 0.7, argmax[:, :k],
                      rng.integers(0, 4, (b, k))).astype(np.int32)
    num_draft = rng.integers(0, k + 1, b).astype(np.int32)
    j, t = both(jsampling.verify_greedy, tsampling.verify_greedy,
                drafts, num_draft, argmax)
    for a, c in zip(t, j):
        np.testing.assert_array_equal(a, c)
    assert t[0].dtype == np.int32 and (t[1] > 1).any()


def one_hot_rows(b, k, v, tokens):
    p = np.zeros((b, k + 1, v), np.float32)
    for i in range(b):
        for j in range(k + 1):
            p[i, j, tokens[i][j]] = 1.0
    return p


@pytest.mark.parametrize("case", ["accept", "reject", "residual"])
def test_verify_stochastic_certain_outcomes(case):
    """Outcomes that hold for any random numbers: every draft accepted
    (the target gives each drafted token probability 1) and the bonus
    drawn from a one-hot row; the first draft rejected (probability 0)
    and resampled from a one-hot row; a rejected draft whose target row
    holds it and one other token, so the residual is a single mass."""
    b, k, v = 4, 3, 16
    drafts = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]],
                      np.int32)
    num_draft = np.array([3, 3, 2, 1], np.int32)
    if case == "accept":
        targets = [list(d) + [13] for d in drafts]
        want_acc = num_draft
    else:
        targets = [[14] * (k + 1) for _ in range(b)]
        want_acc = np.zeros(b, np.int32)
    probs = one_hot_rows(b, k, v, targets)
    if case == "residual":
        probs[:, 0] = 0.0
        for i in range(b):
            probs[i, 0, drafts[i, 0]] = 0.6
            probs[i, 0, 15] = 0.4
    draft_probs = np.ones((b, k), np.float32)
    if case == "residual":
        # Accepted when u * q <= 0.6: q = 1e6 rejects for any u > 6e-7.
        draft_probs[:] = 1e6
    # The token after the accepted drafts: all accepted, the bonus from
    # the target row after the last draft (rows 2 and 3 drafted 2 and 1
    # tokens: their rows hold drafts 9 and 11); else the resample.
    want_extra = {"accept": [13, 13, 9, 11], "reject": [14] * b,
                  "residual": [15] * b}[case]
    jout = jsampling.verify_stochastic(
        jnp.asarray(drafts), jnp.asarray(draft_probs),
        jnp.asarray(num_draft), jnp.asarray(probs), jax.random.PRNGKey(3))
    tout = tsampling.verify_stochastic(
        torch.from_numpy(drafts), torch.from_numpy(draft_probs),
        torch.from_numpy(num_draft), torch.from_numpy(probs),
        torch.Generator().manual_seed(3))
    tt, tn = tout[0].numpy(), tout[1].numpy()
    np.testing.assert_array_equal(tt, np.asarray(jout[0]))
    np.testing.assert_array_equal(tn, np.asarray(jout[1]))
    np.testing.assert_array_equal(tn, want_acc + 1)
    for i in range(b):
        assert tt[i, want_acc[i]] == want_extra[i]
        assert list(tt[i, :want_acc[i]]) == list(drafts[i, :want_acc[i]])
        assert (tt[i, want_acc[i] + 1:] == tsampling.NO_TOKEN).all()


def test_runner_penalty_arrays_match_jax(monkeypatch):
    """Penalty rows and the bucketed token histories (every verify row of
    a request carries its history before the step) equal the JAX
    runner's, on prefill, mixed and decode steps with drafts."""
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    d = config_dict(hf=TINY)
    jconf, tconf = jcfg.EngineConfig.from_dict(d), \
        tcfg.EngineConfig.from_dict(d)
    jrun = JaxRunner(jconf, *jax_load_model(jconf.model))
    trun = ModelRunner(tconf, *load_model(tconf.model, "cpu"),
                       torch.device("cpu"))
    sched = Scheduler(tconf.scheduler, tconf.cache, trun.num_blocks)
    rng = np.random.default_rng(0)
    params = [SamplingParams(max_tokens=5, repetition_penalty=1.3),
              SamplingParams(max_tokens=5),
              SamplingParams(max_tokens=5, presence_penalty=0.5,
                             frequency_penalty=0.25),
              SamplingParams(max_tokens=5, logprobs=3)]
    for i, (n, sp) in enumerate(zip((40, 7, 20, 12), params)):
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 97, n)], sp))
    with_pen = with_drafts = 0
    while sched.num_unfinished:
        out = sched.schedule()
        ts, js = trun.prepare_inputs(out), jrun.prepare_inputs(out)
        assert ts.arrays.keys() == js.arrays.keys()
        for k, a in js.arrays.items():
            assert ts.arrays[k].dtype == a.dtype, k
            np.testing.assert_array_equal(ts.arrays[k], a, err_msg=k)
        with_pen += "pen_out_tokens" in ts.arrays
        with_drafts += any(s.spec_token_ids for s in out.scheduled)
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            if not done:
                sched.update_after_step(s, [], 0)
                continue
            n_acc = len(s.spec_token_ids) // 2
            sched.update_after_step(s, [5 + req.num_tokens % 7] *
                                    (n_acc + 1), n_acc)
            stop = req.check_stop(None, 256)
            if stop is not None:
                sched.finish_request(req, stop)
                continue
            req.spec_token_ids = [3, 4]      # the next step verifies two
    assert with_pen > 2 and with_drafts > 2


def test_fusable_refuses_penalties_and_logprobs():
    """The fused loop mirrors neither (JAX ``_fusable``): such requests
    ride the synchronous step."""
    mk = lambda **k: Request("r", [1, 2], SamplingParams(**k))  # noqa: E731
    assert FusedDecodeLoop._fusable(mk())
    for kw in (dict(repetition_penalty=1.1), dict(presence_penalty=0.1),
               dict(frequency_penalty=0.1), dict(logprobs=1)):
        assert not FusedDecodeLoop._fusable(mk(**kw)), kw


# ---------------------------------------------------------------------------
# The engines on the trained checkpoint
# ---------------------------------------------------------------------------

PROMPTS = ((0, 12), (40, 45), (120, 25), (200, 70), (300, 8))
# Penalties of each request (repetition, presence, frequency); request 4
# asks for none, so a step mixes penalised and plain rows.
PENALTIES = ((1.3, 0.0, 0.0), (1.0, 0.5, 0.3), (1.2, 0.5, 0.3),
             (1.0, 0.0, 0.8), (1.0, 0.0, 0.0))
QUANT = (None, "fp8", "int4")
LOGPROB_TOL = 1e-3


def prompts_of(heldout):
    return [[int(t) for t in heldout[s:s + n]] for s, n in PROMPTS]


def params(cls, logprobs):
    return [cls(max_tokens=12, repetition_penalty=r, presence_penalty=p,
                frequency_penalty=f, logprobs=logprobs)
            for r, p, f in PENALTIES]


def assert_no_near_ties(outs):
    for o in outs:
        for lp in o.logprobs:
            a, b = sorted(lp.values(), reverse=True)[:2]
            assert a - b > 1e-4, "near tie in the JAX run"


@pytest.fixture(scope="module")
def jax_runs(trained):
    """The JAX engine's outputs with logprobs=5, per quantization."""
    path, heldout = trained
    runs = {}
    for q in QUANT:
        llm = JaxLLM(jcfg.EngineConfig.from_dict(
            config_dict(model=path, quantization=q)))
        runs[q] = llm.generate(prompt_token_ids=prompts_of(heldout),
                               sampling_params=params(JaxSamplingParams, 5))
        assert_no_near_ties(runs[q])
        llm.close()
    return runs


@pytest.fixture(scope="module")
def port_runs(trained):
    """The port's outputs: with logprobs=5 and without logprobs."""
    path, heldout = trained
    runs = {}
    for q in QUANT:
        llm = LLM(tcfg.EngineConfig.from_dict(
            config_dict(model=path, quantization=q)), device="cpu")
        runs[q, 5] = llm.generate(prompt_token_ids=prompts_of(heldout),
                                  sampling_params=params(SamplingParams, 5))
        if q is None:
            runs[q, None] = llm.generate(
                prompt_token_ids=prompts_of(heldout),
                sampling_params=params(SamplingParams, None))
        llm.close()
    return runs


@pytest.mark.parametrize("quantization", QUANT)
def test_penalty_tokens_match_jax_engine(jax_runs, port_runs, quantization):
    for o, r in zip(port_runs[quantization, 5], jax_runs[quantization]):
        assert o.token_ids == r.token_ids
        assert o.finish_reason == r.finish_reason
    if quantization is None:
        # Penalties move tokens (else the comparison shows nothing), and
        # asking for logprobs does not.
        for o, r in zip(port_runs[None, None], port_runs[None, 5]):
            assert o.token_ids == r.token_ids and o.logprobs is None
        plain = port_runs[None, 5][4].token_ids
        assert plain != port_runs[None, 5][0].token_ids


@pytest.mark.parametrize("quantization", QUANT)
def test_logprobs_match_jax_engine(jax_runs, port_runs, quantization):
    for o, r in zip(port_runs[quantization, 5], jax_runs[quantization]):
        assert len(o.logprobs) == len(o.token_ids) == len(r.logprobs)
        for got, want, tok in zip(o.logprobs, r.logprobs, o.token_ids):
            assert list(got) == list(want)          # ids, in rank order
            np.testing.assert_allclose(list(got.values()),
                                       list(want.values()),
                                       atol=LOGPROB_TOL, rtol=0)
            # Greedy: the committed token is the top candidate.
            assert next(iter(got)) == tok
            assert all(p <= 0 for p in got.values())


@pytest.mark.parametrize("fused", [True, False])
def test_suffix_engine_keeps_such_requests_on_the_sync_step(
        trained, jax_runs, fused):
    """Suffix speculation with the fused loop (the default) leaves
    penalised and logprob requests to the synchronous step, beside a
    plain request that rides the loop; without the loop the synchronous
    step drafts for logprob requests and commits logprobs for accepted
    drafts.  Tokens and logprobs equal the JAX engine's run without
    speculation."""
    path, heldout = trained
    d = config_dict(model=path)
    d["speculative"] = dict(method="suffix", enable_fused_decode=fused)
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    prompts = prompts_of(heldout)
    # Seed the suffix cache with the continuations, so drafts exist.
    for i, r in enumerate(jax_runs[None]):
        llm.engine._suffix_cache.update_response(
            f"warm-{i}", prompts[i][-6:] + r.token_ids)
    sps = params(SamplingParams, 5)
    sps[4] = SamplingParams(max_tokens=12)          # fusable
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sps)
    for i, (o, r) in enumerate(zip(outs, jax_runs[None])):
        assert o.token_ids == r.token_ids
        if i < 4:
            assert len(o.logprobs) == len(o.token_ids)
            for got, want in zip(o.logprobs, r.logprobs):
                assert list(got) == list(want)
                np.testing.assert_allclose(list(got.values()),
                                           list(want.values()),
                                           atol=LOGPROB_TOL)
    # Penalised requests take no drafts; the plain one drafts (on the
    # device with the loop).
    assert outs[4].num_draft_tokens > 0
    assert all(o.num_draft_tokens == 0 for o in outs[:4])
    if fused:
        assert llm.engine.step_times.summary()["fused"]["count"] > 0
    llm.close()


def test_logprobs_of_accepted_drafts(trained, jax_runs):
    """A logprob request without penalties drafts on the synchronous
    step: every committed token, accepted drafts included, gets the
    candidates of the verify row that produced it, equal to the JAX run
    without speculation."""
    path, heldout = trained
    d = config_dict(model=path)
    d["speculative"] = dict(method="suffix", enable_fused_decode=False)
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    prompts = prompts_of(heldout)
    sp = SamplingParams(max_tokens=12, logprobs=5)
    ref = JaxLLM(jcfg.EngineConfig.from_dict(config_dict(model=path)))
    want = ref.generate(prompt_token_ids=prompts[:3],
                        sampling_params=JaxSamplingParams(max_tokens=12,
                                                          logprobs=5))
    ref.close()
    assert_no_near_ties(want)
    for i, r in enumerate(want):
        llm.engine._suffix_cache.update_response(
            f"warm-{i}", prompts[i][-6:] + r.token_ids)
    outs = llm.generate(prompt_token_ids=prompts[:3], sampling_params=sp)
    assert sum(o.num_accepted_draft_tokens for o in outs) > 0
    for o, r in zip(outs, want):
        assert o.token_ids == r.token_ids
        assert len(o.logprobs) == len(o.token_ids)
        for got, exp in zip(o.logprobs, r.logprobs):
            assert list(got) == list(exp)
            np.testing.assert_allclose(list(got.values()),
                                       list(exp.values()),
                                       atol=LOGPROB_TOL)
    llm.close()
