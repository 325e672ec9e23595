"""The port's pipelined step and guided decoding against its synchronous
step and against the JAX engine.

- Runner parity: ``prepare_inputs`` with ``passthrough`` and
  ``guided_dev`` (and with host-built guided masks) gives the JAX
  runner's arrays element for element (``input_src``, ``gd_*``,
  ``guided_rows``, ``guided_mask``), its guided index and its
  grammar-state count.
- Pipelined against synchronous tokens on one engine (the trained tiny
  checkpoint, float32): greedy, seeded sampling, logprobs, stop strings,
  ``max_tokens`` overshoot trimmed, a preemption flush under a tiny KV
  pool and an abort while steps are in flight.  Step kinds are recorded,
  and penalties force the synchronous step.
- On that checkpoint the port's pipelined greedy tokens, plain and
  guided by a regex, equal the JAX engine's (whose run checks its top-2
  margin at every token first, so that a near tie cannot make the
  comparison flaky).
- The JAX guided engine tests (``tests/test_guided_dfa.py``, without the
  mesh cases) on a random tiny model: conforming output, guided requests
  riding the pipeline with the synchronous path's tokens, pool overflow
  and non-DFA decoders falling back to the synchronous step, ``n > 1``
  cloning the decoder, several grammars in one batch.
"""

import json

import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu.serving.structured import (
    make_guided_decoder as jax_make_guided_decoder)
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.engine import PENDING_TOKEN
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import (Request,
                                                      SamplingParams)
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.engine.scheduler import Scheduler
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.serving.guided_dfa import (DfaGuidedDecoder,
                                                          compile_guided_dfa)
from arcticinference_tpu_torch.serving.schema_regex import schema_to_regex
from arcticinference_tpu_torch.serving.structured import make_guided_decoder
from arcticinference_tpu_torch.stats import StepTimeStats

from tests.test_torch_engine import config_dict, trained  # noqa: F401
from tests.test_torch_guided_dfa import SCHEMAS, ByteTokenizer

GUIDED_TINY = dict(vocab_size=139, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=4, head_dim=16)
LEXICON_RE = ("(?:sun|moon|star|wind|rain)"
              "(?: (?:sun|moon|star|wind|rain|snow|tree|leaf)){3,6}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its steps are hundreds of
    small ops, for which a thread pool only adds synchronisation."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def run(llm, prompts, params, pipelined: bool):
    """``generate`` on ``llm``'s engine with the pipelined step on or off;
    returns the outputs and the step kinds recorded by this run."""
    eng = llm.engine
    eng._pipeline = pipelined
    eng.step_times = StepTimeStats()
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=params)
    assert not eng._inflight and not eng._pending_ref
    return outs, dict(eng.step_times._counts)


def assert_same_outputs(a, b, logprobs=False):
    for x, y in zip(a, b):
        assert x.token_ids == y.token_ids
        assert x.finish_reason == y.finish_reason
        assert x.text == y.text
        assert PENDING_TOKEN not in x.token_ids
        if logprobs:
            assert len(x.logprobs) == len(x.token_ids)
            for p, q in zip(x.logprobs, y.logprobs):
                assert list(p) == list(q)
                np.testing.assert_allclose(list(p.values()),
                                           list(q.values()), atol=1e-5)


# ---------------------------------------------------------------------------
# Runner parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guided_path", ["host_masks", "device_pool"])
def test_prepare_inputs_with_passthrough_and_guided_matches_jax(
        guided_path, monkeypatch):
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    d = config_dict(hf=GUIDED_TINY)
    jconf, tconf = jcfg.EngineConfig.from_dict(d), \
        tcfg.EngineConfig.from_dict(d)
    jrun = JaxRunner(jconf, *jax_load_model(jconf.model))
    trun = ModelRunner(tconf, *load_model(tconf.model, "cpu"),
                       torch.device("cpu"))
    sched = Scheduler(tconf.scheduler, tconf.cache, trun.num_blocks)
    tok = ByteTokenizer()
    rng = np.random.default_rng(0)
    for i, n in enumerate((50, 7, 33, 12, 90)):
        guided = None
        if i % 2 == 0:
            guided = make_guided_decoder(tok, {"json": SCHEMAS[i % 4]})
            assert isinstance(guided, DfaGuidedDecoder)
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 139, n)],
            SamplingParams(max_tokens=4, guided=guided,
                           temperature=0.5 * (i % 3), seed=i)))
    n_guided = n_passthrough = 0
    while sched.num_unfinished:
        out = sched.schedule()
        frontier = [s.request for s in out.scheduled
                    if s.request.output_token_ids]
        passthrough = {r.req_id: int(rng.integers(0, 64))
                       for r in frontier if rng.random() < 0.7}
        guided_dev = None
        if guided_path == "device_pool":
            guided_dev = {
                s.request.req_id: (int(rng.integers(0, 8)),
                                   int(rng.integers(-1, 40)),
                                   s.request.sampling.guided.state)
                for s in out.scheduled if s.request.sampling.guided}
        ts = trun.prepare_inputs(out, passthrough, guided_dev)
        js = jrun.prepare_inputs(out, passthrough, guided_dev)
        assert (ts.t_pad, ts.s_pad, ts.attn_qb, ts.total_tokens,
                ts.gstate_count, ts.guided_index) == \
            (js.t_pad, js.s_pad, js.attn_qb, js.total_tokens,
             js.gstate_count, js.guided_index)
        assert ts.arrays.keys() == js.arrays.keys()
        for k, a in js.arrays.items():
            assert ts.arrays[k].dtype == a.dtype, k
            np.testing.assert_array_equal(ts.arrays[k], a, err_msg=k)
        n_guided += "guided_rows" in ts.arrays
        n_passthrough += int((ts.arrays["input_src"] >= 0).sum())
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            tok_id = 0
            if done and req.sampling.guided is not None:
                tok_id = req.sampling.guided.fallback_token()
                req.sampling.guided.advance_token(tok_id)
            sched.update_after_step(s, [tok_id] if done else [], 0)
            stop = req.check_stop(None, 256)
            if stop is not None:
                sched.finish_request(req, stop)
    assert n_guided > 0 and n_passthrough > 0


# ---------------------------------------------------------------------------
# Pipelined against synchronous, on the trained checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_llm(trained):
    path, heldout = trained
    d = config_dict(model=path)
    d["cache"]["enable_prefix_caching"] = False
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 45), (120, 25), (200, 70),
                            (300, 8))]
    return llm, prompts


CASES = {
    "greedy": lambda i: SamplingParams(max_tokens=12),
    "seeded": lambda i: SamplingParams(max_tokens=12, temperature=0.8,
                                       top_k=20, seed=i),
    "logprobs": lambda i: SamplingParams(max_tokens=8, logprobs=3,
                                         temperature=0.7 * (i % 2),
                                         seed=i),
    "stop_strings": lambda i: SamplingParams(max_tokens=16,
                                             stop=(" moon", "ice")),
    "overshoot": lambda i: SamplingParams(max_tokens=1 + i % 3,
                                          stop_token_ids=(83,)),
}


@pytest.mark.parametrize("case", CASES)
def test_pipelined_tokens_equal_sync(trained_llm, case):
    llm, prompts = trained_llm
    params = [CASES[case](i) for i in range(len(prompts))]
    pipe, kinds_pipe = run(llm, prompts, params, True)
    sync, kinds_sync = run(llm, prompts, params, False)
    assert set(kinds_pipe) == {"pipelined"}
    assert "pipelined" not in kinds_sync
    assert_same_outputs(pipe, sync, logprobs=case == "logprobs")
    if case == "stop_strings":
        assert any(o.finish_reason == "finished_stopped" for o in pipe)
    if case == "overshoot":
        assert [len(o.token_ids) for o in pipe] == [
            len(o.token_ids) for o in sync]


def test_step_kinds_and_penalties_force_sync(trained_llm):
    llm, prompts = trained_llm
    plain = SamplingParams(max_tokens=4)
    _, kinds = run(llm, prompts[:2], plain, True)
    assert set(kinds) == {"pipelined"}
    _, kinds = run(llm, prompts[:2], plain, False)
    assert kinds.get("decode", 0) > 0 and kinds.get("mixed", 0) > 0
    _, kinds = run(llm, prompts[:2],
                   [plain, SamplingParams(max_tokens=4,
                                          repetition_penalty=1.3)], True)
    assert "pipelined" not in kinds and kinds.get("decode", 0) > 0


def test_preemption_flushes_the_pipeline(trained):
    path, heldout = trained
    d = config_dict(model=path)
    d["cache"].update(num_blocks=8, enable_prefix_caching=False)
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    sched = llm.engine.scheduler
    preempt, count = sched._preempt, [0]

    def counted(*a, **k):
        victim = preempt(*a, **k)
        count[0] += victim is not None
        return victim

    sched._preempt = counted
    prompts = [[int(t) for t in heldout[s:s + 60]] for s in (0, 90, 180,
                                                             270)]
    params = SamplingParams(max_tokens=24, ignore_eos=True)
    pipe, kinds = run(llm, prompts, params, True)
    n_pipe = count[0]
    sync, _ = run(llm, prompts, params, False)
    assert n_pipe > 0 and count[0] > n_pipe
    assert set(kinds) == {"pipelined"}
    assert_same_outputs(pipe, sync)
    assert all(len(o.token_ids) == 24 for o in pipe)


def test_abort_while_steps_are_in_flight(trained_llm):
    llm, prompts = trained_llm
    eng = llm.engine
    eng._pipeline = True
    params = SamplingParams(max_tokens=10)
    for i, p in enumerate(prompts[:3]):
        eng.add_request(f"ab{i}", p, params)
    while not (eng._inflight and any(
            r.req_id == "ab1" and PENDING_TOKEN in r.output_token_ids
            for r in eng.scheduler.running)):
        eng.step()
    req = eng.abort_request("ab1")
    assert req.status.name == "FINISHED_ABORTED"
    assert PENDING_TOKEN not in req.output_token_ids
    done = {}
    while eng.has_unfinished:
        done.update((r.req_id, r) for r in eng.step())
    assert "ab1" not in done and not eng._pending_ref
    sync, _ = run(llm, [prompts[0], prompts[2]], params, False)
    assert [done["ab0"].output_token_ids, done["ab2"].output_token_ids] == \
        [o.token_ids for o in sync]


def _assert_no_near_tie(outs):
    for o in outs:
        for top2 in o.logprobs:
            a, b = sorted(top2.values(), reverse=True)[:2]
            assert a - b > 1e-4, "near tie in the JAX run"


def test_pipelined_greedy_matches_jax_engine(trained_llm, trained):
    llm, prompts = trained_llm
    jllm = JaxLLM(jcfg.EngineConfig.from_dict(config_dict(
        model=trained[0])))
    assert jllm.engine._pipeline
    ref = jllm.generate(prompt_token_ids=prompts,
                        sampling_params=JaxSamplingParams(max_tokens=12,
                                                          logprobs=2))
    _assert_no_near_tie(ref)
    outs, kinds = run(llm, prompts, SamplingParams(max_tokens=12), True)
    assert set(kinds) == {"pipelined"}
    for o, r in zip(outs, ref):
        assert (o.token_ids, o.finish_reason, o.text) == \
            (r.token_ids, r.finish_reason, r.text)

    # Guided by a regex over the corpus's words, on both engines' own
    # tokenizers and decoders: the device pool in both, the port's host
    # masks too.
    jdec = [jax_make_guided_decoder(jllm.tokenizer, {"regex": LEXICON_RE})
            for _ in prompts]
    ref = jllm.generate(prompt_token_ids=prompts, sampling_params=[
        JaxSamplingParams(max_tokens=40, logprobs=2, guided=g)
        for g in jdec])
    _assert_no_near_tie(ref)
    for pipelined in (True, False):
        params = [SamplingParams(max_tokens=40, guided=make_guided_decoder(
            llm.tokenizer, {"regex": LEXICON_RE})) for _ in prompts]
        assert isinstance(params[0].guided, DfaGuidedDecoder)
        outs, kinds = run(llm, prompts, params, pipelined)
        assert ("pipelined" in kinds) == pipelined
        for o, r in zip(outs, ref):
            assert (o.token_ids, o.finish_reason, o.text) == \
                (r.token_ids, r.finish_reason, r.text)
            assert o.finish_reason == "finished_stopped"


# ---------------------------------------------------------------------------
# Guided engine cases of the JAX package, on a random tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def guided_llm():
    d = config_dict(hf=GUIDED_TINY)
    d["cache"] = dict(block_size=8, num_blocks=64,
                      enable_prefix_caching=False)
    d["scheduler"]["max_num_batched_tokens"] = 64
    return LLM(tcfg.EngineConfig.from_dict(d), device="cpu")


def dfa_decoder(i: int) -> DfaGuidedDecoder:
    tok = ByteTokenizer()
    return DfaGuidedDecoder(
        compile_guided_dfa(tok, 139, schema_to_regex(SCHEMAS[i])),
        schema=SCHEMAS[i])


def text_of(token_ids) -> str:
    return ByteTokenizer().decode(token_ids)


def check_conforms(i: int, text: str) -> None:
    doc = json.loads(text)
    if i == 0:
        assert set(doc) == {"a", "b"} and isinstance(doc["a"], int) and \
            isinstance(doc["b"], bool)
    else:
        assert doc in ["red", "green", "blue", 17, None]


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sync"])
def test_guided_output_conforms(guided_llm, pipelined):
    """Random weights at temperature 1.5 almost never propose a valid
    token: conforming output shows the mask constrained every step (the
    decoders' host fallback must stay cold).  A bounded grammar (enum)
    under greedy argmax lands on one of its literals."""
    decs = [dfa_decoder(0), dfa_decoder(3)]
    for d in decs:
        d.fallback_token = lambda: pytest.fail("host fallback used")
    outs, kinds = run(guided_llm, [[3, 14, 15, 9, 26], [5, 6]], [
        SamplingParams(max_tokens=120, temperature=1.5, seed=0,
                       guided=decs[0]),
        SamplingParams(max_tokens=40, guided=decs[1])], pipelined)
    assert ("pipelined" in kinds) == pipelined
    check_conforms(0, text_of(outs[0].token_ids))
    check_conforms(3, text_of(outs[1].token_ids))
    assert decs[0].schema_ok is True
    assert all(o.finish_reason == "finished_stopped" for o in outs)


def test_guided_rides_pipeline_and_matches_sync(guided_llm):
    """Several grammars and an unguided request in one batch, seeded:
    the device pool's tokens equal the host masks' tokens."""
    prompts = [[3, 14, 15], [4, 14, 15], [7, 9], [3, 14]]

    def params():
        return [SamplingParams(max_tokens=100, temperature=1.2, seed=11,
                               guided=dfa_decoder(0)),
                SamplingParams(max_tokens=80, temperature=1.0, seed=1,
                               guided=dfa_decoder(3)),
                SamplingParams(max_tokens=10, ignore_eos=True),
                SamplingParams(max_tokens=60, temperature=1.0, seed=2,
                               guided=dfa_decoder(0))]

    pipe, kinds_pipe = run(guided_llm, prompts, params(), True)
    assert guided_llm.engine._guided_slots
    sync, kinds_sync = run(guided_llm, prompts, params(), False)
    assert kinds_pipe.get("pipelined", 0) > 0 and len(kinds_pipe) == 1
    assert "pipelined" not in kinds_sync
    assert_same_outputs(pipe, sync)
    for o, i in zip(pipe, (0, 3, None, 0)):
        if i is not None:
            check_conforms(i, text_of(o.token_ids))


def test_pool_overflow_and_non_dfa_decoders_take_sync(guided_llm,
                                                      monkeypatch):
    eng = guided_llm.engine
    monkeypatch.setattr(eng.runner, "GUIDED_POOL_SLOTS", 1)
    monkeypatch.setattr(eng, "_guided_slots", {})
    outs, kinds = run(guided_llm, [[3, 14], [4, 14]], [
        SamplingParams(max_tokens=80, temperature=1.0, seed=i,
                       guided=dfa_decoder(s))
        for i, s in enumerate((0, 3))], True)
    assert kinds.get("decode", 0) > 0
    check_conforms(0, text_of(outs[0].token_ids))
    check_conforms(3, text_of(outs[1].token_ids))
    monkeypatch.setenv("ARCTIC_TPU_DISABLE_GUIDED_DFA", "1")
    dec = make_guided_decoder(ByteTokenizer(), {"choice": ["red", "blue"]})
    assert not isinstance(dec, DfaGuidedDecoder)
    outs, kinds = run(guided_llm, [[3, 14]],
                      SamplingParams(max_tokens=10, guided=dec), True)
    assert "pipelined" not in kinds
    assert text_of(outs[0].token_ids) in ("red", "blue")


def test_n_greater_one_clones_decoder(guided_llm):
    outs, kinds = run(guided_llm, [[3, 14, 15]], SamplingParams(
        max_tokens=40, temperature=1.0, seed=3, n=3,
        guided=dfa_decoder(3)), True)
    assert len(outs) == 3 and "pipelined" in kinds
    for o in outs:
        check_conforms(3, text_of(o.token_ids))
