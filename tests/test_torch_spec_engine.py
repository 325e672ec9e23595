"""Suffix speculation through the port's engine against the JAX engine's.

- Runner parity: ``prepare_inputs`` builds the same arrays as the JAX
  runner over schedules carrying linear drafts and token trees, every key
  equal, the tree arrays (``attn_tree_start``, ``attn_row_tree_mask``,
  ``attn_item_tree_start``, ``attn_item_tree_mask``) included.
- Token parity on the trained checkpoint of tests/test_torch_engine.py in
  float32: with ``SpeculativeConfig(method="suffix")``, linear and
  ``use_tree_spec``, on the synchronous step of both engines
  (``enable_fused_decode=False``), the port's tokens equal the JAX
  engine's and the port's tokens without speculation, and ``spec_stats``
  are equal across the packages.  With the fused loops
  (``enable_fused_decode=True``) the two packages give the same tokens,
  ``spec_stats`` and ``width_stats``: the loop's host policy is a
  function of the drained telemetry (the checkpoint's head dim is 32, so
  neither package defers KV writes).  Both engines' suffix
  caches are seeded as tests/test_tree_spec.py seeds them (the true
  continuation plus a double-weighted corrupted one), so drafts exist and
  trees branch; the tree then beats the linear path on draft survival.
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import (Request,
                                                      SamplingParams)
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.engine.scheduler import Scheduler
from arcticinference_tpu_torch.models.loader import load_model

from tests.test_torch_engine import TINY, config_dict, trained  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its steps are hundreds of
    small ops, for which a thread pool only adds synchronisation (and,
    beside other test processes, contention)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def random_drafts(rng, tree: bool, n: int):
    toks = [int(x) for x in rng.integers(1, 97, n)]
    if not tree:
        return toks, None
    return toks, [int(rng.integers(-1, i)) if i else -1 for i in range(n)]


def test_prepare_inputs_with_drafts_matches_jax_runner(monkeypatch):
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    d = config_dict(hf=TINY)
    d["scheduler"]["max_num_batched_tokens"] = 64
    jconf, tconf = jcfg.EngineConfig.from_dict(d), \
        tcfg.EngineConfig.from_dict(d)
    jrun = JaxRunner(jconf, *jax_load_model(jconf.model))
    trun = ModelRunner(tconf, *load_model(tconf.model, "cpu"),
                       torch.device("cpu"))
    sched = Scheduler(tconf.scheduler, tconf.cache, trun.num_blocks)
    rng = np.random.default_rng(0)
    for i, n in enumerate((50, 7, 33, 12)):
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 97, n)],
            SamplingParams(max_tokens=40)))
    seen = {"tree": 0, "linear": 0, "qb": set()}
    step = 0
    while sched.num_unfinished:
        out = sched.schedule()
        ts, js = trun.prepare_inputs(out), jrun.prepare_inputs(out)
        assert (ts.t_pad, ts.s_pad, ts.attn_qb, ts.total_tokens) == \
            (js.t_pad, js.s_pad, js.attn_qb, js.total_tokens)
        assert ts.sample_row_start == js.sample_row_start
        assert ts.sample_row_count == js.sample_row_count
        assert ts.arrays.keys() == js.arrays.keys()
        for k, a in js.arrays.items():
            assert ts.arrays[k].dtype == a.dtype, k
            np.testing.assert_array_equal(ts.arrays[k], a, err_msg=k)
        if "attn_item_tree_mask" in ts.arrays:
            seen["tree"] += 1
            assert ts.attn_qb != 1
        seen["linear"] += any(s.spec_token_ids and s.spec_parents is None
                              for s in out.scheduled)
        seen["qb"].add(ts.attn_qb)
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            if not done:
                sched.update_after_step(s, [], 0)
                continue
            nd = len(s.spec_token_ids)
            if s.spec_parents is not None:
                # A tree commits its accepted path with num_accepted=0.
                sched.update_after_step(s, [5] * (1 + nd // 3), 0)
            else:
                n_acc = int(rng.integers(0, nd + 1))
                sched.update_after_step(s, [5] * (n_acc + 1), n_acc)
            stop = req.check_stop(None, 256)
            if stop is not None:
                sched.finish_request(req, stop)
                continue
            # Next step's drafts: alternate trees and chains, 1-30 nodes
            # (every third step at most 6, so narrow qb=8 steps occur).
            if req.num_computed_tokens >= len(req.prompt_token_ids):
                tree = (step + int(req.req_id[1:])) % 2 == 0
                req.spec_token_ids, req.spec_parents = random_drafts(
                    rng, tree, int(rng.integers(1, 7 if step % 3 else 31)))
        step += 1
    assert seen["tree"] > 3 and seen["linear"] > 3
    assert {8, 32} <= seen["qb"]


# ---------------------------------------------------------------------------
# Token parity on the trained checkpoint
# ---------------------------------------------------------------------------

GEN = 16
SPANS = ((0, 12), (40, 45), (120, 25), (200, 30))


def spec_kw(tree: bool) -> dict:
    return dict(method="suffix", use_tree_spec=tree,
                enable_fused_decode=False, suffix_max_spec_factor=4.0,
                suffix_max_spec_offset=8.0, suffix_min_token_prob=0.05)


def seed_cache(cache, prompts, outputs):
    """tests/test_tree_spec.py:145-157 on a 256-token vocabulary: the
    true continuation plus a double-weighted corrupted variant, so the
    linear path follows the wrong (more frequent) branch while a tree
    carries both."""
    for i, (p, out) in enumerate(zip(prompts, outputs)):
        seq = p[-6:] + out
        bad = list(seq)
        for flip in (9, 14, 19):
            bad[flip] = (bad[flip] + 7) % 250 + 1
        cache.update_response(f"warm-good-{i}", seq)
        cache.update_response(f"warm-bad-{i}", bad)
        cache.update_response(f"warm-bad2-{i}", list(bad))


@pytest.fixture(scope="module")
def baseline(trained):  # noqa: F811
    """Prompts, the JAX engine's greedy tokens without speculation (each
    emitted token's top-2 margin checked first) and the port's."""
    path, heldout = trained
    d = config_dict(model=path)
    prompts = [[int(t) for t in heldout[s:s + n]] for s, n in SPANS]
    ref = JaxLLM(jcfg.EngineConfig.from_dict(d)).generate(
        prompt_token_ids=prompts,
        sampling_params=JaxSamplingParams(max_tokens=GEN, ignore_eos=True,
                                          logprobs=2))
    for o in ref:
        for top2 in o.logprobs:
            a, b = sorted(top2.values(), reverse=True)
            assert a - b > 1e-4, "near tie in the JAX run"
    port = LLM(tcfg.EngineConfig.from_dict(d), device="cpu").generate(
        prompt_token_ids=prompts,
        sampling_params=SamplingParams(max_tokens=GEN, ignore_eos=True))
    return path, prompts, [o.token_ids for o in ref], \
        [o.token_ids for o in port]


def run_spec(jax_side: bool, path, prompts, seed_outputs, tree):
    d = config_dict(model=path)
    d["speculative"] = spec_kw(tree)
    if jax_side:
        llm = JaxLLM(jcfg.EngineConfig.from_dict(d))
        sp = JaxSamplingParams(max_tokens=GEN, ignore_eos=True)
    else:
        llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
        sp = SamplingParams(max_tokens=GEN, ignore_eos=True)
    seed_cache(llm.engine._suffix_cache, prompts, seed_outputs)
    outs = llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    stats = llm.engine.spec_stats
    llm.engine.close()
    return outs, stats


@pytest.fixture(scope="module", params=["linear", "tree"])
def spec_runs(request, baseline):
    """(mode, baseline, JAX run, port run) per draft mode: one JAX engine
    each (it compiles a step per bucket)."""
    path, prompts, ref_tokens, _ = baseline
    tree = request.param == "tree"
    return (request.param, baseline,
            run_spec(True, path, prompts, ref_tokens, tree),
            run_spec(False, path, prompts, ref_tokens, tree))


def test_spec_tokens_match_jax_and_no_spec(spec_runs):
    mode, (_, _, ref_tokens, port_tokens), (jouts, _), (touts, _) = \
        spec_runs
    assert port_tokens == ref_tokens
    for t, j, want in zip(touts, jouts, port_tokens):
        assert t.token_ids == j.token_ids == want
        assert t.finish_reason == j.finish_reason
        assert (t.num_draft_tokens, t.num_accepted_draft_tokens) == \
            (j.num_draft_tokens, j.num_accepted_draft_tokens)


def test_spec_stats_match_jax(spec_runs):
    mode, _, (_, jst), (touts, tst) = spec_runs
    assert tst.num_drafts > 0 and tst.num_accepted_tokens > 0
    assert (tst.num_drafts, tst.num_draft_tokens, tst.num_accepted_tokens,
            tst.num_accepted_tokens_per_pos) == \
        (jst.num_drafts, jst.num_draft_tokens, jst.num_accepted_tokens,
         jst.num_accepted_tokens_per_pos)
    assert sum(o.num_draft_tokens for o in touts) == tst.num_draft_tokens


def test_tree_beats_path_on_acceptance(baseline):
    """tests/test_tree_spec.py:193-210 on the port: where the corrupted
    continuation is the more frequent one, the linear path follows it and
    dies while the tree keeps the true branch; survival at draft
    position 3 (just past the first corruption) must be higher for the
    tree."""
    path, prompts, ref_tokens, _ = baseline
    _, t = run_spec(False, path, prompts, ref_tokens, tree=True)
    _, p = run_spec(False, path, prompts, ref_tokens, tree=False)
    assert t.num_drafts > 0 and p.num_drafts > 0
    t_surv = t.num_accepted_tokens_per_pos[3] / t.num_drafts
    p_surv = p.num_accepted_tokens_per_pos[3] / p.num_drafts
    assert t_surv > p_surv, (t.summary(), p.summary())


@pytest.mark.parametrize("tree", [False, True])
def test_spec_sampling_and_fused_default(baseline, tree):
    """The port's own paths beside the parity runs: ``enable_fused_decode``
    left at its default gives the same greedy tokens (linear drafts: the
    fused loop runs, and its steps are counted; trees: the synchronous
    step), and a seeded request with temperature > 0 (sample-and-compare
    verify on the synchronous step: a seeded request is not fusable) is
    reproducible from the same engine state and stays in the vocabulary.
    (Tree verify rows take their sampling counters by row, not by depth,
    as in the JAX runner, so seeded tokens depend on the drafts: a second
    run on the same engine, whose cache now holds the first run's output,
    may differ.)"""
    path, prompts, _, port_tokens = baseline
    d = config_dict(model=path)
    d["speculative"] = dict(spec_kw(tree), enable_fused_decode=not tree)
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=SamplingParams(max_tokens=GEN,
                                                       ignore_eos=True))
    assert [o.token_ids for o in outs] == port_tokens
    fused_steps = llm.engine.step_times.summary().get("fused", {})
    assert (fused_steps.get("count", 0) > 0) == (not tree)
    assert (llm.engine.width_stats is None) == tree
    llm.close()
    d["speculative"] = spec_kw(tree)
    conf = tcfg.EngineConfig.from_dict(d)
    sp = SamplingParams(max_tokens=GEN, ignore_eos=True, temperature=0.8,
                        seed=3)
    runs = []
    for _ in range(2):
        llm = LLM(conf, device="cpu")
        runs.append(llm.generate(prompt_token_ids=prompts[:2],
                                 sampling_params=sp))
        assert llm.engine.spec_stats.num_drafts > 0
        llm.close()
    a, b = ([o.token_ids for o in r] for r in runs)
    assert a == b
    assert all(len(t) == GEN and 0 <= min(t) and max(t) < 256 for t in a)


# ---------------------------------------------------------------------------
# The fused loop against the JAX engine's loop
# ---------------------------------------------------------------------------

def test_fused_loop_matches_jax_engine(baseline):
    """Both packages' fused loops (the knobs of ``spec_kw``), two passes
    each, the second over a cache holding the first's output: the
    baseline's tokens (whose top-2 margins the fixture checked), and
    identical draft statistics and program widths."""
    path, prompts, ref_tokens, _ = baseline
    d = config_dict(model=path)
    d["speculative"] = dict(spec_kw(False), enable_fused_decode=True)
    jllm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    for _ in range(2):
        j = jllm.generate(prompt_token_ids=prompts,
                          sampling_params=JaxSamplingParams(
                              max_tokens=GEN, ignore_eos=True))
        t = tllm.generate(prompt_token_ids=prompts,
                          sampling_params=SamplingParams(max_tokens=GEN,
                                                         ignore_eos=True))
        assert [o.token_ids for o in t] == [o.token_ids for o in j] == \
            ref_tokens
    js, ts = jllm.engine.spec_stats, tllm.engine.spec_stats
    assert ts.num_accepted_tokens > 0
    assert (ts.num_drafts, ts.num_draft_tokens, ts.num_accepted_tokens,
            ts.num_accepted_tokens_per_pos) == \
        (js.num_drafts, js.num_draft_tokens, js.num_accepted_tokens,
         js.num_accepted_tokens_per_pos)
    assert tllm.engine.width_stats == jllm.engine._fused.width_stats
    assert tllm.engine.step_times.summary()["fused"]["count"] > 0
    tllm.close()
    jllm.engine.close()


# ---------------------------------------------------------------------------
# Arctic MLP / LSTM drafters against the JAX engine's
# ---------------------------------------------------------------------------

DRAFTERS = ("mlp", "lstm", "fp8", "mlp+suffix")


def drafter_kw(kind: str, fused: bool, lstm_dir: str) -> dict:
    kw = dict(method="arctic", num_speculative_tokens=3,
              enable_fused_decode=fused)
    if kind == "lstm":
        kw["model"] = lstm_dir
    elif kind == "fp8":
        kw["quantization"] = "fp8"
    elif kind == "mlp+suffix":
        kw.update(enable_suffix_decoding=True, suffix_max_spec_factor=4.0,
                  suffix_max_spec_offset=8.0, suffix_min_token_prob=0.05)
    return kw


@pytest.fixture(scope="module")
def lstm_dir(tmp_path_factory):
    """A drafter directory holding only a config.json that names the
    sum_lstm method: both packages build a random-init LSTM drafter."""
    import json

    d = tmp_path_factory.mktemp("lstm_drafter")
    (d / "config.json").write_text(json.dumps({"method": "sum_lstm"}))
    return str(d)


@pytest.fixture(scope="module",
                params=[(k, f) for k in DRAFTERS for f in (False, True)],
                ids=[f"{k}-{'fused' if f else 'sync'}" for k in DRAFTERS
                     for f in (False, True)])
def drafter_runs(request, baseline, lstm_dir):
    """(kind, fused, baseline, JAX engine, its outputs, port engine, its
    outputs): the port's drafter holds the JAX engine's drafter
    parameters (bf16, fp8 bytes for the quantized one), carried across."""
    import jax

    from arcticinference_tpu_torch.weights import params_from_jax

    kind, fused = request.param
    path, prompts, ref_tokens, _ = baseline
    d = config_dict(model=path)
    d["speculative"] = drafter_kw(kind, fused, lstm_dir)
    jllm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    assert tllm.engine._drafter.kind == jllm.engine._drafter.kind == (
        "lstm" if kind == "lstm" else "mlp")
    tllm.engine._drafter.params = params_from_jax(
        jax.tree.map(np.asarray, jllm.engine._drafter.params), "cpu")
    if kind == "mlp+suffix":
        for llm in (jllm, tllm):
            seed_cache(llm.engine._suffix_cache, prompts, ref_tokens)
    else:
        assert tllm.engine._suffix_cache is None
    j = jllm.generate(prompt_token_ids=prompts,
                      sampling_params=JaxSamplingParams(max_tokens=GEN,
                                                        ignore_eos=True))
    t = tllm.generate(prompt_token_ids=prompts,
                      sampling_params=SamplingParams(max_tokens=GEN,
                                                     ignore_eos=True))
    yield kind, fused, baseline, jllm, j, tllm, t
    tllm.close()
    jllm.engine.close()


def test_drafter_tokens_match_jax_and_no_spec(drafter_runs):
    """Greedy tokens with a drafter equal the no-speculation run's and the
    JAX engine's; per-request draft counters too."""
    kind, fused, (_, _, ref_tokens, port_tokens), _, j, _, t = drafter_runs
    assert port_tokens == ref_tokens
    for to, jo, want in zip(t, j, ref_tokens):
        assert to.token_ids == jo.token_ids == want
        assert (to.num_draft_tokens, to.num_accepted_draft_tokens) == \
            (jo.num_draft_tokens, jo.num_accepted_draft_tokens)


def test_drafter_spec_stats_match_jax(drafter_runs):
    """``spec_stats`` equal to the JAX engine's; on the fused loop also
    ``width_stats`` (every step wide: the width policy is suffix-only)."""
    kind, fused, _, jllm, _, tllm, t = drafter_runs
    js, ts = jllm.engine.spec_stats, tllm.engine.spec_stats
    assert ts.num_drafts > 0
    assert (ts.num_drafts, ts.num_draft_tokens, ts.num_accepted_tokens,
            ts.num_accepted_tokens_per_pos) == \
        (js.num_drafts, js.num_draft_tokens, js.num_accepted_tokens,
         js.num_accepted_tokens_per_pos)
    assert sum(o.num_draft_tokens for o in t) == ts.num_draft_tokens
    steps = tllm.engine.step_times.summary()
    if fused:
        assert steps["fused"]["count"] > 0
        assert tllm.engine.width_stats == jllm.engine._fused.width_stats
        assert tllm.engine.width_stats["narrow"] == 0
    else:
        assert "fused" not in steps and tllm.engine.width_stats is None
    if kind == "mlp+suffix":
        # Seeded paths clear the drafter's score bar and are accepted.
        assert ts.num_accepted_tokens > 0
