"""The port's device-resident fused decode loop (suffix speculation).

- The suffix-only and width-policy cases of tests/test_fused_decode.py on
  the port, on the CPU (parity with the JAX engine's loop is in
  tests/test_torch_spec_engine.py, beside its trained checkpoint): greedy output with the loop equals the port's
  output without speculation (verification reproduces the target argmax
  chain), through late admission, aborts, staggered stops, block
  exhaustion, protected requests, non-fusable requests, the corruption
  knob and every program width (wide, narrow, per slot).
- Deferred KV writes in the loop, on a random float32 model with head dim
  64: the same tokens with and without ``ARCTIC_TPU_DEFERRED_KV=1``, the
  injection path reached only with it.
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                              ModelConfig, SchedulerConfig,
                                              SpeculativeConfig)
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models import llama as tllama

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16)


def tiny_config(spec=None, num_blocks=128, hf=None) -> EngineConfig:
    """tests/test_engine.py's tiny_config on the port."""
    return EngineConfig(
        model=ModelConfig(model="llama", hf_overrides={**TINY, **(hf or {})},
                          max_model_len=256, dtype="float32"),
        cache=CacheConfig(block_size=8, num_blocks=num_blocks),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
        speculative=spec)


def suffix(fused=True, **kw) -> SpeculativeConfig:
    return SpeculativeConfig(method="suffix", enable_fused_decode=fused, **kw)


def prompts_of(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 97, rng.integers(3, 30))]
            for _ in range(n)]


def repetitive(n=2, seed=10):
    # Repetition makes the suffix tree accept drafts.
    rng = np.random.default_rng(seed)
    base = [int(x) for x in rng.integers(1, 97, 6)]
    return [(base * 4)[:20] for _ in range(n)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a step of this tiny model is hundreds of
    small ops, for which a thread pool only adds synchronisation (and,
    beside other test processes, contention)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def base():
    """The port without speculation: the greedy oracle."""
    return LLM(tiny_config(), device="cpu")


def greedy(llm, prompts, sp):
    return [o.token_ids for o in llm.generate(prompt_token_ids=prompts,
                                              sampling_params=sp)]


def fused_llm(**kw):
    llm = LLM(tiny_config(suffix(**kw)), device="cpu")
    assert llm.engine._fused is not None
    return llm


def drive(eng, adds, max_steps=400):
    """Step ``eng`` until done; ``adds`` maps a step number to the
    requests (id, prompt, params) added before it.  Returns the finished
    requests by id and whether the loop was active at any step."""
    done, steps, active = {}, 0, False
    while eng.has_unfinished or steps == 0 or any(s > steps for s in adds):
        steps += 1
        assert steps < max_steps
        for rid, p, sp in adds.get(steps, ()):
            eng.add_request(rid, p, sp)
        for r in eng.step():
            done[r.req_id] = r
        active |= eng._fused.active
    return done, active


# ---------------------------------------------------------------------------
# tests/test_fused_decode.py:197-259 (TestFusedSuffixOnly)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_spec", "sync_suffix", "long"])
def test_suffix_loop_matches_greedy(base, case):
    """The loop's tokens equal the no-speculation and the synchronous
    suffix path's; drafts are verified, and on a 40-token run of a
    looping model and prompt, accepted."""
    prompts, sp = repetitive(2), SamplingParams(max_tokens=24)
    if case == "sync_suffix":
        prompts, sp = repetitive(3, seed=11), SamplingParams(max_tokens=20)
    elif case == "long":
        prompts, sp = repetitive(1, seed=12), SamplingParams(max_tokens=40)
    want = (greedy(LLM(tiny_config(suffix(False)), device="cpu"), prompts, sp)
            if case == "sync_suffix" else greedy(base, prompts, sp))
    llm = fused_llm()
    assert greedy(llm, prompts, sp) == want
    st = llm.engine.spec_stats
    assert st.num_drafts > 0
    assert llm.engine.step_times.summary()["fused"]["count"] > 0
    assert llm.engine.width_stats["entries"] > 0
    if case == "long":
        assert st.num_accepted_tokens > 0


def test_staggered_finish(base):
    """Slots stop at different steps while the loop runs on for the
    others."""
    prompts = repetitive(3, seed=13)
    lens = [5, 25, 12]
    wants = [greedy(base, [p], SamplingParams(max_tokens=n))[0]
             for p, n in zip(prompts, lens)]
    eng = fused_llm().engine
    done, _ = drive(eng, {1: [(f"r{i}", p, SamplingParams(max_tokens=n))
                              for i, (p, n) in enumerate(zip(prompts,
                                                             lens))]})
    assert [done[f"r{i}"].output_token_ids for i in range(3)] == wants


@pytest.mark.parametrize("prompts", ["repetitive", "random"])
def test_temperature_sampling_runs(prompts):
    """Sampled rows (per-row temperature, top-k) stay in the vocabulary
    and every request reaches its length."""
    ps = repetitive(2, seed=14) if prompts == "repetitive" else \
        prompts_of(2, seed=6)
    llm = fused_llm()
    outs = llm.generate(prompt_token_ids=ps, sampling_params=SamplingParams(
        max_tokens=15, temperature=0.8, top_k=20))
    for o in outs:
        assert len(o.token_ids) == 15
        assert all(0 <= t < 97 for t in o.token_ids)
    assert llm.engine.width_stats["wide"] + \
        llm.engine.width_stats["narrow"] > 0


# ---------------------------------------------------------------------------
# tests/test_fused_decode.py:88-195 with method="suffix"
# ---------------------------------------------------------------------------

def test_late_admission_exits_and_reenters(base):
    """A request arriving mid-decode prefills in interleaved admission
    steps while the loop keeps decoding, then the loop re-enters with
    it; outputs are unaffected."""
    rng = np.random.default_rng(7)
    pa = [int(x) for x in rng.integers(1, 97, 8)]
    pb = [int(x) for x in rng.integers(1, 97, 100)]   # 2 chunks @ 64
    sa = SamplingParams(max_tokens=40, ignore_eos=True)
    sb = SamplingParams(max_tokens=12, ignore_eos=True)
    want_a, want_b = greedy(base, [pa], sa)[0], greedy(base, [pb], sb)[0]
    eng = fused_llm().engine
    eng.add_request("a", pa, sa)
    done, steps, during_b_prefill = {}, 0, False
    b_req = None
    while eng.has_unfinished or steps == 0:
        steps += 1
        assert steps < 300
        if steps == 6:
            b_req = eng.add_request("b", pb, sb)
        if b_req is not None and 0 < b_req.num_computed_tokens < len(pb):
            during_b_prefill |= eng._fused.active
        for r in eng.step():
            done[r.req_id] = r.output_token_ids
    assert done == {"a": want_a, "b": want_b}
    assert during_b_prefill
    assert eng.width_stats["entries"] >= 2


def test_abort_mid_loop():
    eng = fused_llm().engine
    ps = prompts_of(2, seed=5)
    eng.add_request("a", ps[0], SamplingParams(max_tokens=40))
    eng.add_request("b", ps[1], SamplingParams(max_tokens=40,
                                               ignore_eos=True))
    for _ in range(8):
        eng.step()
    assert eng._fused.active
    eng.abort_request("a")
    assert not eng._fused.active
    done, _ = drive(eng, {})
    assert len(done["b"].output_token_ids) == 40


def test_kill_switch(monkeypatch, base):
    monkeypatch.setenv("ARCTIC_TPU_DISABLE_FUSED", "1")
    p = prompts_of(1, seed=8)
    eng = fused_llm().engine
    done, active = drive(eng, {1: [("a", p[0],
                                    SamplingParams(max_tokens=4))]})
    assert not active and eng.width_stats["entries"] == 0
    assert done["a"].output_token_ids == greedy(
        base, p, SamplingParams(max_tokens=4))[0]


@pytest.mark.parametrize("num_blocks,max_tokens", [(20, 30), (26, 48)])
def test_block_pressure(base, num_blocks, max_tokens):
    """Tight caches: with 20 blocks pre-extension fails and the loop
    exits to the sync path's preemption; with 26, an admission under
    block pressure preempts the newcomer, never a loop-owned request,
    whose output stays exact."""
    rng = np.random.default_rng(9)
    llm = LLM(tiny_config(suffix(), num_blocks=num_blocks), device="cpu")
    eng = llm.engine
    if num_blocks == 20:
        for o in llm.generate(prompt_token_ids=prompts_of(3, seed=9),
                              sampling_params=SamplingParams(
                                  max_tokens=max_tokens)):
            assert len(o.token_ids) == max_tokens
        return
    pa = [int(x) for x in rng.integers(1, 97, 8)]
    sa = SamplingParams(max_tokens=max_tokens, ignore_eos=True)
    want = greedy(base, [pa], sa)[0]
    big = [int(x) for x in rng.integers(1, 97, 120)]
    done, active = drive(eng, {
        1: [("a", pa, sa)],
        5: [("big", big, SamplingParams(max_tokens=4, ignore_eos=True))]})
    assert active
    assert done["a"].output_token_ids == want
    assert "big" in done


# ---------------------------------------------------------------------------
# tests/test_fused_decode.py:535-588 (per-slot fusability, corruption knob)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["seeded_and_greedy", "all_seeded"])
def test_non_fusable_requests(mix):
    """Seeded requests are not fusable: they ride interleaved sync steps
    while greedy slots stay in the loop (all seeded: the loop never
    enters), with the synchronous suffix path's tokens."""
    prompts = prompts_of(4 if mix == "seeded_and_greedy" else 2, seed=7)
    seeded = SamplingParams(max_tokens=12, temperature=0.8, seed=123)
    sps = ([SamplingParams(max_tokens=12)] * 3 + [seeded]
           if mix == "seeded_and_greedy" else [seeded] * 2)
    want = [o.token_ids for o in LLM(tiny_config(suffix(False)),
                                     device="cpu").generate(
        prompt_token_ids=prompts, sampling_params=sps)]
    llm = fused_llm()
    got = [o.token_ids for o in llm.generate(prompt_token_ids=prompts,
                                             sampling_params=sps)]
    assert got == want
    entries = llm.engine.width_stats["entries"]
    assert (entries > 0) == (mix == "seeded_and_greedy")


def test_corruption_knob_preserves_output(monkeypatch, base):
    """ARCTIC_TPU_FUSED_CORRUPT_RATE may only slow the loop down: with
    every draft corrupted, (almost) none is accepted and the tokens are
    unchanged."""
    prompts = repetitive(3, seed=9)
    sp = SamplingParams(max_tokens=24, ignore_eos=True)
    want = greedy(base, prompts, sp)
    monkeypatch.setenv("ARCTIC_TPU_FUSED_CORRUPT_RATE", "1.0")
    llm = fused_llm(suffix_cache_max_depth=32)
    assert greedy(llm, prompts, sp) == want
    assert greedy(llm, prompts, sp) == want
    st = llm.engine.spec_stats
    assert st.num_drafts > 0
    assert st.acceptance_rate < 0.2


# ---------------------------------------------------------------------------
# tests/test_fused_decode.py:590-797 (program width)
# ---------------------------------------------------------------------------

def _chop_every_third(loop, policy: str):
    """Force every third step narrow while paths are live: the global
    TTL (``step``) or every slot's (``_slot_policy``)."""
    calls = {"n": 0}
    name = "step" if policy == "global" else "_slot_policy"
    orig = getattr(type(loop), name)

    def chopped(self):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            if policy == "global":
                self._wide_ttl = 0
                self._retry = 2
            elif self._slot_arrays_ready:
                self._slot_ttl[:] = 0
                self._slot_retry[:] = 2
        return orig(self)

    setattr(loop, name, chopped.__get__(loop))


@pytest.mark.parametrize("policy", ["global", "slotted"])
def test_narrow_steps_with_live_paths_lose_no_tokens(monkeypatch, base,
                                                     policy):
    """A narrow step (or a slot granted one row) while the device's path
    state holds drafts must verify none of them: a lucky column-0 match
    would advance n_computed past what telemetry emitted."""
    if policy == "global":
        monkeypatch.setenv("ARCTIC_TPU_DISABLE_SLOTTED", "1")
    prompts = prompts_of(3, seed=5 if policy == "global" else 41)
    sp = SamplingParams(max_tokens=24, ignore_eos=True)
    want = greedy(base, prompts, sp)
    llm = fused_llm(suffix_cache_max_depth=32)
    _chop_every_third(llm.engine._fused, policy)
    assert greedy(llm, prompts, sp) == want
    assert greedy(llm, prompts, sp) == want
    ws = llm.engine.width_stats
    assert ws["narrow"] > 0 and ws["wide"] > 0


def test_dry_and_warm_exact(base):
    """Dry cache (no path ever offered: narrow every step) and warm cache
    (a repeat pass walks paths on wide steps) both give the baseline."""
    prompts = prompts_of(3, seed=11)
    sp = SamplingParams(max_tokens=20, ignore_eos=True)
    want = greedy(base, prompts, sp)
    dry = fused_llm(suffix_cache_max_depth=32, suffix_min_token_prob=1.01)
    assert greedy(dry, prompts, sp) == want
    assert dry.engine.spec_stats.num_drafts == 0
    assert dry.engine.width_stats["wide"] == 0
    warm = fused_llm(suffix_cache_max_depth=32)
    assert greedy(warm, prompts, sp) == want
    assert greedy(warm, prompts, sp) == want
    assert warm.engine.spec_stats.num_accepted_tokens > 0


def test_width_entry_gated_on_consumption_history():
    """A loop whose previous entry consumed drafts re-enters wide
    (depth + 2 TTL); a cold loop enters at TTL 0 and probes."""
    prompts = prompts_of(3, seed=21)
    sp = SamplingParams(max_tokens=20, ignore_eos=True)
    llm = fused_llm(suffix_cache_max_depth=32)
    loop = llm.engine._fused
    ttls = []
    orig = type(loop).enter

    def spy(self):
        orig(self)
        ttls.append(self._wide_ttl)

    loop.enter = spy.__get__(loop)
    llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    assert ttls[0] == 0
    first = len(ttls)
    llm.generate(prompt_token_ids=prompts, sampling_params=sp)
    assert llm.engine.spec_stats.num_accepted_tokens > 0
    assert ttls[first] == loop.depth + 2


def test_mixed_widths_in_one_step_exact(base):
    """Half the batch hot (repeat prompts), half fresh: steps run the
    per-slot program with some slots at K+1 rows and some at 1, and every
    request keeps the baseline's tokens."""
    hot, fresh = prompts_of(2, seed=31), prompts_of(2, seed=77)
    sp = SamplingParams(max_tokens=24, ignore_eos=True)
    want = greedy(base, hot + fresh, sp)
    llm = fused_llm(suffix_cache_max_depth=32)
    loop = llm.engine._fused
    mixed = {"n": 0}
    orig = type(loop)._slot_policy

    def spy(self):
        paths, rplan, r_bucket, wide = orig(self)
        if r_bucket is not None:
            b = self._state["n_computed"].shape[0]
            widths = rplan[2 * r_bucket + b:2 * r_bucket + 2 * b]
            alive = np.asarray(self._host_alive, bool)
            if (widths > 1).any() and (widths[alive] == 1).any():
                mixed["n"] += 1
        return paths, rplan, r_bucket, wide

    loop._slot_policy = spy.__get__(loop)
    greedy(llm, hot, sp)                 # trains the cache on hot only
    assert greedy(llm, hot + fresh, sp) == want
    assert llm.engine.spec_stats.num_accepted_tokens > 0
    assert mixed["n"] > 0, "no step ran with mixed per-slot widths"


# ---------------------------------------------------------------------------
# Deferred KV writes in the loop
# ---------------------------------------------------------------------------

def test_deferred_kv_in_the_loop_keeps_tokens(monkeypatch):
    """A random float32 model with head dim 64 (the deferred path's
    width): the loop's tokens, drafts and widths are the same with and
    without ARCTIC_TPU_DEFERRED_KV=1, and only the run with it attends
    injected rows.  In the run without it every live verify row's top-2
    logit margin is above 1e-4, so no tie decides the comparison."""
    hf = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
              head_dim=64)
    prompts = repetitive(3, seed=17) + prompts_of(1, seed=18)
    sp = SamplingParams(max_tokens=24, ignore_eos=True)
    seen = {"deferred": 0, "margins": [], "live": None}
    kernel = tllama.grouped_decode_attention_kernel
    forward, compute_logits = tllama.forward, tllama.compute_logits

    def kernel_spy(*a, **k):
        seen["deferred"] += k.get("knew") is not None
        return kernel(*a, **k)

    def forward_spy(params, arch, kv, inputs, **kw):
        seen["live"] = inputs["req_idx"] >= 0
        return forward(params, arch, kv, inputs, **kw)

    def logits_spy(params, rows):
        out = compute_logits(params, rows)
        live = seen["live"]
        if live is not None and live.shape[0] == out.shape[0] and \
                live.any():
            top2 = out[live].topk(2, dim=-1).values  # a fused step's rows
            seen["margins"].append(float((top2[:, 0] - top2[:, 1]).min()))
        return out

    monkeypatch.setattr(tllama, "grouped_decode_attention_kernel",
                        kernel_spy)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("ARCTIC_TPU_DEFERRED_KV", flag)
        monkeypatch.setattr(tllama, "forward", forward_spy)
        monkeypatch.setattr(tllama, "compute_logits",
                            logits_spy if flag == "0" else compute_logits)
        seen["deferred"] = 0
        llm = LLM(tiny_config(suffix(suffix_cache_max_depth=32), hf=hf),
                  device="cpu")
        toks = [greedy(llm, prompts, sp) for _ in range(2)]
        eng = llm.engine
        runs[flag] = (toks, eng.spec_stats.summary(), eng.width_stats,
                      seen["deferred"])
        llm.close()
    assert runs["0"][:3] == runs["1"][:3]
    assert runs["0"][3] == 0 and runs["1"][3] > 0
    assert runs["1"][1]["num_accepted_tokens"] > 0
    assert len(seen["margins"]) > 10 and min(seen["margins"]) > 1e-4


# ---------------------------------------------------------------------------
# The drafter branch: Arctic MLP / LSTM drafters in the loop
# ---------------------------------------------------------------------------

def arctic(fused=True, **kw) -> SpeculativeConfig:
    return SpeculativeConfig(method="arctic", num_speculative_tokens=3,
                             enable_fused_decode=fused, **kw)


@pytest.fixture(scope="module")
def lstm_dir(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("lstm_drafter")
    (d / "config.json").write_text(json.dumps({"method": "sum_lstm"}))
    return str(d)


@pytest.mark.parametrize("kind", ["mlp", "lstm", "int8", "mlp+suffix"])
def test_drafter_loop_matches_greedy(base, lstm_dir, kind):
    """Every fused step drafts on the device from the drafter chain (the
    seeded suffix paths first where they clear the score bar), and the
    loop's tokens equal the no-speculation run's; every step is wide."""
    kw = dict(lstm=dict(model=lstm_dir), int8=dict(quantization="int8"),
              **{"mlp+suffix": dict(enable_suffix_decoding=True)}).get(
                  kind, {})
    prompts, sp = repetitive(3, seed=15), SamplingParams(max_tokens=20)
    want = greedy(base, prompts, sp)
    llm = LLM(tiny_config(arctic(**kw)), device="cpu")
    eng = llm.engine
    assert eng._fused is not None and eng._fused.eligible()
    assert (eng._suffix_cache is not None) == (kind == "mlp+suffix")
    if kind == "mlp+suffix":
        for i, (p, w) in enumerate(zip(prompts, want)):
            eng._suffix_cache.update_response(f"warm{i}", p + w)
    assert greedy(llm, prompts, sp) == want
    fused = eng.step_times.summary()["fused"]["count"]
    ws = eng.width_stats
    assert fused > 0 and ws["narrow"] == 0 and ws["wide"] == fused
    # Every fused step past an entry's first verifies drafts.
    assert eng.spec_stats.num_drafts >= fused - 3 * ws["entries"]
    assert eng._fused._k == eng._drafter.n_predict == 3
    if kind == "mlp+suffix":
        assert eng.spec_stats.num_accepted_tokens > 0
    llm.close()


def test_drafter_abort_mid_loop_and_stop_token(base):
    """With a drafter: an abort exits the loop and the survivor finishes
    its length; a stop token ends a request at its first emission."""
    eng = LLM(tiny_config(arctic()), device="cpu").engine
    ps = prompts_of(2, seed=5)
    eng.add_request("a", ps[0], SamplingParams(max_tokens=40))
    eng.add_request("b", ps[1], SamplingParams(max_tokens=40,
                                               ignore_eos=True))
    for _ in range(8):
        eng.step()
    assert eng._fused.active
    eng.abort_request("a")
    assert not eng._fused.active
    done, _ = drive(eng, {})
    assert len(done["b"].output_token_ids) == 40
    sp = SamplingParams(max_tokens=12, ignore_eos=True)
    first = greedy(base, [ps[1]], sp)[0][3]
    done, active = drive(eng, {1: [("c", ps[1], SamplingParams(
        max_tokens=12, ignore_eos=True, stop_token_ids=(first,)))]})
    want = greedy(base, [ps[1]], sp)[0]
    assert active
    assert done["c"].output_token_ids == want[:want.index(first) + 1]
    assert done["c"].status.name == "FINISHED_STOPPED"


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_arctic_spec_near_max_len(offset, fused):
    """tests/test_speculators.py:172-183 on the port: drafts near
    max_model_len never run a request past it."""
    cfg = tiny_config(arctic(fused))
    cfg.model.max_model_len = 48
    llm = LLM(cfg, device="cpu")
    prompt = [5, 6, 7, 8, 9, 10, 11][:7 - offset]
    out = llm.generate(prompt_token_ids=[prompt],
                       sampling_params=SamplingParams(max_tokens=100,
                                                      ignore_eos=True))
    assert len(prompt) + len(out[0].token_ids) == 48
    assert out[0].finish_reason == "finished_length"
    assert llm.engine.spec_stats.num_drafts > 0


@pytest.mark.parametrize("fused", [False, True])
def test_drafter_disabled_by_batch_size(base, fused):
    """tests/test_speculators.py's disable_by_batch_size case with a
    drafter: three requests admitted together and finishing together run
    above the bound throughout, so no drafts, and the tokens of no
    speculation."""
    llm = LLM(tiny_config(arctic(fused, disable_by_batch_size=1)),
              device="cpu")
    prompts = [[3, 14, 15, 92], [5, 6, 7, 8], [9, 10, 11, 12]]
    sp = SamplingParams(max_tokens=10, ignore_eos=True)
    assert greedy(llm, prompts, sp) == greedy(base, prompts, sp)
    assert llm.engine.spec_stats.num_drafts == 0
