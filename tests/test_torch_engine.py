"""The port's host engine against the JAX package's.

- Runner parity: ``prepare_inputs`` builds the same arrays (every key,
  ``attn_qb``, ``t_pad``, ``s_pad``) over a schedule of chunked prefill,
  mixed and pure-decode steps.
- Token parity: greedy ``LLM.generate`` gives the JAX engine's tokens on a
  small trained checkpoint, in float32.  The JAX run's top-2 logit margin
  is checked at every emitted token first, so a near tie cannot make the
  comparison flaky (random weights are not compared on tokens: their
  argmax ties diverge).
- Import isolation: the port imports neither jax nor the JAX package.
"""

import subprocess
import sys

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
from arcticinference_tpu_torch.utils import resolve_device

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2)


def config_dict(model="llama", hf=None, dtype="float32", quantization=None):
    return dict(
        model=dict(model=model, hf_overrides=hf or {}, max_model_len=256,
                   dtype=dtype, quantization=quantization),
        cache=dict(num_blocks=64),
        scheduler=dict(max_num_seqs=4, max_num_batched_tokens=32))


def test_prepare_inputs_matches_jax_runner(monkeypatch):
    # Both runners then route every pure-decode step to attn_qb == 1.
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    d = config_dict(hf=TINY)
    jconf, tconf = jcfg.EngineConfig.from_dict(d), \
        tcfg.EngineConfig.from_dict(d)
    jrun = JaxRunner(jconf, *jax_load_model(jconf.model))
    trun = ModelRunner(tconf, *load_model(tconf.model, "cpu"),
                       torch.device("cpu"))
    sched = Scheduler(tconf.scheduler, tconf.cache, trun.num_blocks)
    rng = np.random.default_rng(0)
    for i, n in enumerate((50, 7, 33, 12, 90)):
        sp = SamplingParams(max_tokens=3)
        if i == 2:
            sp = SamplingParams(max_tokens=3, temperature=0.7, top_k=5,
                                top_p=0.9, min_p=0.05, seed=11)
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 97, n)], sp))
    qbs = set()
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
        qbs.add(ts.attn_qb)
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            sched.update_after_step(s, [5] if done else [], 0)
            if req.check_stop(None, 256) is not None:
                sched.finish_request(req, req.check_stop(None, 256))
    assert qbs == {1, 8, 32}     # decode, narrow-mixed and wide steps


# ---------------------------------------------------------------------------
# Token parity on a trained checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny HF Llama trained for a short run (CPU torch, no download);
    head_dim 32, so both engines run their reference attention."""
    from tests.quality_utils import train_tiny_checkpoint

    d = tmp_path_factory.mktemp("torch_port_ckpt")
    _, heldout = train_tiny_checkpoint(d, steps=60)
    return str(d), heldout


@pytest.mark.parametrize("quantization", [None, "fp8", "int8", "int4"])
def test_greedy_tokens_match_jax_engine(trained, quantization):
    """Quantized: both engines quantize the checkpoint's float32 weights
    on load (the same bytes and scales) and run the kernels' plain
    versions on the CPU."""
    path, heldout = trained
    d = config_dict(model=path, quantization=quantization)
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 45), (120, 25), (200, 70),
                            (300, 8))]
    jax_llm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    ref = jax_llm.generate(
        prompt_token_ids=prompts,
        sampling_params=JaxSamplingParams(max_tokens=12, logprobs=2))
    for o in ref:
        for top2 in o.logprobs:
            a, b = sorted(top2.values(), reverse=True)
            assert a - b > 1e-4, "near tie in the JAX run"
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    assert llm.tokenizer is not None
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=SamplingParams(max_tokens=12))
    for o, r in zip(outs, ref):
        assert o.token_ids == r.token_ids
        assert o.finish_reason == r.finish_reason
        assert o.text == r.text


# ---------------------------------------------------------------------------
# Engine behaviour of the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_llm():
    return LLM(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
               device="cpu")


def test_stop_token_and_lengths(tiny_llm):
    base = tiny_llm.generate(prompt_token_ids=[[5, 6, 7]],
                             sampling_params=SamplingParams(max_tokens=5))
    assert len(base[0].token_ids) == 5
    assert base[0].finish_reason == "finished_length"
    first = base[0].token_ids[0]
    out = tiny_llm.generate(
        prompt_token_ids=[[5, 6, 7]],
        sampling_params=SamplingParams(max_tokens=5,
                                       stop_token_ids=(first,)))
    assert out[0].token_ids == [first]
    assert out[0].finish_reason == "finished_stopped"


def test_seeded_sampling_is_reproducible(tiny_llm):
    sp = SamplingParams(max_tokens=6, temperature=1.0, top_k=20, seed=7)
    a = tiny_llm.generate(prompt_token_ids=[[3, 4, 5]], sampling_params=sp)
    b = tiny_llm.generate(prompt_token_ids=[[3, 4, 5], [9, 9]],
                          sampling_params=sp)
    assert a[0].token_ids == b[0].token_ids
    assert all(0 <= t < 97 for t in b[1].token_ids)


def test_step_kinds_are_recorded(tiny_llm):
    tiny_llm.generate(prompt_token_ids=[[1] * 40, [2] * 3],
                      sampling_params=SamplingParams(max_tokens=4))
    summary = tiny_llm.engine.step_times.summary()
    assert summary["decode"]["tokens"] > 0
    assert summary["mixed"]["count"] > 0


def test_unported_features_raise(tiny_llm, tmp_path):
    """Guided decoding and a drafter without its weights still raise;
    penalties and logprobs are ported (they raised before): such
    requests run, with one logprob dict per token.  SwiftKV is ported
    too (tests/test_torch_swiftkv.py)."""
    with pytest.raises(NotImplementedError):
        tiny_llm.engine.add_request("g", [1, 2],
                                    SamplingParams(guided=object()))
    outs = tiny_llm.generate(
        prompt_token_ids=[[1, 2, 3], [4, 5]],
        sampling_params=[SamplingParams(max_tokens=4, repetition_penalty=1.2,
                                        presence_penalty=0.5,
                                        frequency_penalty=0.3),
                         SamplingParams(max_tokens=4, logprobs=2)])
    assert [len(o.token_ids) for o in outs] == [4, 4]
    assert outs[0].logprobs is None
    assert [len(lp) for lp in outs[1].logprobs] == [2] * 4
    assert [next(iter(lp)) for lp in outs[1].logprobs] == outs[1].token_ids
    # A distilled drafter (spec/distill.py) is ported; one whose
    # checkpoint lacks its weights file raises.
    (tmp_path / "config.json").write_text('{"distilled_tied": true}')
    d = config_dict(hf=TINY)
    d["speculative"] = dict(method="arctic", model=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        LLM(tcfg.EngineConfig.from_dict(d), device="cpu")


@pytest.mark.parametrize("quantization", [None, "int4"])
def test_auto_num_blocks_counts_quantized_weights(quantization):
    """The cache is sized from device memory less the weights: values
    and scales of a quantized weight, bytes of a plain one."""
    d = config_dict(hf=dict(TINY, hidden_size=128, intermediate_size=256),
                    quantization=quantization)
    d["cache"]["num_blocks"] = None
    conf = tcfg.EngineConfig.from_dict(d)
    runner = ModelRunner(conf, *load_model(conf.model, "cpu"),
                         torch.device("cpu"))
    weight_bytes = sum(v.nbytes for v in (
        *runner.params["layers"].values(),
        *(v for k, v in runner.params.items() if k != "layers")))
    wq = runner.params["layers"]["wqkv"]
    if quantization:
        assert wq.nbytes == wq.weight.numel() + wq.scale.numel() * 4
    budget = int(2 * 1024 ** 3 * conf.cache.hbm_utilization) - \
        weight_bytes - (1 << 30)
    assert runner.num_blocks == min(
        max(budget // runner.kv_spec.bytes_per_block, 16), 1 << 17)


def test_cuda_default_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["load_model", "LLM", "LLM swiftkv"])
def test_entry_points_run_on_the_card_by_default(entry):
    """Without ``device`` the model goes to cuda:0; with no card that
    raises rather than running on the CPU.  SwiftKV's engine too."""
    conf = tcfg.EngineConfig.from_dict(
        config_dict("llama_swiftkv", dict(TINY, num_hidden_layers=4,
                                          num_key_value_layers=2))
        if entry.endswith("swiftkv") else config_dict(hf=TINY))

    def build():
        if entry == "load_model":
            return load_model(conf.model)[2]["embed"].device
        return LLM(conf).engine.device

    if torch.cuda.is_available():
        assert build() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import arcticinference_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'arcticinference_tpu'"
        " or m.startswith('arcticinference_tpu.')]\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('arcticinference_tpu_torch')]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
