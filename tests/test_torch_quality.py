"""The port's quality gate and accuracy harness on the tiny trained
checkpoint, built by the port (``benchmarks/tiny_markov.py``, 300 steps,
2 query heads of 64 over 1 KV head) and read by both packages.

- Perplexity gate (``benchmarks/quality_gate.py``, the JAX gate's
  ``tests/test_quality_gate.py``): held-out perplexity through
  ``LLM.score`` for bf16, fp8, int8, int4 and fp8 weights with an fp8 KV
  cache; the port's bf16 below 2.5 and each precision's ratio to the
  port's own bf16 within the JAX bounds.  In float32 activations each
  precision's perplexity equals the JAX engine's to a relative 1e-4 (the
  measured gap is ~6e-6; bf16 activations differ by ~5e-4 between the
  two packages' CPU kernels, so the exact comparison runs in float32).
- Logit KL of fp8 / int8 / int4 against bf16 over one 256-token prefill
  (``LLMEngine.prompt_logits``): within the JAX bounds, and in float32
  activations equal to the JAX module's KL on the same checkpoint to
  5e-6 absolute.
- Accuracy harness (``benchmarks/accuracy_harness.py``, the JAX
  ``tests/benchmarks/test_accuracy.py``): the JAX test's tasks and bars
  over bf16 / fp8 / int8 ``LocalClient``s, and the port's rows equal to
  the JAX harness's metrics in float32; a task file round trip; the
  port's server (``serve --device cpu``) scored over ``HTTPClient``'s
  echo within 5e-2 of ``LocalClient``, and 4 generated tokens.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu_torch.benchmarks import accuracy_harness as ah
from arcticinference_tpu_torch.benchmarks import quality_gate as qg
from arcticinference_tpu_torch.benchmarks.tiny_markov import (
    train_tiny_checkpoint)
from arcticinference_tpu_torch.engine.llm import LLM

REPO = Path(__file__).resolve().parents[1]
# The JAX harness's page size; the card runs 32.
BLOCK = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_tiny_markov")
    _, heldout = train_tiny_checkpoint(d, steps=300, device="cpu")
    return str(d), heldout


def _port_llm(d, quant=None, kv="auto", dtype="bfloat16"):
    return LLM(qg.engine_config(d, quant, kv, dtype, block_size=BLOCK),
               device="cpu")


def _jax_llm(d, quant=None, kv="auto", dtype="bfloat16"):
    return JaxLLM(jcfg.EngineConfig.from_dict(dict(
        model=dict(model=d, quantization=quant, max_model_len=2048,
                   dtype=dtype),
        cache=dict(block_size=BLOCK, num_blocks=256, kv_cache_dtype=kv),
        scheduler=dict(max_num_seqs=8, max_num_batched_tokens=512))))


@pytest.fixture(scope="module")
def ppls(ckpt):
    d, heldout = ckpt
    seqs = qg.heldout_sequences(heldout)
    out = {}
    for name, quant, kv in qg.PRECISIONS:
        with _port_llm(d, quant, kv) as llm:
            out[name] = qg.perplexity(llm, seqs)
    return out


def test_model_learned(ppls):
    # Uniform over the 256-byte vocab is 256; a broken load or score path
    # scores far above the bound.
    assert ppls["bf16"] < qg.PPL_BOUND, ppls


@pytest.mark.parametrize("name", sorted(qg.RATIO_BOUNDS))
def test_perplexity_ratio_bound(ppls, name):
    assert ppls[name] / ppls["bf16"] < qg.RATIO_BOUNDS[name], ppls


@pytest.mark.parametrize("precision", qg.PRECISIONS,
                         ids=[p[0] for p in qg.PRECISIONS])
def test_perplexity_matches_jax_in_float32(ckpt, precision):
    d, heldout = ckpt
    _, quant, kv = precision
    seqs = qg.heldout_sequences(heldout)
    with _port_llm(d, quant, kv, "float32") as llm:
        port = qg.perplexity(llm, seqs)
    jax_llm = _jax_llm(d, quant, kv, "float32")
    ref = float(np.exp(-np.concatenate(jax_llm.score(seqs)).mean()))
    jax_llm.close()
    assert abs(port / ref - 1) < 1e-4, (port, ref)


def _jax_logits(d, ids, quant, dtype):
    """The JAX gate's module-level forward (``TestLogitKL``)."""
    from arcticinference_tpu.models.loader import load_model
    from arcticinference_tpu.ops.kv_cache import (KVCacheSpec,
                                                  allocate_kv_cache)

    module, arch, params = load_model(jcfg.ModelConfig(
        model=d, quantization=quant, max_model_len=2048, dtype=dtype))
    spec = KVCacheSpec(num_layers=arch.num_layers, num_blocks=32,
                       num_kv_heads=arch.num_kv_heads, block_size=BLOCK,
                       head_dim=arch.head_dim, dtype=jnp.bfloat16)
    inputs = dict(
        input_ids=jnp.asarray(ids),
        positions=jnp.arange(len(ids), dtype=jnp.int32),
        req_idx=jnp.zeros(len(ids), jnp.int32),
        slot_mapping=jnp.arange(len(ids), dtype=jnp.int32),
        block_tables=jnp.arange(-(-len(ids) // BLOCK),
                                dtype=jnp.int32)[None],
        seq_lens=jnp.asarray([len(ids)], jnp.int32))
    _, h = module.forward(params, arch, allocate_kv_cache(spec), inputs)
    return np.asarray(module.compute_logits(params, h), np.float64)


QUANTS = (None, "fp8", "int8", "int4")


def _port_kls(d, ids, dtype):
    logits = {}
    for quant in QUANTS:
        with _port_llm(d, quant, dtype=dtype) as llm:
            logits[quant] = llm.engine.prompt_logits(ids)
    return {q: qg.kl(logits[None], logits[q]) for q in QUANTS[1:]}


def test_logit_kl(ckpt):
    d, heldout = ckpt
    ids = np.asarray(heldout[:qg.KL_TOKENS], np.int32)
    kl = _port_kls(d, ids, "bfloat16")
    ppl_ok = {"bf16": 1.0, **{k: 1.0 for k in qg.RATIO_BOUNDS}}
    assert qg.failures(ppl_ok, kl) == [], kl


def test_logit_kl_matches_jax_in_float32(ckpt):
    # Each KL equals the JAX module's to 5e-6 absolute.  The readings
    # (CPU, float32, both packages' K/V pages in bf16): KLs fp8 2.02e-3,
    # int8 8.96e-4, int4 3.60e-3; port against JAX within 5.2e-7.  A
    # quantizer that did nothing (KL 0) or doubled the error misses by
    # more than 100x the bound.
    d, heldout = ckpt
    ids = np.asarray(heldout[:qg.KL_TOKENS], np.int32)
    kl = _port_kls(d, ids, "float32")
    ref = {q: _jax_logits(d, ids, q, "float32") for q in QUANTS}
    jkl = {q: qg.kl(ref[None], ref[q]) for q in QUANTS[1:]}
    for q in kl:
        assert abs(kl[q] - jkl[q]) < 5e-6, (kl, jkl)


@pytest.fixture(scope="module")
def tasks(ckpt):
    _, heldout = ckpt
    return ah.markov_tasks(heldout, np.random.default_rng(5))


@pytest.fixture(scope="module")
def summary(ckpt, tasks):
    d, _ = ckpt
    clients = {q or "bf16": ah.LocalClient(_port_llm(d, q))
               for q in (None, "fp8", "int8")}
    return ah.run_suite(clients, tasks)


def test_run_suite_rows(summary):
    assert [(r["config"], r["task"]) for r in summary] == [
        (c, t) for c in ("bf16", "fp8", "int8")
        for t in ("json_mode", "markov_gen", "markov_mc")]
    assert {r["metric"] for r in summary if r["task"] == "markov_mc"} == \
        {"accuracy"}
    assert all(r["n"] == (5 if r["task"] == "json_mode" else 20)
               for r in summary)


def test_accuracy_matrix_bars(summary):
    assert ah.matrix_failures(summary) == [], summary


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_harness", REPO / "benchmarks" / "accuracy_harness.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_accuracy_harness"] = mod   # dataclasses reads it
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quant", [None, "fp8", "int8"],
                         ids=["bf16", "fp8", "int8"])
def test_local_client_matches_jax_harness_in_float32(ckpt, tasks, quant):
    pytest.importorskip("pandas")
    d, _ = ckpt
    jah = _jax_harness()
    name = quant or "bf16"
    frame = jah.run_suite(
        {name: jah.LocalClient(_jax_llm(d, quant, dtype="float32"))},
        [jah.Task(t.name, t.type, t.items) for t in tasks])
    ref = {t: frame.loc[(name, t), "value"] for t in
           ("json_mode", "markov_gen", "markov_mc")}
    with _port_llm(d, quant, dtype="float32") as llm:
        rows = ah.run_suite({name: ah.LocalClient(llm)}, tasks)
    assert {r["task"]: r["value"] for r in rows} == ref


def test_task_file_roundtrip(tmp_path, ckpt):
    _, heldout = ckpt
    task = ah.markov_tasks(heldout, np.random.default_rng(0))[0]
    p = tmp_path / "task.json"
    p.write_text(json.dumps(dict(name=task.name, type=task.type,
                                 items=task.items)))
    loaded = ah.load_task(p)
    assert (loaded.name, loaded.type, loaded.items) == \
        (task.name, task.type, task.items)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(url, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server exited: {proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.3)
    raise TimeoutError(url)


def test_http_echo_scoring_matches_local(ckpt, tmp_path):
    d, heldout = ckpt
    port = _free_port()
    cfg = {"model": {"model": d, "max_model_len": 2048},
           "cache": {"block_size": BLOCK, "num_blocks": 256},
           "scheduler": {"max_num_seqs": 8, "max_num_batched_tokens": 512}}
    cfg_file = tmp_path / "engine_cfg.json"
    cfg_file.write_text(json.dumps(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "arcticinference_tpu_torch", "serve",
         "--device", "cpu", "--config", str(cfg_file), "--port", str(port),
         "--host", "127.0.0.1"],
        env=env, cwd=str(REPO), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        _wait_http(f"http://127.0.0.1:{port}/health", proc)
        http = ah.HTTPClient(f"http://127.0.0.1:{port}")
        prompt = [int(t) for t in heldout[:12]]
        cont = [int(t) for t in heldout[12:16]]
        with _port_llm(d) as llm:
            local = ah.LocalClient(llm)
            b = local.continuation_logprob(prompt, cont)
            want, want_text = local.generate(prompt, 4)
        a = http.continuation_logprob(prompt, cont)
        assert abs(a - b) < 5e-2, (a, b)
        toks, text = http.generate(prompt, 4)
        assert len(toks) == 4 and toks == want
        assert text == want_text
    finally:
        proc.terminate()
        proc.wait(timeout=30)
