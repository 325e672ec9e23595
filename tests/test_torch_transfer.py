"""The port's drafter transfer (``benchmarks/transfer_drafter.py``)
against the JAX script's (``benchmarks/transfer_drafter.py``).

- ``corpus_prompts`` draws the JAX script's prompts, train and held-out
  sets alike, on the port's 16000-word stream;
- a small-budget transfer on the CPU (a 200-step checkpoint, 4 prompts
  of 32 tokens, 16 captured tokens, 100 distill steps) prints one JSON
  line with the JAX script's keys, and each drafter's speculative
  held-out tokens equal the greedy comparator's;
- the full transfer at the JAX script's defaults, with the bars of the
  JAX slow test (``tests/test_bench_smoke.py``), is slow.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.benchmarks import transfer_drafter as td
from arcticinference_tpu_torch.benchmarks.tiny_markov import (
    corpus_ids, train_tiny_checkpoint)

REPO = Path(__file__).resolve().parents[1]
KEYS = ("transfer_acceptance", "transfer_tokens_per_step",
        "spec_tokens_per_s", "greedy_tokens_per_s", "speedup",
        "drafter_kind", "tokens_match_greedy")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_transfer_drafter", REPO / "benchmarks" / "transfer_drafter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,lo,hi", [(11, 0.0, 0.4), (13, 0.6, 1.0)],
                         ids=["train", "heldout"])
def test_corpus_prompts_match_jax(seed, lo, hi):
    stream = corpus_ids(n_words=16000, seed=0)
    want = _jax_script().corpus_prompts(stream, 16, 64, seed=seed, lo=lo,
                                        hi=hi)
    got = td.corpus_prompts(stream, 16, 64, seed=seed, lo=lo, hi=hi)
    assert got == want
    assert [len(p) for p in got] == [64] * 16


def test_small_transfer_on_the_cpu(tmp_path, capsys):
    # The script reuses a checkpoint that exists.
    train_tiny_checkpoint(tmp_path / "ckpt", steps=200, device="cpu")
    assert td.main([
        "--ckpt", str(tmp_path / "ckpt"), "--drafter-out",
        str(tmp_path / "drafter"), "--device", "cpu", "--batch", "4",
        "--prompt-len", "32", "--gen", "8", "--capture-gen", "16",
        "--steps", "100"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    for block, kind in ((out, "mlp"), (out["lstm"], "lstm")):
        assert set(KEYS) <= set(block)
        assert block["drafter_kind"] == kind
        assert block["tokens_match_greedy"] is True
        assert 0.0 <= block["transfer_acceptance"] <= 1.0
        assert 1.0 <= block["transfer_tokens_per_step"] <= 4.0
        assert block["spec_tokens_per_s"] > 0
    assert (out["n_predict"], out["batch"]) == (3, 4)
    assert out["protocol"] == td.PROTOCOL
    assert (tmp_path / "ckpt" / "tokenizer.json").exists()
    assert json.loads((tmp_path / "drafter" / "config.json").read_text())[
        "distill_metrics"]["pairs"] > 0


@pytest.mark.slow
def test_full_transfer_meets_the_jax_bars(tmp_path):
    """The JAX script's defaults (batch 16, 64-token prompts, 48 generated,
    64 captured, 3 heads, 800 distill steps, a 500-step checkpoint) and
    the JAX slow test's bars."""
    out = td.run_transfer(tmp_path / "ckpt", tmp_path / "drafter",
                          device="cpu")
    assert out["transfer_acceptance"] > 0.3, out
    assert out["transfer_tokens_per_step"] > 1.5, out
    assert out["lstm"]["transfer_acceptance"] > 0.3, out
    assert out["tokens_match_greedy"] and \
        out["lstm"]["tokens_match_greedy"], out
    assert np.isfinite(out["speedup"])
