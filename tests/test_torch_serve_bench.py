"""The port's serving harness (``benchmarks/serve_bench.py``) on the CPU.

Each of the five configs (baseline, suffix, spec, swiftkv, all) runs at
the tiny CPU shapes with a few prompts: every prompt finishes with its
tokens, and the JSON object carries every key of the JAX harness's on
the same config kind (the fused loop's width counts with speculation).
The subprocess-per-config path runs once, on two configs.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from arcticinference_tpu_torch.benchmarks import serve_bench

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_prompts=3, input_len=16, output_len=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_keys():
    """The JAX harness's output keys, without and with the fused loop
    (its tiny CPU configs ``baseline`` and ``spec``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench", REPO / "benchmarks" / "serve_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: set(mod.run_one(name, 2, 8, 4, on_tpu=False))
            for name in ("baseline", "spec")}


@pytest.mark.parametrize("config", serve_bench.CONFIGS)
def test_config_runs_at_cpu_shapes(config, jax_keys):
    out = serve_bench.run_one(config, device="cpu", **SMALL)
    fused = config in ("suffix", "spec", "all")
    assert jax_keys["spec" if fused else "baseline"] <= set(out)
    assert out["config"] == config and out["device"] == "cpu"
    assert out["finished"] == SMALL["num_prompts"]
    assert out["model"] == ("llama_swiftkv" if config in ("swiftkv", "all")
                            else "llama")
    assert out["output_tokens_per_s"] > 0
    assert 0 < out["ttft_p50_ms"] <= out["ttft_p99_ms"]
    if config in ("spec", "all"):
        # A random drafter drafts on every wide fused step.
        assert out["spec"]["num_drafts"] > 0
        assert out["fused_width_steps_run"]["wide"] > 0


def test_config_matrix_runs_one_process_per_config():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m",
         "arcticinference_tpu_torch.benchmarks.serve_bench", "--device",
         "cpu", "--configs", "baseline", "all", "--num-prompts", "2",
         "--input-len", "12", "--output-len", "4"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    assert [r["config"] for r in lines] == ["baseline", "all"]
    assert all(r["finished"] == 2 for r in lines)


def test_build_config_at_card_shapes():
    """The card's shapes, without building an engine: Llama-3.1-8B in
    fp8, 4096-token contexts, 32-token blocks, 32 sequences, 2048
    batched tokens; SwiftKV keeps half the layers on the projection."""
    cfg = serve_bench.build_config("all", on_card=True)
    assert cfg.model.model == "llama_swiftkv"
    assert cfg.model.quantization == "fp8"
    assert cfg.model.hf_overrides["num_key_value_layers"] == 16
    assert cfg.model.hf_overrides["hidden_size"] == 4096
    assert (cfg.model.max_model_len, cfg.cache.block_size,
            cfg.cache.num_blocks) == (4096, 32, 650)
    assert (cfg.scheduler.max_num_seqs,
            cfg.scheduler.max_num_batched_tokens) == (32, 2048)
    assert cfg.speculative.enable_suffix_decoding
    assert serve_bench.build_config("baseline", True).cache.num_blocks == 800
    with pytest.raises(ValueError):
        serve_bench.build_config("nope", True)
