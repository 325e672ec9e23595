"""Serving benchmark harness of the port: a matrix of engine configs.

Counterpart of the JAX package's ``benchmarks/serve_bench.py`` (itself
the reference's pytest harness, ``benchmark_utils.py:17-97``).  Each
config runs in a subprocess of its own (a process's device memory is
only reliably returned when it exits), replays a synthetic workload and
prints one JSON line: throughput, TTFT p50 / p99 and mean TPOT.

Configs (:func:`build_config`):

- ``baseline``: Llama, no speculation;
- ``suffix``:   suffix decoding on the fused decode loop;
- ``spec``:     the Arctic MLP drafter (3 tokens) on the fused loop;
- ``swiftkv``:  Llama-SwiftKV, the later half of the layers on the
                projected KV;
- ``all``:      the reference's "all-combined" config: SwiftKV with the
                MLP drafter and suffix decoding, on the fused loop.

On the card (the default) the model is Llama-3.1-8B's shape with fp8
weights at ``max_model_len`` 4096, 32-token blocks (800 of them, 650
with speculation), 32 sequences and 2048 batched tokens: the JAX
harness's on-chip shapes.  ``--device cpu`` runs its tiny CPU shapes with
the kernels' plain versions.  The weights are random, drawn from the
config's seed, and so are the drafters' (no checkpoint is loaded): a
random drafter is almost never accepted, so ``spec`` and ``all`` show the
machinery running, not a speed-up, and SwiftKV's outputs are not a
trained model's.

Workloads: ``random`` (fresh prompts after a warm pass), ``repeat`` (the
warm pass's prompts again: the agentic re-query pattern suffix decoding
serves) and ``mixed`` (half of each in one batch).

    python -m arcticinference_tpu_torch.benchmarks.serve_bench \\
        --configs baseline suffix spec swiftkv all [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

CONFIGS = ("baseline", "suffix", "spec", "swiftkv", "all")

# meta-llama/Llama-3.1-8B's shape (config.json).
LLAMA_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500000.0)

# The JAX harness's CPU shapes.
TINY = dict(
    vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
    head_dim=32)


def build_config(name: str, on_card: bool):
    """The engine config of one matrix entry (the JAX harness's)."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig,
                                                  SpeculativeConfig)

    overrides = dict(LLAMA_8B if on_card else TINY)
    model = "llama"
    spec = None
    # Speculative configs keep fewer cache blocks: their verify rows and
    # drafter need activation room.
    spec_blocks = False
    if name in ("swiftkv", "all"):
        model = "llama_swiftkv"
        overrides["num_key_value_layers"] = \
            overrides["num_hidden_layers"] // 2
    if name == "suffix":
        spec = SpeculativeConfig(method="suffix", suffix_cache_max_depth=64)
        spec_blocks = True
    elif name == "spec":
        spec = SpeculativeConfig(method="arctic", num_speculative_tokens=3)
        spec_blocks = True
    elif name == "all":
        spec = SpeculativeConfig(method="arctic", num_speculative_tokens=3,
                                 enable_suffix_decoding=True)
        spec_blocks = True
    elif name not in ("baseline", "swiftkv"):
        raise ValueError(f"unknown config {name}")
    return EngineConfig(
        model=ModelConfig(model=model, hf_overrides=overrides,
                          quantization="fp8" if on_card else None,
                          max_model_len=4096 if on_card else 512),
        cache=CacheConfig(block_size=32,
                          num_blocks=(650 if spec_blocks else 800)
                          if on_card else 128),
        scheduler=SchedulerConfig(
            max_num_seqs=32 if on_card else 8,
            max_num_batched_tokens=2048 if on_card else 256),
        speculative=spec,
    )


def run_one(name: str, num_prompts: int, input_len: int, output_len: int,
            device: str = "cuda:0", workload: str = "random") -> dict:
    """One config on a new engine: a warm pass, then the measured pass;
    returns the JSON object of the measured pass."""
    import torch

    from arcticinference_tpu_torch.bench import smi
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    cfg = build_config(name, dev.type == "cuda")
    llm = LLM(cfg, device=dev)
    vocab = cfg.model.hf_overrides["vocab_size"]

    def make_prompts(seed):
        r = np.random.default_rng(seed)
        return [[int(x) for x in r.integers(1, vocab - 1, input_len)]
                for _ in range(num_prompts)]

    sp = SamplingParams(max_tokens=output_len, ignore_eos=True)
    eng = llm.engine

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_pass(tag, prompts):
        for i, p in enumerate(prompts):
            eng.add_request(f"bench-{name}-{tag}-{i}", p, sp)
        sync()
        t0 = time.perf_counter()
        first_token_t: dict[str, float] = {}
        finished = []
        while eng.has_unfinished:
            done = eng.step()
            now = time.perf_counter()
            for r in eng.scheduler.running:
                if r.req_id not in first_token_t and any(
                        t >= 0 for t in r.output_token_ids[:1]):
                    first_token_t[r.req_id] = now
            for r in done:
                first_token_t.setdefault(r.req_id, now)
                finished.append(r)
        sync()
        dt = time.perf_counter() - t0
        return dt, [first_token_t[r.req_id] - t0 for r in finished], finished

    # The warm pass fills the allocator's pools and builds the kernels;
    # ``random`` measures fresh prompts, ``repeat`` re-sends the warm
    # pass's (the suffix cache has seen their outputs), ``mixed`` does
    # both in one batch (even slots repeat, odd slots fresh), after a
    # mixed warm pass of its own.
    one_pass("warm", make_prompts(0))
    if workload in ("repeat", "mixed"):
        one_pass("warm2", make_prompts(0))
    if workload == "mixed":
        warm, fresh_w = make_prompts(0), make_prompts(2)
        one_pass("warm3", [warm[i] if i % 2 == 0 else fresh_w[i]
                           for i in range(num_prompts)])
        fresh = make_prompts(1)
        run_prompts = [warm[i] if i % 2 == 0 else fresh[i]
                       for i in range(num_prompts)]
    else:
        run_prompts = make_prompts(0 if workload == "repeat" else 1)
    width_before = (dict(eng._fused.width_stats)
                    if eng._fused is not None else None)
    dt, ttfts, finished = one_pass("run", run_prompts)

    gen_tokens = sum(len(r.output_token_ids) for r in finished)
    tpots = [(dt - ttft) / max(len(r.output_token_ids) - 1, 1)
             for r, ttft in zip(finished, ttfts)]
    out = {
        "config": name,
        "workload": workload,
        "num_prompts": num_prompts,
        "input_len": input_len,
        "output_len": output_len,
        "total_time_s": round(dt, 3),
        "output_tokens_per_s": round(gen_tokens / dt, 2),
        "total_tokens_per_s": round(
            (gen_tokens + num_prompts * input_len) / dt, 2),
        "ttft_p50_ms": round(float(np.percentile(ttfts, 50)) * 1e3, 1),
        "ttft_p99_ms": round(float(np.percentile(ttfts, 99)) * 1e3, 1),
        "tpot_mean_ms": round(float(np.mean(tpots)) * 1e3, 2),
        "spec": eng.spec_stats.summary(),
        "engine_steps": eng.engine_stats.num_steps,
        "finished": len(finished),
        "model": cfg.model.model,
        # The card's name and power limit, beside every number.
        "device": smi() if dev.type == "cuda" else "cpu",
    }
    if eng._fused is not None:
        out["fused_width_steps"] = dict(eng._fused.width_stats)
        out["fused_width_steps_run"] = {
            k: eng._fused.width_stats[k] - width_before[k]
            for k in eng._fused.width_stats}
    if workload == "mixed":
        # Per-class TPOT: even run slots are repeat-hot, odd are fresh.
        def cls_tpot(parity):
            vals = [t for r, t in zip(finished, tpots)
                    if int(r.req_id.rsplit("-", 1)[1]) % 2 == parity]
            return round(float(np.mean(vals)) * 1e3, 2) if vals else None
        out["tpot_hot_ms"] = cls_tpot(0)
        out["tpot_fresh_ms"] = cls_tpot(1)
    llm.close()
    return out


def run_matrix(configs, argv_tail: list[str]) -> list[dict]:
    """Each of ``configs`` in a subprocess of its own (``argv_tail``: the
    options they share); returns their JSON objects, printed as they
    come.  A config whose process fails or prints no JSON line raises,
    after the others ran."""
    results, failed = [], []
    for name in configs:
        print(f"== running {name} ==", file=sys.stderr, flush=True)
        cmd = [sys.executable, "-m",
               "arcticinference_tpu_torch.benchmarks.serve_bench",
               "--configs", name] + argv_tail
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-2000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            failed.append(name)
            continue
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    print("=== summary ===", file=sys.stderr)
    for r in results:
        print(f"{r['config']:10s} {r['output_tokens_per_s']:10.1f} tok/s  "
              f"ttft p50 {r['ttft_p50_ms']:8.1f} ms  "
              f"tpot {r['tpot_mean_ms']:6.2f} ms", file=sys.stderr)
    if failed:
        raise RuntimeError(f"configs failed: {failed}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", nargs="+", default=["baseline", "suffix"],
                    choices=CONFIGS)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu (the tiny CPU shapes)")
    ap.add_argument("--num-prompts", type=int, default=32)
    ap.add_argument("--input-len", type=int, default=128)
    ap.add_argument("--output-len", type=int, default=64)
    ap.add_argument("--workload", default="random",
                    choices=["random", "repeat", "mixed"])
    args = ap.parse_args(argv)
    if len(args.configs) > 1:
        run_matrix(args.configs, [
            "--device", args.device, "--num-prompts", str(args.num_prompts),
            "--input-len", str(args.input_len),
            "--output-len", str(args.output_len),
            "--workload", args.workload])
        return 0
    r = run_one(args.configs[0], args.num_prompts, args.input_len,
                args.output_len, args.device, args.workload)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
