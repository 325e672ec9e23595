"""Distill an Arctic MLP drafter against the bench's target model.

Counterpart of ``benchmarks/distill_drafter.py``: capture (hidden,
next-K token) pairs from the running engine on the bench's fixed prompt
set, train the tied-table MLP speculator (``spec/distill.py``) and save
a ``distilled_tied`` checkpoint that the bench's spec phase loads.

Capture is spec-shaped: the engine runs the configuration the spec bench
measures (:func:`engine_config`: verify-shaped fused-loop steps, prefix
caching off, the same cache geometry), seeded with a random drafter of
the distilled architecture.  On a random-weight target greedy argmax
flips under any change of program, so only a capture of the same
program transfers to bench-time acceptance.  With random weights the
map hidden -> next tokens has no structure to generalise from: the
drafter's acceptance means something on the capture prompts, which the
bench replays.

    python -m arcticinference_tpu_torch.benchmarks.distill_drafter \\
        --out checkpoints/drafter [--device cpu]

On the card the target is Llama-3.1-8B with fp8 weights and random
weights from seed 0; ``--device cpu`` takes the tiny configuration of
the JAX bench's CPU smoke.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Llama-3.1-8B (bench.py:33-37).
LLAMA_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500000.0, max_position_embeddings=131072,
)
# The JAX bench's CPU smoke configuration (bench.py:254-258).
TINY = dict(
    vocab_size=1024, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
    head_dim=32)


# Drafter heads, and the training run (benchmarks/distill_drafter.py's
# defaults: 600 Adam steps at batch 512, lr 1e-3).
N_PREDICT = 3
STEPS = 600
TRAIN_BATCH = 512
LR = 1e-3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_prompts(seed: int, batch: int, prompt_len: int, vocab: int):
    """The bench's prompt sets: ``batch`` prompts of ``prompt_len``
    tokens drawn from ``numpy.random.default_rng(seed)``."""
    r = np.random.default_rng(seed)
    return [[int(x) for x in r.integers(1, vocab - 1, prompt_len)]
            for _ in range(batch)]


def engine_config(overrides: dict, full: bool, max_seqs: int,
                  speculative=None, blocks=None, prefix_caching=True,
                  quantization=None):
    """The bench's engine: Llama with ``overrides`` and fp8 weights on the
    card (``full``), the tiny float configuration elsewhere; the spec
    phase and its capture pass ``blocks=512`` (64 on the CPU) and
    ``prefix_caching=False``."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)

    if quantization is None and full:
        quantization = "fp8"
    return EngineConfig(
        model=ModelConfig(model="llama", hf_overrides=dict(overrides),
                          quantization=quantization,
                          max_model_len=4096 if full else 256),
        cache=CacheConfig(block_size=32,
                          num_blocks=blocks or (900 if full else 64),
                          enable_prefix_caching=prefix_caching),
        scheduler=SchedulerConfig(max_num_seqs=max_seqs,
                                  max_num_batched_tokens=2048 if full
                                  else 64,
                                  async_scheduling=False),
        speculative=speculative,
    )


def spec_engine_config(overrides: dict, full: bool, batch: int,
                       drafter_dir):
    """The spec phase's engine (and its capture's): the arctic drafter in
    ``drafter_dir`` drafting ``N_PREDICT`` tokens, 512 blocks (64 on the
    CPU), prefix caching off."""
    from arcticinference_tpu_torch.config import SpeculativeConfig

    spec = SpeculativeConfig(method="arctic", model=str(drafter_dir),
                             num_speculative_tokens=N_PREDICT)
    return engine_config(overrides, full, batch, speculative=spec,
                         blocks=512 if full else 64, prefix_caching=False)


def free_llm(llm) -> None:
    """Release an engine's device memory now (its object graph holds
    back-references, so a plain ``del`` waits for a collection)."""
    eng = llm.engine
    if eng is not None:
        eng.close()
        eng.runner.kv = None
        eng.runner.params = None
        eng._drafter = None
        eng._fused = None
    llm.engine = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def distill_drafter(out, device, batch: int = 32, prompt_len: int = 128,
                    gen: int = 64, seed: int = 2) -> dict:
    """Capture ``batch`` x ``gen`` tokens on the prompt set of ``seed``,
    train ``STEPS`` Adam steps at batch ``TRAIN_BATCH``, and save the
    drafter to ``out``; returns its metrics (per-head training accuracy,
    pairs, seconds)."""
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.spec.distill import (capture_pairs,
                                                        distill_mlp,
                                                        init_tied_drafter,
                                                        save_distilled)

    device = torch.device(device)
    full = device.type == "cuda"
    overrides = dict(LLAMA_8B if full else TINY)
    seed_dir = Path(str(out) + "-seed")
    if not (seed_dir / "config.json").exists():
        sp, sa = init_tied_drafter(
            (overrides["hidden_size"], overrides["vocab_size"]),
            n_predict=N_PREDICT)
        save_distilled(seed_dir, sp, sa, metrics={"seed_drafter": True})

    t0 = time.perf_counter()
    llm = LLM(spec_engine_config(overrides, full, batch, seed_dir),
              device=device)
    prompts = make_prompts(seed, batch, prompt_len,
                           overrides["vocab_size"])
    log(f"[distill] engine up in {time.perf_counter() - t0:.1f}s; "
        f"capturing {batch}x{gen} spec-shaped greedy pairs")
    t0 = time.perf_counter()
    hidden, tok0, targets, mask = capture_pairs(
        llm, prompts, gen_len=gen, n_predict=N_PREDICT)
    t_capture = time.perf_counter() - t0
    log(f"[distill] captured {hidden.shape[0]} pairs in {t_capture:.1f}s")

    # Keep the target's tables (tied into the drafter); free the rest.
    params = llm.engine.runner.params
    target_params = {k: params[k] for k in ("embed", "lm_head")
                     if k in params}
    del params
    free_llm(llm)
    t0 = time.perf_counter()
    params, arch, acc = distill_mlp(
        target_params, hidden, tok0, targets, mask, n_predict=N_PREDICT,
        steps=STEPS, batch_size=TRAIN_BATCH, lr=LR, log_every=100)
    if full:
        torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    log(f"[distill] trained in {t_train:.1f}s; per-head accuracy "
        f"{np.round(acc, 4).tolist()}")
    metrics = {
        "train_acc": [float(a) for a in acc],
        "pairs": int(hidden.shape[0]),
        "steps": STEPS,
        "prompt_seed": seed,
        "batch": batch,
        "prompt_len": prompt_len,
        "gen": gen,
        "capture_s": t_capture,
        "train_s": t_train,
    }
    save_distilled(out, params, arch, metrics=metrics)
    del target_params, params
    gc.collect()
    if full:
        torch.cuda.empty_cache()
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="checkpoints/drafter-llama8b-fp8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--seed", type=int, default=2,
                    help="prompt-set seed (the bench's spec phase uses 2)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from arcticinference_tpu_torch.utils import resolve_device

    metrics = distill_drafter(
        args.out, resolve_device(args.device), batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed)
    print(json.dumps({"drafter": str(args.out),
                      "train_acc": [round(a, 4)
                                    for a in metrics["train_acc"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
