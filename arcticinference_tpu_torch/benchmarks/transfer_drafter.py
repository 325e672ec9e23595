"""Drafter transfer: a drafter distilled on a trained target, held out on
prompts it never saw.

Counterpart of the JAX package's ``benchmarks/transfer_drafter.py``.  The
bench's 8B target has random weights, so its drafter can only replay the
trajectories it was captured on.  Here the target is the tiny trained
checkpoint (``benchmarks/tiny_markov.py``), whose greedy continuations
follow the corpus language's structure:

1. train the checkpoint (unless ``ckpt`` already holds one);
2. capture (hidden, next-K) pairs from the engine on prompts drawn from
   the first 40% of a 16000-word stream of the same language
   (spec-shaped capture under a seed drafter, ``spec/distill.py``);
3. distill the tied-table MLP drafter and the ``sum_lstm`` drafter on
   those pairs;
4. measure acceptance, tokens per step and decode tok/s on prompts from
   the last 40% of the stream against a greedy comparator at the same
   batch (``bench.decode_tokens_per_s``), and whether the speculative
   run's held-out tokens equal the comparator's.

    python -m arcticinference_tpu_torch.benchmarks.transfer_drafter \\
        [--ckpt DIR] [--drafter-out DIR] [--device cpu]

prints one JSON line with the JAX script's keys (the MLP's numbers at the
top level, the LSTM's under ``lstm``) and ``tokens_match_greedy``.  The
port's bench embeds it as ``spec_transfer``.  Without ``--ckpt`` the
checkpoint and the drafters are cached under the repository's
git-ignored ``checkpoints/``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
PROTOCOL = ("distilled on corpus[0:40%], evaluated on corpus[60:100%] "
            "(disjoint prompts, trained teacher)")
#: Training steps of a checkpoint trained here (the JAX script's).
TRAIN_STEPS = 500


def log(msg: str) -> None:
    print(f"[transfer] {msg}", file=sys.stderr, flush=True)


def corpus_prompts(ids: np.ndarray, n: int, plen: int, seed: int,
                   lo: float, hi: float) -> list[list[int]]:
    """``n`` prompts of length ``plen`` drawn from the [lo, hi) fraction
    of a token stream (disjoint fractions give disjoint prompt sets)."""
    rng = np.random.default_rng(seed)
    a = int(len(ids) * lo)
    b = int(len(ids) * hi) - plen - 1
    starts = rng.integers(a, b, n)
    return [[int(x) for x in ids[s:s + plen]] for s in starts]


def engine_config(ckpt, batch: int, speculative=None):
    """The JAX script's engine (1024-token contexts, 256 blocks, prefix
    caching off, the synchronous step), at the card's 32-token pages (the
    JAX script's are 16)."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)

    return EngineConfig(
        model=ModelConfig(model=str(ckpt), max_model_len=1024),
        cache=CacheConfig(block_size=32, num_blocks=256,
                          enable_prefix_caching=False),
        scheduler=SchedulerConfig(max_num_seqs=batch,
                                  max_num_batched_tokens=1024,
                                  async_scheduling=False),
        speculative=speculative)


def run_transfer(ckpt, drafter_out=None, device=None, batch: int = 16,
                 prompt_len: int = 64, gen: int = 48, capture_gen: int = 64,
                 n_predict: int = 3, steps: int = 800, lr: float = 2e-3,
                 kinds=("mlp", "lstm")) -> dict:
    """Steps 1-4 above on ``device`` (``cuda:0`` unless the caller names
    another); returns the JSON object.  A checkpoint or drafter that
    already exists (its ``config.json``) is reused."""
    from arcticinference_tpu_torch.bench import decode_tokens_per_s
    from arcticinference_tpu_torch.benchmarks.distill_drafter import (
        free_llm)
    from arcticinference_tpu_torch.benchmarks.tiny_markov import (
        corpus_ids, train_tiny_checkpoint)
    from arcticinference_tpu_torch.config import SpeculativeConfig
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.spec.distill import (
        capture_pairs, distill_lstm, distill_mlp, init_tied_drafter,
        save_distilled, save_lstm)
    from arcticinference_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    ckpt = Path(ckpt)
    if not (ckpt / "config.json").exists():
        log(f"training tiny checkpoint -> {ckpt}")
        t0 = time.perf_counter()
        train_tiny_checkpoint(ckpt, steps=TRAIN_STEPS, device=device)
        log(f"trained in {time.perf_counter() - t0:.1f} s")

    # One long stream of the same Markov language (the transition matrix
    # depends only on the seed): the target saw words [0, 4000); the
    # drafter trains on prompts from the first 40% of a 16000-word stream
    # and is evaluated on prompts from the last 40%.
    stream = corpus_ids(n_words=16000, seed=0)
    train_prompts = corpus_prompts(stream, batch, prompt_len, seed=11,
                                   lo=0.0, hi=0.4)
    held_prompts = corpus_prompts(stream, batch, prompt_len, seed=13,
                                  lo=0.6, hi=1.0)

    def spec(model_dir):
        return SpeculativeConfig(method="arctic", model=str(model_dir),
                                 num_speculative_tokens=n_predict)

    drafter_dir = Path(drafter_out or ckpt.parent /
                       f"{ckpt.name}-drafter-k{n_predict}")
    dirs = {"mlp": drafter_dir, "lstm": Path(f"{drafter_dir}-lstm")}
    missing = [k for k in kinds if not (dirs[k] / "config.json").exists()]
    if missing:
        # Capture once on the train prompts, spec-shaped (the programs
        # the evaluation runs); both kinds train on the same pairs.
        seed_dir = Path(f"{drafter_dir}-seed")
        if not (seed_dir / "config.json").exists():
            hidden_size = json.loads(
                (ckpt / "config.json").read_text())["hidden_size"]
            sp, sa = init_tied_drafter((hidden_size, 256),
                                       n_predict=n_predict)
            save_distilled(seed_dir, sp, sa, metrics={"seed_drafter": True})
        llm = LLM(engine_config(ckpt, batch, spec(seed_dir)),
                  device=device)
        t0 = time.perf_counter()
        hidden, tok0, targets, mask = capture_pairs(
            llm, train_prompts, gen_len=capture_gen, n_predict=n_predict)
        log(f"captured {hidden.shape[0]} pairs in "
            f"{time.perf_counter() - t0:.1f} s")
        target_params = llm.engine.runner.params
        arch = llm.engine.runner.arch
        metrics = {"pairs": int(hidden.shape[0]),
                   "transfer_protocol": "train lo=0.0-0.4, eval lo=0.6-1.0"}
        for kind in missing:
            t0 = time.perf_counter()
            train_batch = min(1024, hidden.shape[0])
            if kind == "mlp":
                params, darch, acc = distill_mlp(
                    target_params, hidden, tok0, targets, mask,
                    n_predict=n_predict, steps=steps,
                    batch_size=train_batch, lr=lr, log_every=200)
                save_distilled(dirs[kind], params, darch, metrics=dict(
                    metrics, train_acc=[float(a) for a in acc]))
            else:
                params, darch, acc = distill_lstm(
                    arch.hidden_size, arch.vocab_size, hidden, tok0,
                    targets, mask, n_predict=n_predict, steps=steps,
                    batch_size=train_batch, lr=lr, log_every=200,
                    device=device)
                save_lstm(dirs[kind], params, darch, metrics=dict(
                    metrics, train_acc=[float(a) for a in acc]))
            log(f"{kind} distilled in {time.perf_counter() - t0:.1f} s; "
                f"train acc {np.round(acc, 3).tolist()}")
            del params
        del target_params
        free_llm(llm)

    warm = SamplingParams(max_tokens=8, ignore_eos=True)

    def measure(speculative):
        llm = LLM(engine_config(ckpt, batch, speculative),
                  device=device)
        llm.generate(prompt_token_ids=held_prompts, sampling_params=warm)
        toks_s, _, outs = decode_tokens_per_s(llm, held_prompts,
                                              held_prompts, held_prompts,
                                              gen)
        eng = llm.engine
        st = eng.spec_stats
        res = dict(
            toks_s=toks_s, tokens=[list(o.token_ids) for o in outs],
            acc=st.acceptance_rate if st.num_drafts else 0.0,
            tps=1 + st.mean_accepted_per_draft if st.num_drafts else 1.0,
            kind=eng._drafter.kind if eng._drafter is not None else None)
        free_llm(llm)
        return res

    results = {k: measure(spec(dirs[k])) for k in kinds}
    greedy = measure(None)

    def block(res):
        return {
            "transfer_acceptance": round(float(res["acc"]), 4),
            "transfer_tokens_per_step": round(float(res["tps"]), 3),
            "spec_tokens_per_s": round(res["toks_s"], 2),
            "greedy_tokens_per_s": round(greedy["toks_s"], 2),
            "speedup": round(res["toks_s"] / greedy["toks_s"], 3),
            "drafter_kind": res["kind"],
            "tokens_match_greedy": res["tokens"] == greedy["tokens"],
        }

    first = kinds[0]
    out = {**block(results[first]), "n_predict": n_predict,
           "batch": batch, "protocol": PROTOCOL}
    for k in kinds[1:]:
        out[k] = block(results[k])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=str(REPO / "checkpoints" /
                                          "torch-tiny-markov"))
    ap.add_argument("--drafter-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda:0 (default) or cpu")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--capture-gen", type=int, default=64)
    ap.add_argument("--n-predict", type=int, default=3)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--kind", default="both",
                    choices=["mlp", "lstm", "both"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    kinds = ("mlp", "lstm") if args.kind == "both" else (args.kind,)
    out = run_transfer(args.ckpt, args.drafter_out, args.device,
                       batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen, capture_gen=args.capture_gen,
                       n_predict=args.n_predict, steps=args.steps,
                       lr=args.lr, kinds=kinds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
