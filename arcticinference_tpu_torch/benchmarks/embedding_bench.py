"""Embedding throughput benchmark of the port.

Counterpart of ``benchmarks/embedding_bench.py``: sweeps batch size x
concurrency x prompt-length distribution (``fixed:N``,
``uniform:LO,HI``, ``normal:MU,SD``) against the embedding service (a
manager or a replica, ``--target``), an in-process ``LLM.encode``
(``--local``) or an OpenAI server's ``/v1/embeddings`` (``--http``), and
prints one JSON line per batch size: Ktok/s and latency percentiles.
Prompts are drawn from seed 0; remote token ids from [1, 30000), inside
BERT's vocabulary.

  # in-process (one engine, no server; --device cpu on the CPU):
  python -m arcticinference_tpu_torch.benchmarks.embedding_bench --local \\
      --batch-sizes 16 64 --len-dist fixed:128

  # against a running manager or replica:
  python -m arcticinference_tpu_torch.benchmarks.embedding_bench \\
      --target localhost:50050 --batch-sizes 64 --concurrency 8

``--local`` runs the JAX bench's model (Llama-3.1-8B's widths in fp8 on
the card, a 2-layer 256-wide Llama on the CPU) unless ``--config`` names
an ``EngineConfig`` JSON file (a BERT one runs the encoder).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np


def gen_lengths(dist: str, n: int, rng) -> list[int]:
    kind, _, arg = dist.partition(":")
    if kind == "fixed":
        return [int(arg)] * n
    if kind == "uniform":
        lo, hi = (int(x) for x in arg.split(","))
        return [int(x) for x in rng.integers(lo, hi + 1, n)]
    if kind == "normal":
        mu, sd = (float(x) for x in arg.split(","))
        return [max(1, int(x)) for x in rng.normal(mu, sd, n)]
    raise ValueError(f"unknown length distribution {dist}")


def _summary(mode: str, batch: int, args, tokens: int, seconds: float,
             latencies: list[float], **extra) -> dict:
    return {"mode": mode, "batch": batch, **extra,
            "len_dist": args.len_dist, "requests": len(latencies),
            "tokens": tokens, "seconds": seconds,
            "ktok_per_s": tokens / seconds / 1e3,
            "latency_p50_ms": float(np.percentile(latencies, 50)) * 1e3,
            "latency_p99_ms": float(np.percentile(latencies, 99)) * 1e3}


def local_config(args):
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)

    if args.config:
        return EngineConfig.from_dict(json.loads(Path(args.config)
                                                 .read_text()))
    on_card = args.device != "cpu"
    overrides = (dict(vocab_size=128256, hidden_size=4096,
                      intermediate_size=14336, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8,
                      head_dim=128) if on_card else
                 dict(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=8,
                      head_dim=32))
    return EngineConfig(
        model=ModelConfig(model="llama", hf_overrides=overrides,
                          quantization="fp8" if on_card else None,
                          dtype="bfloat16" if on_card else "float32",
                          max_model_len=2048),
        cache=CacheConfig(block_size=32,
                          num_blocks=512 if on_card else 64),
        scheduler=SchedulerConfig(max_num_seqs=args.max_batch,
                                  max_num_batched_tokens=8192
                                  if on_card else 512))


def run_local(args) -> list[dict]:
    from arcticinference_tpu_torch.engine.llm import LLM

    cfg = local_config(args)
    llm = LLM(cfg, device=args.device)
    vocab = (llm.encoder.arch if llm.encoder is not None
             else llm.engine.arch).vocab_size
    rng = np.random.default_rng(0)
    out = []
    for batch in args.batch_sizes:
        lens = gen_lengths(args.len_dist, batch, rng)
        prompts = [[int(x) for x in rng.integers(1, vocab - 1, n)]
                   for n in lens]
        llm.encode(prompt_token_ids=prompts)  # warm-up
        times = []
        t0 = time.perf_counter()
        for _ in range(args.iters):
            t1 = time.perf_counter()
            llm.encode(prompt_token_ids=prompts)
            times.append(time.perf_counter() - t1)
        dt = time.perf_counter() - t0
        res = _summary("local", batch, args, sum(lens) * args.iters, dt,
                       times)
        print(json.dumps(res), flush=True)
        out.append(res)
    llm.close()
    return out


def _run_threads(worker, concurrency: int) -> float:
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0


def run_remote(args) -> list[dict]:
    """Each of ``concurrency`` threads sends ``iters`` Encode requests of
    ``batch`` prompts; a failed request fails the run."""
    from arcticinference_tpu_torch.embedding.client import InferenceClient

    rng = np.random.default_rng(0)
    out = []
    for batch in args.batch_sizes:
        lens = gen_lengths(args.len_dist, batch, rng)
        prompts = [[int(x) for x in rng.integers(1, 30000, n)]
                   for n in lens]
        results: list[float] = []
        errors: list[BaseException] = []
        lock = threading.Lock()

        def worker():
            client = InferenceClient(args.target)
            for _ in range(args.iters):
                t1 = time.perf_counter()
                try:
                    embs = client.embed(token_ids=prompts)
                    if len(embs) != batch:
                        raise AssertionError(
                            f"{len(embs)} embeddings for {batch} prompts")
                except BaseException as e:  # noqa: BLE001 — reported
                    with lock:
                        errors.append(e)
                    continue
                with lock:
                    results.append(time.perf_counter() - t1)
            client.close()

        dt = _run_threads(worker, args.concurrency)
        if errors:
            raise RuntimeError(f"{len(errors)} of "
                               f"{args.iters * args.concurrency} requests "
                               f"failed; first: {errors[0]!r}")
        res = _summary("remote", batch, args,
                       sum(lens) * args.iters * args.concurrency, dt,
                       results, concurrency=args.concurrency)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def run_http(args) -> list[dict]:
    """Load on an OpenAI server's ``/v1/embeddings`` (--target is its
    host:port or URL)."""
    import urllib.request

    rng = np.random.default_rng(0)
    url = args.target if args.target.startswith("http") else \
        f"http://{args.target}"
    out = []
    for batch in args.batch_sizes:
        lens = gen_lengths(args.len_dist, batch, rng)
        inputs = [[int(x) for x in rng.integers(1, 30000, n)]
                  for n in lens]
        body = json.dumps({"input": inputs, "model": "bench"}).encode()
        results: list[float] = []
        lock = threading.Lock()

        def worker():
            for _ in range(args.iters):
                req = urllib.request.Request(
                    f"{url}/v1/embeddings", data=body,
                    headers={"Content-Type": "application/json"})
                t1 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    resp = json.loads(r.read())
                assert len(resp["data"]) == batch
                with lock:
                    results.append(time.perf_counter() - t1)

        dt = _run_threads(worker, args.concurrency)
        res = _summary("http", batch, args,
                       sum(lens) * args.iters * args.concurrency, dt,
                       results, concurrency=args.concurrency)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--http", action="store_true",
                        help="drive /v1/embeddings over HTTP (--target is "
                             "then the OpenAI server's host:port)")
    parser.add_argument("--target", default="localhost:50050")
    parser.add_argument("--config", default=None,
                        help="--local: EngineConfig JSON file")
    parser.add_argument("--device", default="cuda:0",
                        help="--local: cuda:0 (default) or cpu")
    parser.add_argument("--batch-sizes", type=int, nargs="+",
                        default=[16, 64])
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--len-dist", default="fixed:128",
                        help="fixed:N | uniform:LO,HI | normal:MU,SD")
    return parser.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    if args.local:
        return run_local(args)
    if args.http:
        return run_http(args)
    return run_remote(args)


if __name__ == "__main__":
    main()
