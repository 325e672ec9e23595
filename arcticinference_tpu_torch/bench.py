"""Headline bench of the port: Llama-3.1-8B with fp8 weights on one card.

Counterpart of the JAX package's ``bench.py``.  Decode numbers come from
the subtraction method, ``t(gen = N + 1) - t(gen = 1)`` over fresh
prompts, so prefill never enters them:

- greedy decode tok/s at batch 64 (the headline) and at batch 1;
- the device time of one decode step at (64, ctx): the step's launches
  (``runner.dispatch``) captured once in a CUDA graph and replayed
  between CUDA events, so the host's enqueue does not show; beside it the
  step dispatched eagerly between the same events;
- the bytes one decode step must move (weights less the gathered
  embedding, plus the KV it reads), the GB/s that gives, the HBM read
  probe's GB/s (``ops/cuda/hbm_probe.py``) and the card's nominal peak;
- the same device step with int8 weights;
- the Arctic-drafter phase: a drafter distilled against this target on
  the first run (``benchmarks/distill_drafter.py``, cached under the
  repository's git-ignored ``checkpoints/``), then spec decode tok/s at
  the spec batch, the speed-up over greedy decode at that batch,
  acceptance and tokens per step, on the drafter's own capture prompts;
- the corruption curve (each next draft token corrupted with
  probability ``rate`` through ``ARCTIC_TPU_FUSED_CORRUPT_RATE``) and a
  held-out prompt set the drafter never saw;
- the card's name and power limit (``nvidia-smi``).

    python -m arcticinference_tpu_torch.bench [--device cpu]

prints one JSON line.  ``--device cpu`` runs the JAX bench's tiny CPU
smoke configuration with the kernels' plain versions; the device metrics
(device step, GB/s) are then null, since a CPU run measures none.
``BASELINE_TOKS`` is the reference's published greedy decode rate
(vLLM, ``docs/arctic-speculator.rst:89-94``), not a number of any card
this port ran on.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from arcticinference_tpu_torch.benchmarks.distill_drafter import (
    LLAMA_8B, TINY, distill_drafter, engine_config, free_llm, make_prompts,
    spec_engine_config)
from arcticinference_tpu_torch.utils import events_ms

#: The reference's greedy decode tok/s (vLLM v0.8.4, ShareGPT;
#: docs/arctic-speculator.rst:89-94).
BASELINE_TOKS = 76.0
BASELINE_SOURCE = ("docs/arctic-speculator.rst:89-94 (vLLM v0.8.4 greedy "
                   "decode, ShareGPT)")
REPO = Path(__file__).resolve().parents[1]
CURVE_RATES = (0.12, 0.3, 0.6, 1.0)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def decode_tokens_per_s(llm, prompts_warm, prompts_a, prompts_b, gen: int):
    """Decode-only throughput: ``(t(gen + 1 tokens) - t(1 token))``.

    ``prompts_warm`` absorbs one-time work; the two measured passes use
    fresh prompts.  The subtraction is valid only on a quiet host: a full
    pass barely longer than the prefill-only one means noise swamped the
    signal, and this raises instead of publishing the number."""
    from arcticinference_tpu_torch.engine.request import SamplingParams

    def sp(n):
        return SamplingParams(max_tokens=n, ignore_eos=True)

    dev = llm.engine.device
    llm.generate(prompt_token_ids=prompts_warm, sampling_params=sp(1))
    _sync(dev)
    t0 = time.perf_counter()
    llm.generate(prompt_token_ids=prompts_a, sampling_params=sp(1))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = llm.generate(prompt_token_ids=prompts_b,
                        sampling_params=sp(gen + 1))
    _sync(dev)
    t_full = time.perf_counter() - t0
    n_decode = sum(len(o.token_ids) - 1 for o in outs)
    dt = t_full - t_prefill
    if dt <= 0.05 * t_full:
        raise RuntimeError(
            f"decode-time subtraction degenerate (prefill {t_prefill:.3f}s"
            f" vs full {t_full:.3f}s): host too noisy for a valid "
            f"measurement; rerun the bench on an idle machine")
    return n_decode / dt, dt, outs


def decode_step_inputs(llm, batch: int, ctx: int):
    """A pure-decode step of ``batch`` requests at context ``ctx`` (their
    blocks allocated; the caller frees them)."""
    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.scheduler import (ScheduledRequest,
                                                            SchedulerOutput)

    eng = llm.engine
    runner = eng.runner
    bm = eng.scheduler.block_manager
    rng = np.random.default_rng(7)
    sched = SchedulerOutput()
    reqs = []
    for i in range(batch):
        ids = [int(x) for x in rng.integers(1, runner.arch.vocab_size - 1,
                                             ctx)]
        req = Request(req_id=f"dev{i}", prompt_token_ids=ids,
                      sampling=SamplingParams(max_tokens=4))
        req.num_computed_tokens = ctx - 1
        bm.grow_to(req.block_ids, ctx)
        reqs.append(req)
        sched.scheduled.append(ScheduledRequest(req, 1, []))
    return runner.prepare_inputs(sched), reqs


def capture_step_graph(runner, si, generator) -> torch.cuda.CUDAGraph:
    """The device work of step ``si`` (``runner.launch`` on its uploaded
    inputs, what ``runner.dispatch`` enqueues) captured in a CUDA graph,
    after three warm launches on a side stream."""
    inputs = runner.upload(si.arrays)
    need_sampling = bool(si.arrays["temperature"].max() > 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            runner.launch(inputs, si.attn_qb, need_sampling, generator)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        runner.launch(inputs, si.attn_qb, need_sampling, generator)
    return graph


def measure_device_step(llm, batch: int, ctx: int, iters: int = 30) -> dict:
    """Device ms of one decode step at (``batch``, ``ctx``): the step's
    launches captured in a CUDA graph (:func:`capture_step_graph`) and
    replayed ``iters`` times between CUDA events (``device_ms``), and the
    step dispatched eagerly ``iters`` times between the same events
    (``dispatch_ms``: bounded by the host's enqueue).  On the CPU only
    the eager loop runs, on the host clock."""
    eng = llm.engine
    runner = eng.runner
    si, reqs = decode_step_inputs(llm, batch, ctx)
    gen = eng._generator
    try:
        if runner.device.type != "cuda":
            for _ in range(2):
                runner.dispatch(si, gen)
            t0 = time.perf_counter()
            for _ in range(iters):
                runner.dispatch(si, gen)
            return dict(device_ms=None,
                        dispatch_ms=(time.perf_counter() - t0) / iters * 1e3)
        dispatch_ms = events_ms(lambda: runner.dispatch(si, gen), iters)
        graph = capture_step_graph(runner, si, gen)
        device_ms = events_ms(graph.replay, iters)
        del graph
        return dict(device_ms=device_ms, dispatch_ms=dispatch_ms)
    finally:
        for req in reqs:
            eng.scheduler.block_manager.free(req.block_ids)


def step_bytes(llm, batch: int, ctx: int) -> int:
    """Bytes one decode step must move: every weight (a quantized one's
    values and scales) except the embedding table, which is gathered by
    row, plus the KV of ``batch`` sequences at ``ctx``."""
    runner = llm.engine.runner
    params = runner.params
    weight_bytes = sum(v.nbytes for v in params["layers"].values())
    weight_bytes += sum(v.nbytes for k, v in params.items()
                        if k not in ("layers", "embed"))
    arch = runner.arch
    kv_bytes = (batch * ctx * arch.num_layers * 2 * arch.num_kv_heads
                * arch.head_dim * runner.kv.element_size())
    return int(weight_bytes + kv_bytes)


def _drafter_dir(overrides, spec_batch, prompt_len, gen_len) -> Path:
    """The cached drafter of this configuration: a drafter holds only for
    the target and prompt set it was distilled against."""
    fp = (f"torch-drafter-h{overrides['hidden_size']}"
          f"-v{overrides['vocab_size']}-b{spec_batch}-p{prompt_len}"
          f"-g{gen_len}-s2f")
    return Path(os.environ.get("ARCTIC_BENCH_DRAFTER",
                               REPO / "checkpoints" / fp))


def _spec_point(llm, prompts, gen_len, greedy_toks_s) -> dict:
    """Spec decode tok/s over ``prompts`` with fresh draft statistics."""
    from arcticinference_tpu_torch.stats import SpecDecodingStats

    eng = llm.engine
    eng.spec_stats = SpecDecodingStats()
    toks_s, _, outs = decode_tokens_per_s(llm, prompts, prompts, prompts,
                                          gen_len)
    st = eng.spec_stats
    return dict(
        tokens_per_s=toks_s, speedup=toks_s / greedy_toks_s,
        acceptance=st.acceptance_rate if st.num_drafts else 0.0,
        tokens_per_step=(1 + st.mean_accepted_per_draft
                         if st.num_drafts else 1.0),
        num_drafts=st.num_drafts,
        finished=sum(len(o.token_ids) == gen_len + 1 for o in outs),
        requests=len(outs))


def run_bench(device="cuda", curve_rates=CURVE_RATES) -> dict:
    """Every phase; returns the bench's JSON object.  The card runs the
    JAX bench's sizes (batch 64 and 1, spec batch 32, 128-token prompts,
    128 generated tokens), the CPU its tiny smoke sizes."""
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.ops.cuda.hbm_probe import (
        measure_hbm_roofline)
    from arcticinference_tpu_torch.utils import chip_specs, resolve_device

    device = resolve_device(device)
    on_gpu = device.type == "cuda"
    overrides = dict(LLAMA_8B if on_gpu else TINY)
    vocab = overrides["vocab_size"]
    batch, spec_batch = (64, 32) if on_gpu else (4, 4)
    prompt_len, gen_len = (128, 128) if on_gpu else (16, 8)

    roof = measure_hbm_roofline(device) if on_gpu else None
    _, peak_bps, _ = chip_specs(torch.cuda.get_device_name(device)
                                if on_gpu else "cpu")
    if on_gpu:
        log(f"HBM probes: read {roof['read_bytes_per_s'] / 1e9:.1f} GB/s, "
            f"xor {roof['xor_bytes_per_s'] / 1e9:.1f} GB/s")

    llm = LLM(engine_config(overrides, on_gpu, batch), device=device)
    # Warm every measured bucket (prefill, decode at batch, spec_batch and
    # 1); measured passes use fresh prompts (prefix caching is on).
    for wb in sorted({batch, spec_batch, 1}):
        llm.generate(prompt_token_ids=make_prompts(0, wb, prompt_len, vocab),
                     sampling_params=SamplingParams(max_tokens=2,
                                                    ignore_eos=True))
    toks_s, decode_dt, outs = decode_tokens_per_s(
        llm, make_prompts(21, batch, prompt_len, vocab),
        make_prompts(1, batch, prompt_len, vocab),
        make_prompts(11, batch, prompt_len, vocab), gen_len)
    finished = sum(len(o.token_ids) == gen_len + 1 for o in outs)
    log(f"batch {batch}: {toks_s:.1f} tok/s")
    single_toks_s, _, outs1 = decode_tokens_per_s(
        llm, make_prompts(23, 1, prompt_len, vocab),
        make_prompts(3, 1, prompt_len, vocab),
        make_prompts(13, 1, prompt_len, vocab), gen_len * 2)
    finished1 = sum(len(o.token_ids) == gen_len * 2 + 1 for o in outs1)
    log(f"batch 1: {single_toks_s:.1f} tok/s")

    ctx = prompt_len + gen_len // 2
    step = measure_device_step(llm, batch, ctx)
    nbytes = step_bytes(llm, batch, ctx)
    log(f"device step at ({batch}, {ctx}): {step}")
    if spec_batch != batch:
        greedy_cmp, _, _ = decode_tokens_per_s(
            llm, make_prompts(25, spec_batch, prompt_len, vocab),
            make_prompts(5, spec_batch, prompt_len, vocab),
            make_prompts(15, spec_batch, prompt_len, vocab), gen_len)
    else:
        greedy_cmp = toks_s
    free_llm(llm)
    del llm

    int8 = {}
    if on_gpu:
        llm8 = LLM(engine_config(overrides, on_gpu, batch,
                                 quantization="int8"), device=device)
        s8 = measure_device_step(llm8, batch, ctx)
        int8 = dict(int8_device_ms_per_step=s8["device_ms"],
                    int8_gbps_achieved=(step_bytes(llm8, batch, ctx)
                                        / s8["device_ms"] / 1e6))
        free_llm(llm8)
        del llm8

    drafter = _drafter_dir(overrides, spec_batch, prompt_len, gen_len)
    distill = None
    if not (drafter / "config.json").exists():
        log(f"distilling drafter -> {drafter}")
        distill = distill_drafter(drafter, device, batch=spec_batch,
                                  prompt_len=prompt_len, gen=gen_len)
    # Geometry, batch and prefix caching of the capture run (see
    # spec/distill.py capture_pairs).
    sllm = LLM(spec_engine_config(overrides, on_gpu, spec_batch,
                                  drafter), device=device)
    prompts = make_prompts(2, spec_batch, prompt_len, vocab)
    sllm.generate(prompt_token_ids=prompts,
                  sampling_params=SamplingParams(max_tokens=8,
                                                 ignore_eos=True))
    head = _spec_point(sllm, prompts, gen_len, greedy_cmp)
    spec_step_ms = (head["tokens_per_step"] * spec_batch
                    / head["tokens_per_s"] * 1e3)
    spec_bytes = step_bytes(sllm, spec_batch, ctx)
    spec = {
        "spec_decode_tokens_per_s": head["tokens_per_s"],
        "spec_step_ms_wall": spec_step_ms,
        "spec_step_gbps": spec_bytes / spec_step_ms / 1e6,
        "greedy_decode_tokens_per_s_same_batch": greedy_cmp,
        "spec_speedup": head["speedup"],
        "spec_acceptance_rate": head["acceptance"],
        "spec_tokens_per_step": head["tokens_per_step"],
        "spec_num_drafts": head["num_drafts"],
        "spec_finished": head["finished"],
        "spec_batch": spec_batch,
        "spec_width_stats": sllm.engine.width_stats,
        "drafter_distilled_here": distill is not None,
        "drafter_train_acc": json.loads(
            (drafter / "config.json").read_text())
        .get("distill_metrics", {}).get("train_acc"),
    }
    if distill is not None:
        spec["drafter_capture_s"] = distill["capture_s"]
        spec["drafter_train_s"] = distill["train_s"]
    # The same engine with each next draft token corrupted with
    # probability `rate` (read when a fused program is built, so
    # the loop's programs are dropped at each point).
    curve = []
    fused = sllm.engine._fused
    for rate in curve_rates:
        os.environ["ARCTIC_TPU_FUSED_CORRUPT_RATE"] = str(rate)
        try:
            fused._fns.clear()
            pt = _spec_point(sllm, prompts, gen_len, greedy_cmp)
        finally:
            os.environ.pop("ARCTIC_TPU_FUSED_CORRUPT_RATE", None)
            fused._fns.clear()
        curve.append(dict(corrupt_rate=rate, **pt))
    spec["spec_curve"] = curve
    heldout = make_prompts(97, spec_batch, prompt_len, vocab)
    spec["spec_heldout"] = _spec_point(sllm, heldout, gen_len,
                                       greedy_cmp)
    free_llm(sllm)
    del sllm

    device_ms = step["device_ms"]
    achieved = nbytes / device_ms / 1e6 if device_ms else None
    out = {
        "metric": ("llama8b_fp8_greedy_decode_tokens_per_s_per_card"
                   if on_gpu else "cpu_smoke_tokens_per_s"),
        "value": toks_s,
        "unit": "tok/s",
        "baseline_tokens_per_s": BASELINE_TOKS,
        "baseline_source": BASELINE_SOURCE,
        "vs_baseline": toks_s / BASELINE_TOKS,
        "decode_only": True,
        "device": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "card": smi() if on_gpu else None,
        "batch": batch,
        "prompt_len": prompt_len,
        "gen_len": gen_len,
        "finished": finished,
        "single_seq_finished": finished1,
        "wall_ms_per_step": decode_dt / gen_len * 1e3,
        "device_ms_per_step": device_ms,
        "dispatch_ms_per_step": step["dispatch_ms"] if on_gpu else None,
        "step_bytes": nbytes,
        "hbm_gbps_achieved": achieved,
        "hbm_gbps_probe": roof["bytes_per_s"] / 1e9 if on_gpu else None,
        "hbm_gbps_read_probe": (roof["read_bytes_per_s"] / 1e9
                                if on_gpu else None),
        "hbm_gbps_xor_probe": (roof["xor_bytes_per_s"] / 1e9
                               if on_gpu else None),
        "hbm_gbps_peak_nominal": peak_bps / 1e9 if peak_bps else None,
        "pct_hw_peak": (100 * achieved * 1e9 / peak_bps
                        if achieved and peak_bps else None),
        "single_seq_decode_tokens_per_s": single_toks_s,
        **int8,
        **spec,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--curve-rates", default=",".join(map(str, CURVE_RATES)))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    rates = tuple(float(r) for r in args.curve_rates.split(",") if r)
    out = run_bench(args.device, curve_rates=rates)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
