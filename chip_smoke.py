#!/usr/bin/env python3
"""Drive the PyTorch port (``arcticinference_tpu_torch``) on one H100.

    python3 chip_smoke.py                # every phase (the default)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each reported on its own lines:

1. device:   card name and power limit (nvidia-smi), torch's device name.
2. build:    nvcc builds every kernel source of ``arcticinference_tpu_torch/
             csrc`` at once, one process each (printing ``-Xptxas -v``:
             registers, shared memory, spills).
3. kernels:  each CUDA kernel against its plain PyTorch version at the
             main path's shapes, with its time, the plain version's, the
             bound and a library yardstick: the two attention kernels
             (Hq=32, Hkv=8, D=128, 32-token pages, a 32-layer cache; bf16
             and fp8 KV) and the two quantized matmuls (Llama-3.1-8B's
             wqkv, wo, w_gateup, w_down and lm_head at 16, 64 and 2048
             rows; fp8 everywhere, int8 on w_gateup, int4 everywhere).
4. forward:  the full-width Llama-3.1-8B shapes at 2 layers, random
             weights in bf16, fp8 and int4: one prefill and one decode step
             through ``forward`` with the kernels and with the plain
             versions (attention and matmuls); logits compared.
5. generate: ``LLM.generate`` at the full Llama-3.1-8B width and depth
             (random weights), 16 requests x 32 greedy tokens, in bf16,
             then with ``quantization="fp8"``, then ``"int4"``; every
             request must finish, both attention kernels must launch, and
             a quantized run's matmul kernel must launch 129 times per
             step (4 per layer and the LM head).  The bf16 and fp8 runs
             are followed by a shorter run under ``torch.profiler``.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero; the
script needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Llama-3.1-8B (meta-llama/Llama-3.1-8B config.json).
LLAMA_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=131072, tie_word_embeddings=False,
    rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0,
                      original_max_position_embeddings=8192),
)
HQ, HKV, D, BS, LAYERS = 32, 8, 128, 32, 32
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16 tensor.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
ATOL = RTOL = 2e-2     # bf16 kernel vs plain (tests/test_kernels.py bound)
# ... and over all live rows, ||out - plain|| <= REL_TOL * ||plain||
# (about 10x the largest error the kernels show on the cases below).
REL_TOL = 1e-3
# q ~ N(0, Q_STD^2) against K ~ N(0, 0.25) gives scores of std ~2.5: a
# peaked softmax whose outputs are O(|V|), not O(|V| / sqrt(context)), so
# a mask or page that is off by one token moves them by far more than the
# tolerance (a planted off-by-one mask fails both checks; PERF.md).
Q_STD = 5.0

PHASES = ("device", "build", "kernels", "forward", "generate")
# Quantized matmul cases: (name, K, N, fused part widths, float32 out),
# the Llama-3.1-8B weights the decoder step multiplies.
MATMUL_SHAPES = (
    ("wqkv", 4096, 6144, (4096, 1024, 1024), False),
    ("wo", 4096, 4096, None, False),
    ("w_gateup", 4096, 28672, (14336, 14336), False),
    ("w_down", 14336, 4096, None, False),
    ("lm_head", 4096, 128256, None, True),
)
# Decode batches of 16 and 64 rows and a 2048-token prefill bucket; the LM
# head sees only the sampled rows.
MATMUL_ROWS = (16, 64, 2048)
L2_BYTES = 50 * 2 ** 20
# Matmul kernel launches per step: wqkv, wo, w_gateup, w_down per layer,
# and the LM head.
MATMUL_LAUNCHES_PER_STEP = 4 * LLAMA_8B["num_hidden_layers"] + 1


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ~10 ms of a spinning kernel at H100 clocks (see cuda_time_ms).
QUEUE_SLEEP_CYCLES = 20_000_000


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, over ``iters`` back-to-back calls.  A
    spinning kernel holds the device while the host enqueues them, so a
    kernel shorter than its wrapper's host time (tens of microseconds per
    call) is not timed at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time_us(fn, calls: int = 20) -> float:
    """Host time of one call, enqueue only: ``calls`` calls after the
    device has drained, without waiting for them (few enough launches
    that the launch queue does not fill).  The decode step is host-bound,
    so a wrapper's host cost per call is its cost there."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

class Case:
    """One attention call: requests (ctx, qlen) on a random 32-layer cache
    with scattered page ids; everything on the card."""

    def __init__(self, name, reqs, kv_dtype, rng, t_pad=None, slot_rows=0,
                 layer=17):
        import torch

        self.name, self.reqs, self.layer = name, reqs, layer
        b = len(reqs)
        pages = [-(-(c + q) // BS) if q > 0 else 0 for c, q in reqs]
        n_blocks = sum(pages) + 1
        perm = rng.permutation(np.arange(1, n_blocks))
        max_blk = max(max(pages), 1)
        bt = np.zeros((b, max_blk), np.int32)
        off = 0
        for r, n in enumerate(pages):
            bt[r, :n] = perm[off:off + n]
            off += n
        dev = "cuda"
        kv = torch.randn((LAYERS, n_blocks, 2, BS, HKV * D), device=dev,
                         dtype=torch.bfloat16) * 0.5
        self.kv = kv.to(kv_dtype)
        del kv
        self.kv_scale = torch.ones((LAYERS, 2), device=dev)
        if kv_dtype == torch.float8_e4m3fn:
            self.kv_scale[layer] = torch.tensor([2.0, 0.5])
        total = sum(q for _, q in reqs)
        t = t_pad or total
        pos = np.zeros(t, np.int32)
        req = np.full(t, -1, np.int32)
        i = 0
        for r, (c, q) in enumerate(reqs):
            if slot_rows:
                # Grouped decode layout: slot r owns rows [r*q, (r+1)*q),
                # dead slots (q == 0) included.
                i = r * slot_rows
            pos[i:i + q] = np.arange(c, c + q)
            req[i:i + q] = r
            i += q
        seq = np.zeros(b, np.int32)
        seq[:len(reqs)] = [c + q if q > 0 else 0 for c, q in reqs]
        self.t, self.b = t, b
        self.pos_np, self.req_np, self.seq_np = pos, req, seq
        self.positions = torch.from_numpy(pos).to(dev)
        self.req_idx = torch.from_numpy(req).to(dev)
        self.block_tables = torch.from_numpy(bt).to(dev)
        self.seq_lens = torch.from_numpy(seq).to(dev)
        self.q = torch.randn((t, HQ, D), device=dev,
                             dtype=torch.bfloat16) * Q_STD

    def schedule(self, qb):
        """The work items, built on the host once, as the runner does."""
        import torch

        from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
            build_work_items)

        qlens = np.array([q for _, q in self.reqs], np.int64)
        last = np.array([c + q - 1 for c, q in self.reqs], np.int64)
        sched = build_work_items(qlens, last, qb, BS, self.t // qb + self.b,
                                 self.t)
        return tuple(torch.from_numpy(a).cuda() for a in sched)

    def bound(self):
        """(bound_ms, bound_by, bytes, flops): KV each live request needs
        (read once) + q read + out written, against the causal flops."""
        kv_elem = self.kv.element_size()
        live = self.req_np >= 0
        kv_bytes = int(self.seq_np.sum()) * 2 * HKV * D * kv_elem
        io_bytes = (int(live.sum()) + self.t) * HQ * D * 2
        flops = 4.0 * D * HQ * float((self.pos_np[live] + 1).sum())
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
        t_flops = flops / BF16_FLOP_PER_S
        by = "bytes" if t_bytes >= t_flops else "operations"
        return max(t_bytes, t_flops) * 1e3, by, kv_bytes + io_bytes, flops

    def library_ms(self) -> float:
        """Time of the library's attention over the same rows: one
        ``scaled_dot_product_attention`` call per group of live requests
        with the same query length (the batch's decode rows are one call,
        each prefill chunk is its own), keys padded to the group's longest
        context under a boolean mask.  The q heads of a kv head are folded
        into its query rows, as the kernels do, so K/V are read once per
        kv head.  K/V are already gathered dense.  A yardstick only."""
        import torch
        import torch.nn.functional as F

        g = HQ // HKV
        groups: dict[int, list[int]] = {}
        for r, (_, ql) in enumerate(self.reqs):
            if ql > 0:
                groups.setdefault(ql, []).append(r)
        kv_l = self.kv[self.layer].to(torch.bfloat16)
        ks = self.kv_scale[self.layer]
        calls = []
        for ql, rs in groups.items():
            n = len(rs)
            s_max = max(self.reqs[r][0] + ql for r in rs)
            qd = torch.empty((n, HKV, ql * g, D), device="cuda",
                             dtype=torch.bfloat16)
            kd = torch.zeros((n, HKV, s_max, D), device="cuda",
                             dtype=torch.bfloat16)
            vd = torch.zeros_like(kd)
            mask = torch.zeros((n, 1, ql * g, s_max), device="cuda",
                               dtype=torch.bool)
            for i, r in enumerate(rs):
                c = self.reqs[r][0]
                s = c + ql
                pg = self.block_tables[r, :-(-s // BS)].long()
                kd[i, :, :s] = (kv_l[pg, 0].reshape(-1, HKV, D)[:s]
                                * ks[0]).transpose(0, 1)
                vd[i, :, :s] = (kv_l[pg, 1].reshape(-1, HKV, D)[:s]
                                * ks[1]).transpose(0, 1)
                rows = torch.from_numpy(np.nonzero(self.req_np == r)[0])
                # [ql, Hq, D] -> [Hkv, ql * g, D]: row = token * g + head.
                qd[i] = self.q[rows.cuda()].view(ql, HKV, g, D).transpose(
                    0, 1).reshape(HKV, ql * g, D)
                pos = torch.arange(c, s, device="cuda").repeat_interleave(g)
                mask[i, 0] = (torch.arange(s_max, device="cuda")[None, :]
                              <= pos[:, None])
            calls.append((qd, kd, vd, mask))

        def call():
            for qd, kd, vd, mask in calls:
                F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)

        return cuda_time_ms(call, iters=10)


def run_case(case, fn_kernel, fn_plain, iters_kernel=20, iters_plain=3):
    """Kernel against plain version on one case; returns the case's line
    with ``ok`` False where a check failed."""
    import torch

    out = fn_kernel()
    ref = fn_plain()
    torch.cuda.synchronize()
    live = torch.from_numpy(case.req_np >= 0).to(out.device)
    o, r = out[live].float(), ref[live].float()
    diff = (o - r).abs()
    bad = int((diff > ATOL + RTOL * r.abs()).sum())
    err = float(diff.max())
    rel = float((o - r).norm() / r.norm())
    pad_nonzero = float(out[~live].float().abs().max()) if (~live).any() \
        else 0.0
    ms = cuda_time_ms(fn_kernel, iters_kernel)
    plain_ms = cuda_time_ms(fn_plain, iters_plain, warmup=1)
    bound_ms, bound_by, nbytes, flops = case.bound()
    res = dict(case=case.name, max_abs_err=err, atol=ATOL, rtol=RTOL,
               n_out_of_tol=bad, rel_err=rel, rel_tol=REL_TOL,
               ref_max_abs=float(r.abs().max()),
               ref_rms=float(r.pow(2).mean().sqrt()),
               padding_max_abs=pad_nonzero, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=case.library_ms(), bytes=nbytes, flops=flops)
    res["ok"] = (bad == 0 and rel <= REL_TOL and pad_nonzero == 0.0
                 and bool(np.isfinite(err)))
    log("  case " + json.dumps(res))
    return res


def phase_kernels(rng):
    import torch

    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)

    ragged_cases, grouped_cases = [], []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        # Mixed step: two prefill chunks and 32 decode rows at contexts
        # up to 4096, padded to the 2048-token bucket.
        decode = [(int(c), 1) for c in rng.integers(128, 4096, 32)]
        mixed = [(0, 512), (1024, 1024)] + decode
        for name, reqs, t_pad in (
                (f"mixed 512+1024+32dec {dt}", mixed, 2048),
                (f"prefill 2048@ctx2048 {dt}", [(2048, 2048)], 2048)):
            case = Case(name, reqs, kv_dtype, rng, t_pad=t_pad)
            for qb in (8, 32):
                sched = case.schedule(qb)

                def kern(case=case, qb=qb, sched=sched):
                    return ra.ragged_paged_attention_kernel(
                        case.q, case.kv, case.positions, case.req_idx,
                        case.block_tables, case.seq_lens, qb=qb,
                        schedule=sched, kv_scale=case.kv_scale,
                        layer=case.layer)

                def plain(case=case):
                    return ragged_paged_attention_reference(
                        case.q, case.kv[case.layer], case.positions,
                        case.req_idx, case.block_tables, case.seq_lens,
                        kv_scale=case.kv_scale[case.layer])

                case.name = f"{name} qb={qb}"
                ragged_cases.append(run_case(case, kern, plain))
            del case
            torch.cuda.empty_cache()
        # Pure decode: B=64 slots, 6 dead, contexts 128-4096.
        for qlen in (1, 4):
            ctx = rng.integers(128, 4096, 64)
            dead = rng.choice(64, 6, replace=False)
            reqs = [(0, 0) if r in dead else (int(ctx[r]), qlen)
                    for r in range(64)]
            case = Case(f"decode B=64 qlen={qlen} {dt}", reqs, kv_dtype, rng,
                        t_pad=64 * qlen, slot_rows=qlen)
            pos_base = torch.clamp(case.seq_lens - qlen, min=0)

            def kern(case=case, qlen=qlen, pos_base=pos_base):
                return ra.grouped_decode_attention_kernel(
                    case.q, case.kv, pos_base, case.block_tables,
                    case.seq_lens, qlen=qlen, kv_scale=case.kv_scale,
                    layer=case.layer)

            def plain(case=case):
                return ragged_paged_attention_reference(
                    case.q, case.kv[case.layer], case.positions,
                    case.req_idx, case.block_tables, case.seq_lens,
                    kv_scale=case.kv_scale[case.layer])

            grouped_cases.append(run_case(case, kern, plain))
            del case
            torch.cuda.empty_cache()
    failed = [c["case"] for c in ragged_cases + grouped_cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return ragged_cases, grouped_cases


def quantized_weight(mode, k, n, parts, gen):
    """A [k, n] weight drawn from N(0, 1) on the card and quantized; with
    ``parts`` quantized part by part and fused, as ``fuse_params`` lays
    out wqkv and w_gateup (per-part scales become per-column scales)."""
    import torch

    from arcticinference_tpu_torch.ops import fp8

    w = torch.randn((k, n), generator=gen, device="cuda")
    if not parts:
        return fp8.weight_quantize(w, mode)
    ends = np.cumsum((0,) + parts)
    return fp8.fuse_quantized([fp8.weight_quantize(w[:, a:b], mode)
                               for a, b in zip(ends[:-1], ends[1:])])


def rotating(q, nbytes):
    """Enough copies of ``q`` (a QuantizedLinear or a tensor of
    ``nbytes``) that cycling through them reads past the 50 MB L2, as a
    decode step finds each layer's weights cold."""
    import torch

    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    n = max(1, -(-2 * L2_BYTES // nbytes))
    if isinstance(q, torch.Tensor):
        return itertools.cycle([q] + [q.clone() for _ in range(n - 1)])
    return itertools.cycle([q] + [QuantizedLinear(q.weight.clone(),
                                                  q.scale.clone())
                                  for _ in range(n - 1)])


def run_matmul_case(name, q, x, out_dtype, kernel, plain):
    """Kernel against plain version on one weight and row count; returns
    the case's line with ``ok`` False where a check failed."""
    import torch

    from arcticinference_tpu_torch.ops.fp8 import fp8_dequantize

    out = kernel(x, q.weight, q.scale, out_dtype)
    ref = plain(x, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    bad = int((diff > ATOL + RTOL * r.abs()).sum())
    err = float(diff.max())
    rel = float((o - r).norm() / r.norm())
    wbytes = q.weight.nbytes + q.scale.nbytes
    copies = rotating(q, wbytes)

    def kern():
        c = next(copies)
        kernel(x, c.weight, c.scale, out_dtype)

    ms = cuda_time_ms(kern, iters=20)
    del copies
    host_us = host_time_us(lambda: kernel(x, q.weight, q.scale, out_dtype))
    plain_ms = cuda_time_ms(lambda: plain(x, q.weight, q.scale, out_dtype),
                            iters=3, warmup=1)
    # Yardstick: one torch.mm of x with the weight dequantized to bf16
    # ahead of time (it reads 2x the fp8 / 4x the int4 weight bytes).
    wd = fp8_dequantize(q, torch.bfloat16)
    dense = rotating(wd, wd.nbytes)
    if out_dtype == torch.float32:
        def lib():
            torch.mm(x, next(dense), out_dtype=torch.float32)
    else:
        def lib():
            torch.mm(x, next(dense))
    library_ms = cuda_time_ms(lib, iters=20)
    library_host_us = host_time_us(lib)
    del dense, wd
    m, k = x.shape
    n = out.shape[1]
    nbytes = x.nbytes + wbytes + out.nbytes
    flops = 2.0 * m * n * k
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    res = dict(case=name, max_abs_err=err, atol=ATOL, rtol=RTOL,
               n_out_of_tol=bad, rel_err=rel, rel_tol=REL_TOL,
               ref_max_abs=float(r.abs().max()), ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_flops) * 1e3,
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               library_ms=library_ms, host_us=host_us,
               library_host_us=library_host_us, bytes=nbytes, flops=flops)
    res["ok"] = (bad == 0 and rel <= REL_TOL
                 and bool(torch.isfinite(o).all()))
    log("  case " + json.dumps(res))
    return res


def phase_matmul_kernels(seed):
    """Both quantized matmul kernels against their plain versions at the
    Llama-3.1-8B weight shapes; returns (fp8/int8 cases, int4 cases)."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im

    gen = torch.Generator(device="cuda").manual_seed(seed)
    fp8_cases, int4_cases = [], []
    for mode, kernel, plain, cases in (
            ("fp8", fm.fp8_matmul_kernel, fm.fp8_matmul_reference,
             fp8_cases),
            ("int8", fm.fp8_matmul_kernel, fm.fp8_matmul_reference,
             fp8_cases),
            ("int4", im.int4_matmul_kernel, im.int4_matmul_reference,
             int4_cases)):
        for name, k, n, parts, f32 in MATMUL_SHAPES:
            if mode == "int8" and name != "w_gateup":
                continue
            q = quantized_weight(mode, k, n, parts, gen)
            out_dtype = torch.float32 if f32 else torch.bfloat16
            for m in MATMUL_ROWS:
                if name == "lm_head" and m > 64:
                    continue
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                cases.append(run_matmul_case(
                    f"{mode} {name} [{k},{n}] M={m}", q, x, out_dtype,
                    kernel, plain))
            del q
            torch.cuda.empty_cache()
    failed = [c["case"] for c in fp8_cases + int4_cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return fp8_cases, int4_cases


# ---------------------------------------------------------------------------
# Phase 4: 2-layer full-width forward, kernels against plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_matmuls(module):
    """Run ``module``'s matmuls through the kernels' plain versions."""
    from arcticinference_tpu_torch.ops import fp8

    saved = module.matmul
    module.matmul = fp8.matmul_reference
    try:
        yield
    finally:
        module.matmul = saved


def reset_counts() -> None:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    ra.reset_launch_counts()
    fm.reset_launch_counts()
    im.reset_launch_counts()


def launch_counts() -> dict:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    return {"ragged_paged_attention_kernel": ra.ragged_attention_launches,
            "grouped_decode_attention_kernel": ra.grouped_decode_launches,
            "fp8_matmul_kernel": fm.fp8_matmul_launches,
            "int4_matmul_kernel": im.int4_matmul_launches}


def phase_forward(rng, quantization=None):
    import torch

    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)
    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.runner import ModelRunner
    from arcticinference_tpu_torch.engine.scheduler import Scheduler
    from arcticinference_tpu_torch.models.loader import load_model

    cfg = EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16", max_model_len=4096,
                          hf_overrides={**LLAMA_8B, "num_hidden_layers": 2},
                          quantization=quantization),
        cache=CacheConfig(num_blocks=256),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048))
    dev = torch.device("cuda")
    module, arch, params = load_model(cfg.model, dev)
    runner = ModelRunner(cfg, module, arch, params, dev)
    sched = Scheduler(cfg.scheduler, cfg.cache, runner.num_blocks)
    for i, n in enumerate((200, 500, 1000, 300)):
        sched.add_request(Request(
            f"f{i}", [int(x) for x in rng.integers(0, arch.vocab_size, n)],
            SamplingParams(max_tokens=4)))
    matmul_key = {"fp8": "fp8_matmul_kernel",
                  "int4": "int4_matmul_kernel"}.get(quantization)
    results = []
    for step in ("prefill", "decode"):
        out = sched.schedule()
        si = runner.prepare_inputs(out)
        inputs = runner.upload(si.arrays)
        inputs["kv_scale"] = runner.kv_scale
        logits, launches = {}, {}
        with torch.inference_mode():
            for name in ("kernel", "plain"):
                kv = runner.kv.clone()
                reset_counts()
                with (contextlib.nullcontext() if name == "kernel"
                      else plain_matmuls(module)):
                    attn = (module.make_attn_impl(si.attn_qb)
                            if name == "kernel" else module.plain_attn)
                    kv, h = module.forward(runner.params, arch, kv, inputs,
                                           attn_impl=attn)
                    rows = h[inputs["logits_indices"].long()
                             [:len(out.scheduled)]]
                    logits[name] = module.compute_logits(runner.params, rows)
                torch.cuda.synchronize()
                launches[name] = launch_counts()
                if name == "kernel":
                    kv_next = kv
        runner.kv = kv_next
        a, b = logits["kernel"], logits["plain"]
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = a.argmax(-1) == b.argmax(-1)
        # A row whose top two plain logits are within twice the largest
        # difference is a near tie: its argmax may flip either way.
        top2 = b.topk(2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
        finite = bool(torch.isfinite(a).all())
        res = dict(step=step, quantization=quantization,
                   attn_qb=si.attn_qb, rows=a.shape[0], vocab=a.shape[1],
                   max_abs_diff=diff, max_abs_logit=scale,
                   argmax_agree=float(agree.float().mean()),
                   near_tie_rows=int(near_tie.sum()), finite=finite,
                   kernel_launches=launches["kernel"],
                   plain_launches=launches["plain"])
        log("  forward " + json.dumps(res))
        # bf16 activations: each kernel output is rounded to bf16 on both
        # paths and their float32 sums differ in order, so one-ulp flips
        # (2^-8 relative) propagate through 2 layers and the LM head.
        ok = (finite and diff <= 0.05 * scale
              and bool((agree | near_tie).all())
              and not any(launches["plain"].values()))
        if matmul_key is not None:
            ok = ok and launches["kernel"][matmul_key] == \
                4 * arch.num_layers + 1
        if not ok:
            raise AssertionError(f"forward kernel vs plain: {res}")
        for r, s in enumerate(out.scheduled):
            done = s.request.num_computed_tokens + s.num_new_tokens >= \
                s.request.num_tokens
            sched.update_after_step(
                s, [int(a[r].argmax())] if done else [], 0)
        results.append(res)
    del runner, params
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 5: end to end through LLM.generate
# ---------------------------------------------------------------------------

def phase_generate(rng):
    """The same 16 requests at 32 layers in bf16, fp8 and int4; returns
    {quantization: result}."""
    prompts = [[int(x) for x in rng.integers(0, LLAMA_8B["vocab_size"],
                                             int(n))]
               for n in rng.integers(128, 1025, 16)]
    return {q: run_generate(q, prompts, rng, profile=q in (None, "fp8"))
            for q in (None, "fp8", "int4")}


def run_generate(quantization, prompts, rng, profile):
    import torch

    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    cfg = EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16", max_model_len=4096,
                          hf_overrides=LLAMA_8B, quantization=quantization),
        # 2048 blocks x 4 MiB (2 x 32 layers x 8 heads x 32 tokens x 128 x
        # 2 B) = 8 GiB of KV beside the weights (~16 GB in bf16).
        cache=CacheConfig(num_blocks=2048),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048))
    t0 = time.perf_counter()
    llm = LLM(cfg)            # cuda:0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vocab = llm.engine.arch.vocab_size
    torch.cuda.reset_peak_memory_stats()
    steps0 = llm.engine.engine_stats.num_steps
    reset_counts()
    t0 = time.perf_counter()
    with host_breakdown(llm.engine.runner) as host:
        outs = llm.generate(prompt_token_ids=prompts,
                            sampling_params=SamplingParams(max_tokens=32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_steps = llm.engine.engine_stats.num_steps - steps0
    steps = llm.engine.step_times.summary()
    dec = steps.get("decode", {})
    n_tok = sum(len(o.token_ids) for o in outs)
    res = dict(
        quantization=quantization,
        layers=LLAMA_8B["num_hidden_layers"], requests=len(outs),
        finished=sum(o.finish_reason == "finished_length" for o in outs),
        prompt_tokens=sum(len(p) for p in prompts), generated_tokens=n_tok,
        wall_s=wall, init_s=init_s, engine_steps=n_steps,
        decode_tok_per_s=(dec["tokens"] / dec["total_s"]) if dec else None,
        steps=steps, decode_host_p50_ms=host.summary(), launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        card=smi())
    log("  generate " + json.dumps(res))
    matmul = {"fp8": "fp8_matmul_kernel",
              "int4": "int4_matmul_kernel"}.get(quantization)
    ok = (res["finished"] == 16 and n_tok == 16 * 32
          and all(0 <= t < vocab for o in outs for t in o.token_ids)
          and launches["ragged_paged_attention_kernel"] > 0
          and launches["grouped_decode_attention_kernel"] > 0)
    for key in ("fp8_matmul_kernel", "int4_matmul_kernel"):
        want = MATMUL_LAUNCHES_PER_STEP * n_steps if key == matmul else 0
        ok = ok and launches[key] == want
    if not ok:
        raise AssertionError(f"end-to-end check failed: {res}")
    if profile:
        log("  profile " + json.dumps(dict(
            quantization=quantization, **profile_generate(llm, rng, vocab))))
    del llm, outs
    gc.collect()
    torch.cuda.empty_cache()
    return res


class HostTimes:
    """Host clock of each step's parts: ``prepare_inputs``, the enqueue
    of ``forward`` (it returns before the device finishes) and the whole
    ``execute``, which ends in the tokens' copy to the host."""

    def __init__(self):
        self.rows = []          # (attn_qb, prepare, forward, execute) s

    def summary(self) -> dict:
        """Medians over pure-decode steps, in ms."""
        dec = np.array([r[1:] for r in self.rows if r[0] == 1])
        if not len(dec):
            return {}
        med = np.median(dec, axis=0) * 1e3
        return dict(prepare_inputs=med[0], forward_enqueue=med[1],
                    execute=med[2], steps=len(dec))


@contextlib.contextmanager
def host_breakdown(runner):
    """Time ``runner``'s step parts while the block runs (the engine
    calls them once per step, in this order)."""
    times = HostTimes()
    module, prep, execute = runner.module, runner.prepare_inputs, \
        runner.execute
    forward = module.forward
    part = {}

    def timed(key, fn):
        def call(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            part[key] = time.perf_counter() - t
            return out
        return call

    def timed_execute(step_inputs, generator):
        out = timed("execute", execute)(step_inputs, generator)
        times.rows.append((step_inputs.attn_qb, part["prepare"],
                           part["forward"], part["execute"]))
        return out

    runner.prepare_inputs = timed("prepare", prep)
    runner.execute = timed_execute
    module.forward = timed("forward", forward)
    try:
        yield times
    finally:
        del runner.prepare_inputs, runner.execute
        module.forward = forward


def profile_generate(llm, rng, vocab) -> dict:
    """Device time by kernel over a second, shorter ``generate`` (16 new
    prompts of 128-1024 tokens, 8 output tokens each) under
    ``torch.profiler``: the device's busy share of the wall time (the
    profiler's own host cost included) and the kernels that take most of
    it.  A measurement, not a check: an empty trace reads "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arcticinference_tpu_torch.engine.request import SamplingParams

    prompts = [[int(x) for x in rng.integers(0, vocab, int(n))]
               for n in rng.integers(128, 1025, 16)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompt_token_ids=prompts,
                     sampling_params=SamplingParams(max_tokens=8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    if busy_s == 0:
        return dict(wall_s=wall, device_busy="not measured")
    attn_s = sum(e.self_device_time_total for e in events
                 if "ragged_attention_kernel" in e.key
                 or "grouped_decode_kernel" in e.key) / 1e6
    # Both quantized matmul kernels and their split-K reduction.
    qmm_s = sum(e.self_device_time_total for e in events
                if "qmm::" in e.key) / 1e6
    return dict(
        wall_s=wall, device_busy_s=busy_s, device_busy_share=busy_s / wall,
        attention_share_of_busy=attn_s / busy_s,
        quantized_matmul_share_of_busy=qmm_s / busy_s,
        top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3,
                  calls=e.count) for e in events[:8]])


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from arcticinference_tpu_torch.ops.cuda import build
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    sources = (ra.SOURCE, fm.SOURCE, im.SOURCE)
    t0 = time.perf_counter()
    build.build_all(sources)
    log(f"[build] {', '.join(sources)} in {time.perf_counter() - t0:.1f} s "
        "(one nvcc each, at once)")
    for src in sources:
        log(f"  {src}:")
        for line in build.build_logs.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("    " + line.strip())

    csrc = "arcticinference_tpu_torch/csrc/"
    kernels = {
        "ragged_paged_attention_kernel": dict(
            name="ragged_paged_attention_kernel", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:292"),
        "grouped_decode_attention_kernel": dict(
            name="grouped_decode_attention_kernel", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:1080"),
        "fp8_matmul_kernel": dict(
            name="fp8_matmul_kernel", route="cuda", source=csrc + fm.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/fp8_matmul.py:65"),
        "int4_matmul_kernel": dict(
            name="int4_matmul_kernel", route="cuda", source=csrc + im.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/int4_matmul.py:105"),
    }
    if "kernels" in phases:
        log("[kernels] kernel vs plain, Hq=32 Hkv=8 D=128, 32-layer cache")
        ragged, grouped = phase_kernels(rng)
        log("[kernels] quantized matmuls vs plain, Llama-3.1-8B weights")
        fp8_cases, int4_cases = phase_matmul_kernels(args.seed)
        # The summary line reports, for each kernel, the case of its
        # heaviest main-path step (a 2048-token prefill chunk; a batch-64
        # decode step) or, for the matmuls, the decode weight stream they
        # exist for (w_gateup at 16 rows), and every case beside it.
        for key, cases, rep_name in (
                ("ragged_paged_attention_kernel", ragged,
                 "prefill 2048@ctx2048 bf16 qb=32"),
                ("grouped_decode_attention_kernel", grouped,
                 "decode B=64 qlen=1 bf16"),
                ("fp8_matmul_kernel", fp8_cases,
                 "fp8 w_gateup [4096,28672] M=16"),
                ("int4_matmul_kernel", int4_cases,
                 "int4 w_gateup [4096,28672] M=16")):
            rep = next(c for c in cases if c["case"] == rep_name)
            kernels[key].update(
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=rep["ms"], plain_ms=rep["plain_ms"],
                bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
                library_ms=rep["library_ms"], case=rep["case"],
                tolerance=f"atol={ATOL} rtol={RTOL}, "
                          f"||out-plain||/||plain|| <= {REL_TOL}",
                cases=[{k: c[k] for k in (
                    "case", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err", "rel_err")}
                       for c in cases])
    if "forward" in phases:
        for quantization in (None, "fp8", "int4"):
            log(f"[forward] Llama-3.1-8B width, 2 layers, "
                f"{quantization or 'bf16'} weights, kernels vs plain")
            phase_forward(rng, quantization)
    if "generate" in phases:
        log("[generate] LLM.generate, Llama-3.1-8B shape, 32 layers, bf16 "
            "then fp8 then int4 weights")
        runs = phase_generate(rng)
        # Each kernel's launches from the run of its own path.
        for key, run in (("ragged_paged_attention_kernel", None),
                         ("grouped_decode_attention_kernel", None),
                         ("fp8_matmul_kernel", "fp8"),
                         ("int4_matmul_kernel", "int4")):
            kernels[key]["launches"] = runs[run]["launches"][key]
    log(json.dumps({"kernels": list(kernels.values())}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
