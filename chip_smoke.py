#!/usr/bin/env python3
"""Drive the PyTorch port (``arcticinference_tpu_torch``) on one H100.

    python3 chip_smoke.py                # every phase (the default)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each reported on its own lines:

1. device:   card name and power limit (nvidia-smi), torch's device name.
2. build:    nvcc builds every kernel source of ``arcticinference_tpu_torch/
             csrc`` (the attention kernels, the two quantized matmuls,
             the HBM read probe and the weight-stream matmul variants)
             at once, one process each (printing ``-Xptxas -v``:
             registers, shared memory, spills); ``cuobjdump -sass`` must
             find HMMA (tensor-core) instructions in every instance of
             the ragged kernel, the grouped decode kernel and the
             page-range decode kernel (kernel 4), and HGMMA (wgmma)
             instructions in every instance of the quantized matmul
             pipeline (kernels 5 and 6, and kernel 8's variants on it).
3. kernels:  each CUDA kernel against its plain PyTorch version at the
             main path's shapes, with its time, the plain version's, the
             bound and a library yardstick: the two attention kernels
             (Hq=32, Hkv=8, D=128, 32-token pages, a 32-layer cache; bf16
             and fp8 KV), the grouped kernel (kernel 2) on decode steps
             of B=64 sequences at qlen 1, 4 and 8, also on a poisoned
             cache, its rows held bit for bit against qlen-1 launches at
             qlen 4 and 8, the per-sequence decode kernel (kernel 4) on
             the same steps (bf16 and fp8, also on the poisoned cache,
             its rows bit for bit against qlen-1 launches at qlen 4 and
             8) and, beside kernel 2, on long-context steps (B=8 at
             16384-32768 tokens, one slot dead, qlen 1 and 8, a
             one-layer cache of 8192 pages), the grouped kernel's
             deferred-KV path
             (kernel 3; B=64 sequences, 1 or 8 rows each, contexts
             128-2048, dead slots and slot -1 tails; also on a cache
             poisoned from pos_base on), beside kernel 2 on the same
             steps with the rows written into the cache, the ragged
             kernel's tree-mask path on two token-tree verify steps (16
             requests at context ~1024 with a frontier row and a 30-node
             tree each; a 512-token prefill chunk beside 15 such trees),
             the ragged kernel on a poisoned cache (NaN, or fp8 0x7f, in
             every unreferenced block and every slot past seq_len) on
             the mixed step and the tree-verify step against the plain
             version on the clean one, and the two quantized matmuls
             (Llama-3.1-8B's wqkv, wo, w_gateup, w_down and lm_head at
             16, 64, 128, 256 and 2048 rows, the LM head at 16 and 64;
             fp8 everywhere, int8 on w_gateup, int4 everywhere; fp8 and
             int8 at the Arctic drafter's head [4096, 128256] and
             projection [4096, 4096], 16 and 64 rows; each row's output
             bit for bit the same beside other rows and at another row
             index, two launches alike, and a CUDA graph of one launch
             replayed twice alike the eager launch),
             the HBM read probe (kernel 7) on the full 4 GiB buffer of
             seeded random bf16 values, and the four weight-stream matmul
             variants (kernel 8: f16 trick, bit trick, astype e4m3, astype
             int8) at the five Llama-3.1-8B decode shapes, 64 rows.  At
             Qwen2.5-7B's GQA group 7 (Hq=28, Hkv=4, D=128, a 28-layer
             cache; bf16 and fp8 KV): the ragged kernel on the mixed step
             (qb 8 and 32), on it poisoned and on the 2048-token prefill
             chunk (qb 32: 224-row items, two row passes), kernels 2 and
             4 on B=64 decode steps at qlen 1, 4 and 8, also poisoned,
             their rows bit for bit against qlen-1 launches; kernel 5 at
             the Qwen2.5-7B and Qwen3-8B weights Llama's do not cover (16,
             64 and 2048 rows; w_down's K of 18944 and 12288 among them),
             with bit-for-bit row replays.  SwiftKV's shapes: the ragged
             kernel on a swift half (16 one-row requests at contexts
             128-2048 beside 4 four-row verify chunks, on the runner's
             8-row schedule over the sample rows; also poisoned), and
             kernel 5 on the fused KV operand of Llama-3.1-SwiftKV-8B's
             16 later layers ([4096, 32768], per-column fp8 scales) at
             16, 64 and 2048 rows, with bit-for-bit row replays.
4. forward:  the full-width Llama-3.1-8B shapes at 2 layers, random
             weights in bf16, fp8 and int4: one prefill, one decode and
             one token-tree verify step through ``forward`` with the
             kernels and with the plain versions (attention and matmuls);
             logits compared.  Then the fused loop's wide step (16 slots
             x 8 rows) in bf16 and fp8 with ARCTIC_TPU_DEFERRED_KV on and
             off: logits compared, caches byte-identical, the deferred
             path launched once per layer only with the flag.  Then the
             prefill, decode and tree-verify steps at the full Qwen2.5-7B
             and Qwen3-8B widths, 2 layers, in bf16 and fp8.  Then
             Llama-3.1-SwiftKV-8B's width at 4 layers (2 + 2) in bf16, fp8
             and int4: a prefill with its third prompt chunked (sample
             rows at the chunks' ends), a mixed step and a pure decode
             step; logits and caches compared, kernel 5 launched 4 x 4
             + 2 times a step.
5. generate: ``LLM.generate`` at the full Llama-3.1-8B width and depth
             (random weights), 16 requests x 32 greedy tokens, in bf16,
             then four times with suffix speculation
             (``SpeculativeConfig(method="suffix")``, the suffix cache
             seeded from the bf16 run's output and corrupted copies of
             it): linear drafts on the synchronous step, token trees, and
             linear drafts on the fused decode loop (the default) without
             and with ARCTIC_TPU_DEFERRED_KV=1 (that run with the loop's
             width pinned to wide, the program that defers), every fused
             step's dispatch under
             ``torch.cuda.set_sync_debug_mode("error")``;
             then with Arctic drafters (``method="arctic"``, random init
             at the JAX defaults: an MLP on the fused loop and on the
             synchronous step, an fp8 LSTM on the fused loop, MLP +
             suffix decoding on the fused loop; every fused step with
             room verifies drafts, the fp8 drafter's head launches
             kernel 5, the drafter chain is timed at 16 and 64 rows
             against its bound); then with ``quantization="fp8"``, then
             ``"int4"``; every
             request must finish, both attention kernels must launch (a
             speculative run: the ragged kernel, and in the tree run its
             tree-mask path), the deferred path only in the deferred run,
             a run with suffix decoding must accept drafts on the native
             suffix tree, a fused run must run fused steps, and a quantized
             run's matmul kernel must launch 129 times per step (4 per
             layer and the LM head).  Then ``LLM.generate`` at the full
             width and depth of Qwen2.5-7B (28 layers) and Qwen3-8B (36
             layers), random weights, 16 x 32 greedy tokens in bf16 and
             fp8 (kernel 5 launched 113 and 145 times a step), and
             Qwen3-8B in fp8 with requests asking for penalties
             (repetition 1.2, presence 0.5, frequency 0.3) and 5 logprobs:
             the penalties moving logits, bit for bit as the plain
             version computes them on the CPU, each logprob list as long
             as the tokens, its top id the committed token, the requests
             without penalties giving the plain fp8 run's tokens.
             Between the Llama and the Qwen runs, Llama-3.1-SwiftKV-8B at
             full width and depth (16 + 16
             layers, random weights) on the Llama runs' prompts, bf16 and
             fp8 (kernel 5 launched 130 times a step: one fused KV
             operand), suffix decoding on the synchronous step and on the
             fused loop (seeded from the SwiftKV bf16 run), an MLP drafter
             on the fused loop and the all-combined config (MLP drafter +
             suffix decoding, fused); the bf16 and fp8 runs of both
             models also time a 2048-token prefill step and a decode step
             of 16 x 512 as CUDA graphs, printed beside each other with
             the runs' mixed- and decode-step host times.
6. bench:    the serving matrix first (``python -m
             arcticinference_tpu_torch.benchmarks.serve_bench`` over
             baseline, suffix, spec, swiftkv and all, one process each, at
             Llama-3.1-8B's shape in fp8, 32 prompts x 128 in x 64 out;
             every config must finish every prompt), then the port's
             headline bench (``arcticinference_tpu_torch.bench``) in this
             process at the full Llama-3.1-8B width and depth with fp8
             weights: decode tok/s at batch 64 and 1, the device step
             (a CUDA graph of ``runner.dispatch``'s launches), GB/s against
             the HBM probes, the int8 device step, a drafter distilled
             here against the target (capture, 600 Adam steps, save), its
             spec decode tok/s, speed-up and acceptance on its capture
             prompts, the corruption curve at 0.3 and 1.0 and the held-out
             point; then the weight-stream microbench
             (``benchmarks/stream_microbench.py``).  The probe must read at
             most 1.05x the nominal 3.35 TB/s, every batch must finish,
             the distilled drafter's acceptance must exceed 0.5, and the
             bench must launch the probe, the attention kernels and the fp8
             matmul, the microbench the weight-stream kernel.
Last, a shorter bf16 and fp8 run of phase 5, the drafter chains and the
bench's device step (its CUDA graph) under ``torch.profiler``, each on an
engine of its own (no timed run follows a profiled one); the device step
must launch no split-K reduction of the quantized matmuls.

The bench's JSON line comes before the kernels JSON; the last lines are
the kernels JSON, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Any failed check exits non-zero; the
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
import tempfile
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
# Qwen/Qwen2.5-7B-Instruct and Qwen/Qwen3-8B (their config.json on the
# Hugging Face Hub), with head_dim 128 (Qwen2.5's hidden / heads; Qwen3's
# explicit head_dim).
QWEN25_7B = dict(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944,
    num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=32768, tie_word_embeddings=False)
QWEN3_8B = dict(
    vocab_size=151936, hidden_size=4096, intermediate_size=12288,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
    max_position_embeddings=40960, tie_word_embeddings=False)
# Snowflake/Llama-3.1-SwiftKV-8B-Instruct (its config.json): Llama-3.1-8B
# with the later 16 of its 32 layers on the projected KV.
LLAMA_SWIFTKV_8B = dict(LLAMA_8B, num_key_value_layers=16)
# Architecture (registry name) and dims of each model the script drives.
MODELS = {"llama-3.1-8b": ("llama", LLAMA_8B),
          "llama-3.1-swiftkv-8b": ("llama_swiftkv", LLAMA_SWIFTKV_8B),
          "qwen2.5-7b": ("qwen2", QWEN25_7B),
          "qwen3-8b": ("qwen3", QWEN3_8B)}
# Qwen2.5-7B's attention: GQA group 7 (28 q heads over 4 kv heads).
G7_HQ, G7_HKV = 28, 4
sys.path.insert(0, str(Path(__file__).resolve().parent))
from arcticinference_tpu_torch.utils import chip_specs  # noqa: E402

# H100 SXM peaks (the port's card table): HBM3 bandwidth, dense bf16 tensor.
_, HBM_BYTES_PER_S, BF16_FLOP_PER_S = chip_specs("NVIDIA H100 80GB HBM3")
ATOL = RTOL = 2e-2     # bf16 kernel vs plain (tests/test_kernels.py bound)
# ... and over all live rows, ||out - plain|| <= REL_TOL * ||plain||
# (about 10x the largest error the kernels show on the cases below).
REL_TOL = 1e-3
# q ~ N(0, Q_STD^2) against K ~ N(0, 0.25) gives scores of std ~2.5: a
# peaked softmax whose outputs are O(|V|), not O(|V| / sqrt(context)), so
# a mask or page that is off by one token moves them by far more than the
# tolerance (a planted off-by-one mask fails both checks; PERF.md).
Q_STD = 5.0

PHASES = ("device", "build", "kernels", "forward", "generate", "bench")
# Corruption rates of phase 6's curve (the bench's own sweep is 0.12, 0.3,
# 0.6, 1.0; two points keep the script within its time).
BENCH_CURVE_RATES = (0.3, 1.0)

# Draft trees of the tree-verify steps: 30 nodes, best first, from one
# fixed seed (node i hangs off the frontier or an earlier node).
TREE_NODES = 30
# Pages of the long-context decode cache (8192 x 128 KiB in bf16: a
# one-layer cache of 1 GiB, as a long-context deployment holds per layer).
LONG_CTX_PAGES = 8192


def _best_first_parents(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [-1] + [int(rng.integers(-1, i)) for i in range(1, n)]


TREE_PARENTS = _best_first_parents(30, TREE_NODES)
# Suffix decoding knobs of the speculative generate runs (those of
# tests/test_tree_spec.py, so the seeded cache yields long drafts and
# branching trees).
SUFFIX_KNOBS = dict(suffix_max_spec_factor=4.0, suffix_max_spec_offset=8.0,
                    suffix_min_token_prob=0.05)
# Generate runs with an Arctic drafter (``SpeculativeConfig(method=
# "arctic")``, the JAX defaults: n_predict 3, tied, inner 4096): drafter
# kind, then its options ("fp8" weights, "suffix" decoding beside it) and
# the step ("fused" loop or "sync").
DRAFTER_RUNS = ("mlp fused", "mlp sync", "lstm fp8 fused",
                "mlp suffix fused")
# Quantized matmul cases: (name, K, N, fused part widths, float32 out),
# the Llama-3.1-8B weights the decoder step multiplies.
MATMUL_SHAPES = (
    ("wqkv", 4096, 6144, (4096, 1024, 1024), False),
    ("wo", 4096, 4096, None, False),
    ("w_gateup", 4096, 28672, (14336, 14336), False),
    ("w_down", 14336, 4096, None, False),
    ("lm_head", 4096, 128256, None, True),
)
# Decode batches of 16 and 64 rows, the fused steps' verify rows at batch
# 32 and 64 x qlen 4 (128, 256) and a 2048-token prefill bucket; the LM
# head sees only the sampled rows.
MATMUL_ROWS = (16, 64, 128, 256, 2048)
# Kernel 5's Qwen products that Llama's do not cover, (name, K, N, fused
# part widths, float32 out), at 16, 64 and 2048 rows (the heads at 16
# and 64).
QWEN_MATMUL_SHAPES = (
    ("qwen2.5 wqkv", 3584, 4608, (3584, 512, 512), False),
    ("qwen2.5 wo", 3584, 3584, None, False),
    ("qwen2.5 w_gateup", 3584, 37888, (18944, 18944), False),
    ("qwen2.5 w_down", 18944, 3584, None, False),
    ("qwen2.5 lm_head", 3584, 152064, None, True),
    ("qwen3 w_gateup", 4096, 24576, (12288, 12288), False),
    ("qwen3 w_down", 12288, 4096, None, False),
    ("qwen3 lm_head", 4096, 151936, None, True),
)
QWEN_MATMUL_ROWS = (16, 64, 2048)
# SwiftKV's stacked K / V projection of its 16 later layers, fused into
# one operand [4096, 2 x 16 x 1024] (one fp8 scale per layer and part,
# as per-column scales), at decode batches and a 2048-token prefill.
SWIFT_KV_SHAPE = ("swift kv", 4096, 2 * 16 * 1024, (1024,) * 32, False)
SWIFT_KV_ROWS = (16, 64, 2048)
# The Arctic drafter's quantized products at the 8B width (fp8 and int8
# drafters, float32 out): its tied LM head and its MLP projection, at the
# drafter batch buckets of 16 and 64 requests.
DRAFTER_MATMULS = (("head", 4096, 128256), ("proj", 4096, 4096))
DRAFTER_ROWS = (16, 64)
L2_BYTES = 50 * 2 ** 20


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ~10 ms of a spinning kernel at H100 clocks (see cuda_time_ms).
QUEUE_SLEEP_CYCLES = 20_000_000


def cuda_time_ms(fn, iters: int, warmup: int = 2,
                 sleep_cycles: int = QUEUE_SLEEP_CYCLES) -> float:
    """Device time of one call, over ``iters`` back-to-back calls.  A
    spinning kernel (``sleep_cycles``) holds the device while the host
    enqueues them, so a kernel shorter than its wrapper's host time (tens
    of microseconds per call) is not timed at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
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
    """One attention call: requests (ctx, qlen) on a random cache of
    ``layers`` layers (32 by default) and at least ``n_blocks`` pages,
    with scattered page ids; everything on the card."""

    def __init__(self, name, reqs, kv_dtype, rng, t_pad=None, slot_rows=0,
                 layer=17, layers=None, n_blocks=None, hq=HQ, hkv=HKV):
        import torch

        self.name, self.reqs, self.layer = name, reqs, layer
        self.hq, self.hkv = hq, hkv
        b = len(reqs)
        pages = [-(-(c + q) // BS) if q > 0 else 0 for c, q in reqs]
        n_blocks = max(n_blocks or 0, sum(pages) + 1)
        perm = rng.permutation(np.arange(1, n_blocks))
        max_blk = max(max(pages), 1)
        bt = np.zeros((b, max_blk), np.int32)
        off = 0
        for r, n in enumerate(pages):
            bt[r, :n] = perm[off:off + n]
            off += n
        dev = "cuda"
        layers = layers or LAYERS
        kv = torch.randn((layers, n_blocks, 2, BS, hkv * D), device=dev,
                         dtype=torch.bfloat16) * 0.5
        self.kv = kv.to(kv_dtype)
        del kv
        self.kv_scale = torch.ones((layers, 2), device=dev)
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
        self.q = torch.randn((t, hq, D), device=dev,
                             dtype=torch.bfloat16) * Q_STD

    def schedule_np(self, qb):
        """The work items, built on the host, as the runner does."""
        from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
            build_work_items)

        qlens = np.array([q for _, q in self.reqs], np.int64)
        last = np.array([c + q - 1 for c, q in self.reqs], np.int64)
        return build_work_items(qlens, last, qb, BS, self.t // qb + self.b,
                                self.t)

    def schedule(self, qb):
        """The work items on the card (built once per case)."""
        import torch

        return tuple(torch.from_numpy(a).cuda() for a in self.schedule_np(qb))

    def attended(self, live):
        """kv slots each live row attends (causal: its position + 1)."""
        return (self.pos_np[live] + 1).astype(np.float64)

    def allowed(self, rows, s_max):
        """[rows, s_max] bool: which kv slots each of ``rows`` attends."""
        return np.arange(s_max)[None, :] <= self.pos_np[rows][:, None]

    def bound(self):
        """(bound_ms, bound_by, bytes, flops): KV each live request needs
        (read once) + q read + out written, against the flops of the kv
        slots each row attends."""
        kv_elem = self.kv.element_size()
        live = self.req_np >= 0
        kv_bytes = int(self.seq_np.sum()) * 2 * self.hkv * D * kv_elem
        io_bytes = (int(live.sum()) + self.t) * self.hq * D * 2
        flops = 4.0 * D * self.hq * float(self.attended(live).sum())
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
        t_flops = flops / BF16_FLOP_PER_S
        by = "bytes" if t_bytes >= t_flops else "operations"
        return max(t_bytes, t_flops) * 1e3, by, kv_bytes + io_bytes, flops

    def library_kv(self):
        """The cache layer the library yardstick reads."""
        return self.kv[self.layer]

    def library_ms(self) -> float:
        """Time of the library's attention over the same rows: one
        ``scaled_dot_product_attention`` call per group of live requests
        with the same query length (the batch's decode rows are one call,
        each prefill chunk is its own), keys padded to the group's longest
        context under a boolean mask (the rows' causal or tree mask).  The q heads of a kv head are folded
        into its query rows, as the kernels do, so K/V are read once per
        kv head.  K/V are already gathered dense.  A yardstick only."""
        import torch
        import torch.nn.functional as F

        hkv = self.hkv
        g = self.hq // hkv
        groups: dict[int, list[int]] = {}
        for r, (_, ql) in enumerate(self.reqs):
            if ql > 0:
                groups.setdefault(ql, []).append(r)
        kv_l = self.library_kv().to(torch.bfloat16)
        ks = self.kv_scale[self.layer]
        calls = []
        for ql, rs in groups.items():
            n = len(rs)
            s_max = max(self.reqs[r][0] + ql for r in rs)
            qd = torch.empty((n, hkv, ql * g, D), device="cuda",
                             dtype=torch.bfloat16)
            kd = torch.zeros((n, hkv, s_max, D), device="cuda",
                             dtype=torch.bfloat16)
            vd = torch.zeros_like(kd)
            mask = torch.zeros((n, 1, ql * g, s_max), device="cuda",
                               dtype=torch.bool)
            for i, r in enumerate(rs):
                c = self.reqs[r][0]
                s = c + ql
                pg = self.block_tables[r, :-(-s // BS)].long()
                kd[i, :, :s] = (kv_l[pg, 0].reshape(-1, hkv, D)[:s]
                                * ks[0]).transpose(0, 1)
                vd[i, :, :s] = (kv_l[pg, 1].reshape(-1, hkv, D)[:s]
                                * ks[1]).transpose(0, 1)
                rows_np = np.nonzero(self.req_np == r)[0]
                rows = torch.from_numpy(rows_np)
                # [ql, Hq, D] -> [Hkv, ql * g, D]: row = token * g + head.
                qd[i] = self.q[rows.cuda()].view(ql, hkv, g, D).transpose(
                    0, 1).reshape(hkv, ql * g, D)
                mask[i, 0] = torch.from_numpy(self.allowed(
                    rows_np, s_max)).cuda().repeat_interleave(g, dim=0)
            calls.append((qd, kd, vd, mask))

        def call():
            for qd, kd, vd, mask in calls:
                F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)

        return cuda_time_ms(call, iters=10)


class TreeCase(Case):
    """A token-tree verify step: requests (context, real tokens fed, tree
    parents or None).  A tree's rows follow its request's last real
    token (the frontier) at depth-based positions and linear slots, with
    the ancestor bitmasks the runner builds."""

    def __init__(self, name, tree_reqs, kv_dtype, rng, t_pad):
        import torch

        from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
            tree_masks)

        n_new = [c + len(p or ()) for _, c, p in tree_reqs]
        super().__init__(name, [(ctx, n) for (ctx, _, _), n in
                                zip(tree_reqs, n_new)], kv_dtype, rng,
                         t_pad=t_pad)
        self.row_mask_np = np.zeros(self.t, np.int32)
        self.tree_start_np = np.full(self.b, -1, np.int32)
        i = 0
        for r, ((ctx, chunk, parents), n) in enumerate(zip(tree_reqs, n_new)):
            if parents:
                depth, mask = tree_masks(parents)
                ts = self.tree_start_np[r] = ctx + chunk - 1
                self.pos_np[i + chunk:i + n] = ts + 1 + depth
                self.row_mask_np[i + chunk:i + n] = mask
            i += n
        self.positions = torch.from_numpy(self.pos_np).cuda()
        self.row_mask = torch.from_numpy(self.row_mask_np).cuda()
        self.tree_start = torch.from_numpy(self.tree_start_np).cuda()

    def schedule_np(self, qb):
        from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
            tree_work_items)

        sched = super().schedule_np(qb)
        return sched + tree_work_items(self.row_mask_np, self.tree_start_np,
                                       sched[0], sched[5], sched[6], qb)

    def attended(self, live):
        """A tree row attends the context through the frontier and its
        ancestors (itself included): ts + 1 + popcount(mask) - 1."""
        out = super().attended(live)
        m = self.row_mask_np[live]
        tree = m != 0
        ts = self.tree_start_np[self.req_np[live]]
        bits = np.array([bin(int(x) & ~1).count("1") for x in m[tree]])
        out[tree] = ts[tree] + 1 + bits
        return out

    def allowed(self, rows, s_max):
        ok = super().allowed(rows, s_max)
        m = self.row_mask_np[rows][:, None].astype(np.int64)
        rel = np.arange(s_max)[None, :] - \
            self.tree_start_np[self.req_np[rows]][:, None]
        bit = (m >> np.clip(rel, 0, 31)) & 1
        return np.where((m != 0) & (rel >= 1), (rel < 32) & (bit > 0), ok)


class DeferredCase(Case):
    """A grouped decode step with deferred KV writes (kernel 3): slot r
    owns rows [r*qlen, (r+1)*qlen) at positions ctx + j, dead slots
    included; the step's new rows knew / vnew [B*qlen, Hkv*D] (cache
    dtype, drawn as the cache's values are, so a new row weighs as much
    as a cached one) are injected, and slots in ``tails`` end in that
    many slot -1 rows (new_len < qlen).

    ``written`` is the layer with the new rows scattered at their slots:
    kernel 2 on it (causal) is the same step without deferral, and the
    library yardstick reads it."""

    def __init__(self, name, reqs, qlen, tails, kv_dtype, rng):
        import torch

        super().__init__(name, reqs, kv_dtype, rng, t_pad=len(reqs) * qlen,
                         slot_rows=qlen)
        self.qlen = qlen
        self.pos_base = torch.from_numpy(np.array(
            [c for c, _ in reqs], np.int32)).cuda()
        self.new_len = np.array([0 if q == 0 else q - tails.get(r, 0)
                                 for r, (_, q) in enumerate(reqs)])
        slot = np.full(self.t, -1, np.int32)
        bt = self.block_tables.cpu().numpy()
        for r, (c, _) in enumerate(reqs):
            for j in range(self.new_len[r]):
                p = c + j
                slot[r * qlen + j] = bt[r, p // BS] * BS + p % BS
        self.slot_np = slot
        self.slot_mapping = torch.from_numpy(slot).cuda()
        self.knew, self.vnew = (
            (torch.randn((self.t, HKV * D), device="cuda") * 0.5
             ).to(kv_dtype) for _ in range(2))
        real = torch.from_numpy(slot >= 0).cuda()
        sl = self.slot_mapping[real].long()
        self.written = self.kv[self.layer].clone()
        w = self.written.view(torch.uint8)      # bytes: any cache dtype
        w[sl // BS, 0, sl % BS] = self.knew[real].view(torch.uint8)
        w[sl // BS, 1, sl % BS] = self.vnew[real].view(torch.uint8)
        #: False: the same rows as a causal step over ``written``.
        self.deferred = True

    def library_kv(self):
        return self.written

    def attended(self, live):
        """Row j of sequence r: its ctx cache slots and new rows
        0..min(j, new_len - 1)."""
        if not self.deferred:
            return super().attended(live)
        r = self.req_np[live]
        j = self.pos_np[live] - self.pos_base.cpu().numpy()[r]
        return (self.pos_base.cpu().numpy()[r]
                + np.minimum(j + 1, self.new_len[r])).astype(np.float64)

    def allowed(self, rows, s_max):
        if not self.deferred:
            return super().allowed(rows, s_max)
        r = self.req_np[rows]
        base = self.pos_base.cpu().numpy()[r]
        last = base + np.minimum(self.pos_np[rows] - base,
                                 self.new_len[r] - 1)
        return np.arange(s_max)[None, :] <= last[:, None]

    def bound(self):
        """KV pages below pos_base of each live sequence (read once), q
        and out, knew and vnew."""
        if not self.deferred:
            return super().bound()
        kv_elem = self.kv.element_size()
        live = self.req_np >= 0
        ctx = sum(c for c, q in self.reqs if q > 0)
        kv_bytes = (ctx * 2 * HKV * D + 2 * self.t * HKV * D) * kv_elem
        io_bytes = (int(live.sum()) + self.t) * HQ * D * 2
        flops = 4.0 * D * HQ * float(self.attended(live).sum())
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
        t_flops = flops / BF16_FLOP_PER_S
        by = "bytes" if t_bytes >= t_flops else "operations"
        return max(t_bytes, t_flops) * 1e3, by, kv_bytes + io_bytes, flops


def poisoned_layer(case, lengths=None):
    """The case's cache layer with NaN (bf16) or 0x7f (fp8 e4m3's NaN) in
    every block that no block table references and in every slot at or
    past its request's seq_len (or ``lengths``: kernel 3 reads no slot
    at or past pos_base), as a one-layer stack [1, N, 2, BS, Hkv*D]: the
    kernel on it must equal the plain version on the clean cache."""
    import torch

    bad = case.kv[case.layer].clone()
    fp8 = bad.dtype == torch.float8_e4m3fn
    raw = bad.view(torch.uint8) if fp8 else bad
    nan = 0x7f if fp8 else float("nan")
    bt = case.block_tables.cpu().numpy()
    used = np.zeros(bad.shape[0], bool)
    for r, s in enumerate(case.seq_np if lengths is None else lengths):
        n = -(-int(s) // BS)
        used[bt[r, :n]] = True
        if n and s % BS:
            raw[int(bt[r, n - 1]), :, int(s % BS):] = nan
    raw[torch.from_numpy(~used).cuda()] = nan
    return bad[None]


def run_poisoned(case, schedule, fn_plain, qb):
    """The ragged kernel on :func:`poisoned_layer` against the plain
    version on the clean cache."""
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    bad = poisoned_layer(case)
    scale = case.kv_scale[case.layer:case.layer + 1]

    def kern():
        return ra.ragged_paged_attention_kernel(
            case.q, bad, case.positions, case.req_idx, case.block_tables,
            case.seq_lens, qb=qb, schedule=schedule, kv_scale=scale, layer=0)

    name = case.name
    case.name = f"poisoned {name}"
    res = run_case(case, kern, fn_plain)
    case.name = name
    return res


def run_poisoned_grouped(case, fn_plain, qlen, pos_base, inject=None,
                         paged=False):
    """Kernel 2 (kernel 3 with ``inject``: knew, vnew and slot_mapping;
    kernel 4 with ``paged``) on :func:`poisoned_layer` against the plain
    version on the clean cache; kernel 3's layer is poisoned from
    pos_base on (the new rows' slots are not written yet)."""
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    bad = poisoned_layer(case, None if inject is None
                         else pos_base.cpu().numpy())
    scale = case.kv_scale[case.layer:case.layer + 1]
    fn = (ra.decode_paged_attention_kernel if paged
          else ra.grouped_decode_attention_kernel)

    def kern():
        return fn(case.q, bad, pos_base, case.block_tables, case.seq_lens,
                  qlen=qlen, kv_scale=scale, layer=0, **(inject or {}))

    name = case.name
    case.name = f"poisoned {'decode_paged ' if paged else ''}{name}"
    res = run_case(case, kern, fn_plain)
    case.name = name
    return res


def row_invariance(case, qlen, pos_base, paged=False) -> dict:
    """Kernel 2's (``paged``: kernel 4's) rows against qlen-1 launches,
    bit for bit: row j of each sequence of the qlen-``qlen`` step against
    the single row of a qlen-1 step at pos_base + j (the same query, the
    same slots)."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    fn = (ra.decode_paged_attention_kernel if paged
          else ra.grouped_decode_attention_kernel)

    def grouped(q, pb, sl, ql):
        return fn(q, case.kv, pb, case.block_tables, sl, qlen=ql,
                  kv_scale=case.kv_scale, layer=case.layer)

    out = grouped(case.q, pos_base, case.seq_lens, qlen)
    live = case.seq_lens > 0
    bad = 0
    for j in range(qlen):
        one = grouped(case.q[j::qlen].contiguous(), pos_base + j,
                      torch.where(live, pos_base + j + 1, 0), 1)
        same = (out[j::qlen].view(torch.int16) == one.view(torch.int16))
        bad += int((~same.flatten(1).all(1)).sum())
    torch.cuda.synchronize()
    res = dict(case=case.name, kernel=4 if paged else 2,
               rows=int(case.q.shape[0]), rows_not_bitwise_equal=bad,
               ok=bad == 0)
    log("  row invariance " + json.dumps(res))
    return res


def sass_text(lib) -> str:
    """The library's SASS (``cuobjdump -sass``); raises if the tool is
    missing."""
    from arcticinference_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        raise AssertionError(f"cuobjdump not found beside nvcc ({tool})")
    return subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def hgmma_counts(lib) -> dict:
    """HGMMA (wgmma) instructions in each instance of the quantized
    matmul kernel (kernels 5, 6 and 8: weight format, x rows per CTA,
    warpgroups along N and along K), read from the library's SASS."""
    import re

    counts, fn = {}, None
    for line in sass_text(lib).splitlines():
        if "Function :" in line:
            m = re.search(r"qmm_wgmma_kernelI\w*?\d(F16TrickE4M3|"
                          r"BitTrickE4M3|E4M3|Int8|Int4)ELi(\d+)ELi(\d+)"
                          r"ELi(\d+)E", line)
            fn = (f"{m.group(1)} BM={m.group(2)} WGS={m.group(3)} "
                  f"KW={m.group(4)}" if m else None)
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def hmma_counts(lib) -> dict:
    """HMMA (tensor-core) instructions in each instance of the ragged
    kernel (kernel 1), the grouped kernel (kernels 2 and 3) and the
    page-range decode kernel (kernel 4), read from the library's SASS
    with ``cuobjdump -sass``; raises if the tool is missing."""
    import re

    counts, fn = {}, None
    for line in sass_text(lib).splitlines():
        if "Function :" in line:
            m = re.search(r"(ragged_attention|grouped_decode|decode_range)"
                          r"_kernelINS_\d+"
                          r"(\w+?)ELi(\d+)E(?:Li(\d+)E)?", line)
            fn = (f"{m.group(1)} {m.group(2)}, D={m.group(3)}"
                  + (f", tiles={m.group(4)}" if m.group(4) else "")
                  if m else None)
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


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


def run_paged(case, fn_plain, qlen, pos_base, fn_kernel2, iters_plain=3):
    """Kernel 4 on the case against its plain version, with kernel 2's
    time, both wrappers' host microseconds a call and kernel 4's relative
    difference from kernel 2 on the same step."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    def kern4():
        return ra.decode_paged_attention_kernel(
            case.q, case.kv, pos_base, case.block_tables, case.seq_lens,
            qlen, kv_scale=case.kv_scale, layer=case.layer)

    name = case.name
    case.name = f"decode_paged {name}"
    res = run_case(case, kern4, fn_plain, iters_plain=iters_plain)
    case.name = name
    live = torch.from_numpy(case.req_np >= 0).cuda()
    a, b = kern4()[live].float(), fn_kernel2()[live].float()
    res["vs_kernel2_rel_err"] = float((a - b).norm() / b.norm())
    res["kernel2_ms"] = cuda_time_ms(fn_kernel2, 20)
    res["host_us"] = host_time_us(kern4)
    res["kernel2_host_us"] = host_time_us(fn_kernel2)
    res["ok"] = res["ok"] and res["vs_kernel2_rel_err"] <= REL_TOL
    log(f"  kernel 4 vs kernel 2 on {name}: {res['ms']:.4f} ms against "
        f"{res['kernel2_ms']:.4f} ms, relative difference "
        f"{res['vs_kernel2_rel_err']:.3g}; host {res['host_us']:.1f} us "
        f"against {res['kernel2_host_us']:.1f} us a call")
    return res


def decode_step(case, qlen):
    """(pos_base, kernel 2 on the case, the plain version) of a uniform
    decode step whose sequences end at their seq_lens."""
    import torch

    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    pos_base = torch.clamp(case.seq_lens - qlen, min=0)

    def kern():
        return ra.grouped_decode_attention_kernel(
            case.q, case.kv, pos_base, case.block_tables, case.seq_lens,
            qlen=qlen, kv_scale=case.kv_scale, layer=case.layer)

    def plain():
        return ragged_paged_attention_reference(
            case.q, case.kv[case.layer], case.positions, case.req_idx,
            case.block_tables, case.seq_lens,
            kv_scale=case.kv_scale[case.layer])

    return pos_base, kern, plain


def phase_kernels(rng, hq=HQ, hkv=HKV, layers=LAYERS, prefix="",
                  long_context=True):
    """The attention kernels against their plain versions at ``hq`` q
    heads over ``hkv`` (Llama-3.1-8B's by default; Qwen2.5-7B's group 7
    with ``prefix`` "g7 "), in a ``layers``-layer cache, bf16 and fp8 KV:
    the ragged kernel on a mixed step (also poisoned) and a 2048-token
    prefill chunk at qb 8 and 32; kernels 2 and 4 on B=64 decode steps at
    qlen 1, 4 and 8, also poisoned, their rows bit for bit against qlen-1
    launches; with ``long_context`` both on B=8 steps at 16384-32768
    tokens.  Returns (ragged, grouped, paged, invariance) cases."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)

    ragged_cases, grouped_cases, paged_cases, invariance = [], [], [], []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        # Mixed step: two prefill chunks and 32 decode rows at contexts
        # up to 4096, padded to the 2048-token bucket.
        decode = [(int(c), 1) for c in rng.integers(128, 4096, 32)]
        mixed = [(0, 512), (1024, 1024)] + decode
        for name, reqs, t_pad in (
                (f"{prefix}mixed 512+1024+32dec {dt}", mixed, 2048),
                (f"{prefix}prefill 2048@ctx2048 {dt}", [(2048, 2048)],
                 2048)):
            case = Case(name, reqs, kv_dtype, rng, t_pad=t_pad, hq=hq,
                        hkv=hkv, layers=layers)
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
            if "mixed" in name:
                ragged_cases.append(run_poisoned(case, sched, plain, qb))
            del case
            torch.cuda.empty_cache()
        # Pure decode: B=64 slots, 6 dead, contexts 128-4096; qlen 4 is
        # the drafter's fused step, qlen 8 the suffix loop's wide step.
        for qlen in (1, 4, 8):
            ctx = rng.integers(128, 4096, 64)
            dead = rng.choice(64, 6, replace=False)
            reqs = [(0, 0) if r in dead else (int(ctx[r]), qlen)
                    for r in range(64)]
            case = Case(f"{prefix}decode B=64 qlen={qlen} {dt}", reqs,
                        kv_dtype, rng, t_pad=64 * qlen, slot_rows=qlen,
                        hq=hq, hkv=hkv, layers=layers)
            pos_base, kern, plain = decode_step(case, qlen)
            grouped_cases.append(run_case(case, kern, plain))
            grouped_cases.append(run_poisoned_grouped(case, plain, qlen,
                                                      pos_base))
            if qlen > 1:
                invariance.append(row_invariance(case, qlen, pos_base))

            # Kernel 4 (one CTA per sequence, kv head and page range) on
            # the same step.
            paged_cases.append(run_paged(case, plain, qlen, pos_base, kern))
            paged_cases.append(run_poisoned_grouped(case, plain, qlen,
                                                    pos_base, paged=True))
            if qlen > 1:
                invariance.append(row_invariance(case, qlen, pos_base,
                                                 paged=True))
            del case, kern, plain
            torch.cuda.empty_cache()
    # Long contexts: B=8 at 16384-32768 tokens (one slot dead) in a
    # one-layer cache of 8192 pages; kernels 4 and 2 side by side.
    for kv_dtype in ((torch.bfloat16, torch.float8_e4m3fn)
                     if long_context else ()):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        for qlen in (1, 8):
            ctx = rng.integers(16384, 32769, 8)
            dead = int(rng.integers(0, 8))
            reqs = [(0, 0) if r == dead else (int(ctx[r]), qlen)
                    for r in range(8)]
            case = Case(f"decode B=8 ctx 16k-32k qlen={qlen} {dt}", reqs,
                        kv_dtype, rng, t_pad=8 * qlen, slot_rows=qlen,
                        layer=0, layers=1, n_blocks=LONG_CTX_PAGES)
            pos_base, kern, plain = decode_step(case, qlen)
            grouped_cases.append(run_case(case, kern, plain, iters_plain=1))
            paged_cases.append(run_paged(case, plain, qlen, pos_base, kern,
                                         iters_plain=1))
            paged_cases.append(run_poisoned_grouped(case, plain, qlen,
                                                    pos_base, paged=True))
            if qlen > 1:
                invariance.append(row_invariance(case, qlen, pos_base,
                                                 paged=True))
            del case, kern, plain
            torch.cuda.empty_cache()
    failed = [c["case"] for c in ragged_cases + grouped_cases + paged_cases
              + invariance if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return ragged_cases, grouped_cases, paged_cases, invariance


def phase_swift_kernels(rng):
    """The ragged kernel on SwiftKV's swift half, bf16 and fp8 KV: 16
    requests with one sample row each at contexts 128-2048 beside 4
    requests with 4 verify rows each, 32 rows (the sample-row bucket), on
    the runner's 8-row schedule over the sample rows
    (``engine.runner.swift_schedule``); also on the poisoned cache."""
    import torch

    from arcticinference_tpu_torch.engine.runner import swift_schedule
    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    cases = []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        reqs = ([(int(c), 1) for c in rng.integers(128, 2049, 16)]
                + [(int(c), 4) for c in rng.integers(128, 2049, 4)])
        case = Case(f"swift half 16x1+4x4 ctx128-2048 {dt}", reqs, kv_dtype,
                    rng, t_pad=32)
        arrays = swift_schedule(
            [n for _, n in reqs], np.array([c + n - 1 for c, n in reqs]),
            case.t, BS)
        sched = tuple(torch.from_numpy(arrays[f"swift_{k}"]).cuda()
                      for k in ("item_req", "item_qstart", "item_qlen",
                                "item_pages", "item_pos_base", "token_item",
                                "token_off"))

        def kern(case=case, sched=sched):
            return ra.ragged_paged_attention_kernel(
                case.q, case.kv, case.positions, case.req_idx,
                case.block_tables, case.seq_lens, qb=8, schedule=sched,
                kv_scale=case.kv_scale, layer=case.layer)

        def plain(case=case):
            return ragged_paged_attention_reference(
                case.q, case.kv[case.layer], case.positions, case.req_idx,
                case.block_tables, case.seq_lens,
                kv_scale=case.kv_scale[case.layer])

        cases.append(run_case(case, kern, plain))
        cases.append(run_poisoned(case, sched, plain, 8))
        del case
        torch.cuda.empty_cache()
    failed = [c["case"] for c in cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return cases


def phase_deferred_kernels(rng):
    """Kernel 3 (grouped decode with injected rows) against its plain
    version, and kernel 2 on the same step with the rows written into the
    cache, at the fused loop's shapes: B=64, qlen 1 (narrow) and 8 (wide),
    contexts 128-2048, 6 dead slots and 8 with slot -1 tails; bf16 and
    fp8 KV.  Returns (kernel 3 cases, kernel 2 cases)."""
    import torch

    from arcticinference_tpu_torch.ops.attention import (
        grouped_decode_deferred_reference, ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    deferred, grouped = [], []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        for qlen in (1, 8):
            ctx = rng.integers(128, 2049, 64)
            dead = set(rng.choice(64, 6, replace=False).tolist())
            reqs = [(0, 0) if r in dead else (int(ctx[r]), qlen)
                    for r in range(64)]
            live = [r for r in range(64) if r not in dead]
            tails = {r: int(rng.integers(1, qlen)) for r in live[:8]} \
                if qlen > 1 else {r: 1 for r in live[:8]}
            case = DeferredCase(f"deferred B=64 qlen={qlen} {dt}", reqs,
                                qlen, tails, kv_dtype, rng)
            ks = case.kv_scale[case.layer:case.layer + 1]

            def kern(case=case, qlen=qlen):
                return ra.grouped_decode_attention_kernel(
                    case.q, case.kv, case.pos_base, case.block_tables,
                    case.seq_lens, qlen=qlen, kv_scale=case.kv_scale,
                    layer=case.layer, knew=case.knew, vnew=case.vnew,
                    slot_mapping=case.slot_mapping)

            def plain(case=case, qlen=qlen):
                return grouped_decode_deferred_reference(
                    case.q, case.kv[case.layer], case.pos_base,
                    case.block_tables, case.seq_lens, qlen, case.knew,
                    case.vnew, case.slot_mapping,
                    kv_scale=case.kv_scale[case.layer])

            res = run_case(case, kern, plain)
            poisoned = run_poisoned_grouped(
                case, plain, qlen, case.pos_base, inject=dict(
                    knew=case.knew, vnew=case.vnew,
                    slot_mapping=case.slot_mapping))
            # The same step without deferral: kernel 2 over the cache
            # with the rows written (one layer), causal.
            written = case.written[None]

            def kern2(case=case, qlen=qlen, written=written, ks=ks):
                return ra.grouped_decode_attention_kernel(
                    case.q, written, case.pos_base, case.block_tables,
                    case.seq_lens, qlen=qlen, kv_scale=ks, layer=0)

            def plain2(case=case, ks=ks):
                return ragged_paged_attention_reference(
                    case.q, case.written, case.positions, case.req_idx,
                    case.block_tables, case.seq_lens, kv_scale=ks[0])

            # Rows of real slots must agree between the two paths.
            real = torch.from_numpy(case.slot_np >= 0).cuda()
            a, b = kern()[real].float(), kern2()[real].float()
            res["vs_kernel2_rel_err"] = float((a - b).norm() / b.norm())
            res["ok"] = res["ok"] and res["vs_kernel2_rel_err"] <= REL_TOL
            log(f"  deferred vs kernel 2 on the written cache: relative "
                f"error {res['vs_kernel2_rel_err']:.3g}")
            case.name = f"decode B=64 qlen={qlen} rows written {dt}"
            case.deferred = False
            grouped.append(run_case(case, kern2, plain2))
            deferred += [res, poisoned]
            del case, written
            torch.cuda.empty_cache()
    failed = [c["case"] for c in deferred + grouped if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return deferred, grouped


def phase_tree_kernels(rng):
    """The ragged kernel's tree-mask path against the plain version on
    two verify steps, in bf16 and with fp8 KV."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)

    cases = []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        trees = [(int(c), 1, TREE_PARENTS)
                 for c in rng.integers(896, 1153, 16)]
        for name, reqs, t_pad in (
                (f"tree verify 16x(1+{TREE_NODES})@ctx~1024 {dt}", trees, 512),
                (f"prefill 512 + 15 trees {dt}",
                 [(0, 512, None)] + trees[:15], 1024)):
            case = TreeCase(name, reqs, kv_dtype, rng, t_pad)
            sched = case.schedule(32)

            def kern(case=case, sched=sched):
                return ra.ragged_paged_attention_kernel(
                    case.q, case.kv, case.positions, case.req_idx,
                    case.block_tables, case.seq_lens, qb=32, schedule=sched,
                    kv_scale=case.kv_scale, layer=case.layer)

            def plain(case=case):
                return ragged_paged_attention_reference(
                    case.q, case.kv[case.layer], case.positions,
                    case.req_idx, case.block_tables, case.seq_lens,
                    kv_scale=case.kv_scale[case.layer],
                    tree_start=case.tree_start, row_tree_mask=case.row_mask)

            case.name = f"{name} qb=32"
            cases.append(run_case(case, kern, plain))
            if name.startswith("tree verify"):
                cases.append(run_poisoned(case, sched, plain, 32))
            del case
            torch.cuda.empty_cache()
    failed = [c["case"] for c in cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return cases


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


def matmul_replay(mode, k, n, m, gen, parts=None) -> dict:
    """Kernel 5 (fp8) or 6 (int4) on one [k, n] weight at m rows, bit for
    bit: every moved row of a launch against the same x row at another
    index of a launch whose other rows are fresh random rows; two
    launches alike; a CUDA graph of one launch, replayed twice, alike the
    eager launch.  ``parts``: the weight fused from parts of these widths
    (per-column scales)."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im

    q = quantized_weight(mode, k, n, parts, gen)
    kernel = (im.int4_matmul_kernel if mode == "int4"
              else fm.fp8_matmul_kernel)

    def launch(x):
        return kernel(x, q.weight, q.scale)

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    x2 = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    moves = {j: (j + m // 2 + 3) % m for j in range(0, m, max(1, m // 16))}
    for j, j2 in moves.items():
        x2[j2] = x[j]
    out, out2, again = launch(x), launch(x2), launch(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(x)                           # warm up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(x)
    replays = []
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(captured, out)))
    k_tiles = (k // 2 if mode == "int4" else k) // fm.BKW
    res = dict(case=f"{mode} [{k},{n}]{' fused' if parts else ''} M={m}",
               plan=list(fm.launch_plan(m, n, k_tiles, fm.sm_count(0))),
               rows_moved=len(moves),
               rows_not_bitwise_equal=sum(
                   not torch.equal(out2[j2], out[j])
                   for j, j2 in moves.items()),
               launches_equal=bool(torch.equal(again, out)),
               graph_replays_equal=replays)
    res["ok"] = (res["rows_not_bitwise_equal"] == 0
                 and res["launches_equal"] and all(replays))
    log("  replay " + json.dumps(res))
    del graph, q
    return res


# Bitwise replay checks of kernels 5 and 6 (mode, K, N, rows): the bench's
# decode step at 64 rows (wo split over a cluster, w_gateup one
# warpgroup per CTA), w_down at 16, wqkv at 256 verify rows (K
# warpgroups, two row tiles), w_gateup at a 2048-row prefill (two
# warpgroups side by side).
MATMUL_REPLAY = (("fp8", 4096, 4096, 64), ("fp8", 4096, 28672, 64),
                 ("fp8", 14336, 4096, 16), ("fp8", 4096, 6144, 256),
                 ("fp8", 4096, 28672, 2048), ("int4", 4096, 4096, 64),
                 ("int4", 4096, 28672, 64), ("int4", 4096, 28672, 2048),
                 # The Qwen plans: w_down's K of 18944 and 12288 at 16
                 # rows, Qwen2.5's wqkv and w_gateup at 64 and 2048.
                 ("fp8", 18944, 3584, 16), ("fp8", 12288, 4096, 16),
                 ("fp8", 3584, 4608, 64), ("fp8", 3584, 37888, 2048))
# ... and SwiftKV's fused KV operand at its three row counts.
SWIFT_REPLAY = tuple(("fp8", 4096, SWIFT_KV_SHAPE[2], m)
                     for m in SWIFT_KV_ROWS)


def phase_matmul_kernels(seed):
    """Both quantized matmul kernels against their plain versions at the
    Llama-3.1-8B weight shapes, kernel 5 at the Qwen ones
    (:data:`QWEN_MATMUL_SHAPES`) and on SwiftKV's fused KV operand
    (:data:`SWIFT_KV_SHAPE`), then :func:`matmul_replay` on
    :data:`MATMUL_REPLAY` and :data:`SWIFT_REPLAY`; returns (fp8/int8 cases, int4 cases, replay
    checks)."""
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
    for name, k, n, parts, f32 in QWEN_MATMUL_SHAPES:
        q = quantized_weight("fp8", k, n, parts, gen)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        for m in QWEN_MATMUL_ROWS:
            if f32 and m > 64:
                continue
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            fp8_cases.append(run_matmul_case(
                f"fp8 {name} [{k},{n}] M={m}", q, x, out_dtype,
                fm.fp8_matmul_kernel, fm.fp8_matmul_reference))
        del q
        torch.cuda.empty_cache()
    name, k, n, parts, _ = SWIFT_KV_SHAPE
    q = quantized_weight("fp8", k, n, parts, gen)
    for m in SWIFT_KV_ROWS:
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        fp8_cases.append(run_matmul_case(
            f"fp8 {name} [{k},{n}] M={m}", q, x, torch.bfloat16,
            fm.fp8_matmul_kernel, fm.fp8_matmul_reference))
    del q
    torch.cuda.empty_cache()
    for mode in ("fp8", "int8"):
        for name, k, n in DRAFTER_MATMULS:
            q = quantized_weight(mode, k, n, None, gen)
            for m in DRAFTER_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                fp8_cases.append(run_matmul_case(
                    f"{mode} drafter {name} [{k},{n}] M={m}", q, x,
                    torch.float32, fm.fp8_matmul_kernel,
                    fm.fp8_matmul_reference))
            del q
            torch.cuda.empty_cache()
    failed = [c["case"] for c in fp8_cases + int4_cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    replay = [matmul_replay(*case, gen) for case in MATMUL_REPLAY]
    replay += [matmul_replay(*case, gen, parts=SWIFT_KV_SHAPE[3])
               for case in SWIFT_REPLAY]
    torch.cuda.empty_cache()
    failed = [c["case"] for c in replay if not c["ok"]]
    if failed:
        raise AssertionError(f"rows or replays not bit for bit: {failed}")
    return fp8_cases, int4_cases, replay


def phase_probe_kernel(seed):
    """Kernel 7, the HBM read probe, on the full 4 GiB buffer of seeded
    N(0, 1) bf16 values (zeros would not see a row summed twice or
    skipped) against its plain version; returns its case."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp

    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = hp.probe_buffer("cuda", generator=gen)
    out = hp.hbm_read_probe(buf)
    ref = hp.hbm_read_probe_reference(buf)
    # Float32 sums of the same values in another order: within 1e-6 of
    # the sum of their magnitudes (one row more or fewer moves the sum by
    # ~11, the rows' own size).
    l1 = float(buf.reshape(buf.shape[0], -1)[:, :hp.ROW_ELEMS].float()
               .abs().sum())
    err = float((out - ref).abs().max())
    tol = 1e-6 * l1
    ms = cuda_time_ms(lambda: hp.hbm_read_probe(buf), iters=5)
    plain_ms = cuda_time_ms(lambda: hp.hbm_read_probe_reference(buf),
                            iters=3, warmup=1)
    library_ms = cuda_time_ms(lambda: torch.sum(buf, dtype=torch.float32),
                              iters=5)
    nbytes = buf.numel() * 2 + 4
    res = dict(case=f"read {buf.numel() * 2 / 2 ** 30:.0f} GiB "
                    f"{tuple(buf.shape)} bf16",
               max_abs_err=err, tol=tol, value=float(out.item()),
               plain_value=float(ref.item()), rel_err=err / max(l1, 1e-30),
               ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=library_ms,
               library_note="torch.sum(x, dtype=float32): a full read of "
                            "the same bytes, another sum",
               gbps=nbytes / ms / 1e6, bytes=nbytes, flops=0.0)
    res["ok"] = bool(np.isfinite(err)) and err <= tol
    log("  case " + json.dumps(res))
    del buf
    free_cuda_memory()
    if not res["ok"]:
        raise AssertionError(f"probe disagrees with plain version: {res}")
    return [res]


def phase_stream_kernels(seed):
    """Kernel 8's four variants at the five 8B decode shapes (64 rows)
    against their plain versions; each timed on copies that cycle past
    the L2, beside ``fp8_matmul_kernel`` with a unit scale on the same
    bytes and one ``torch.mm`` on the bf16-dequantized weight."""
    import torch

    from arcticinference_tpu_torch.benchmarks import stream_microbench as smb
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    unit = torch.ones(1, dtype=torch.float32, device="cuda")
    cases = []
    for label, k, n in smb.SHAPES:
        x = torch.randn((smb.M, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        ws = {key: w[0] for key, w in smb.weights(k, n, gen, 1).items()}
        for variant in sm.VARIANTS:
            w = ws[smb.WEIGHT_OF[variant]]
            out = sm.stream_matmul_kernel(x, w, variant)
            ref = sm.stream_matmul_reference(x, w, variant)
            torch.cuda.synchronize()
            o, r = out.float(), ref.float()
            diff = (o - r).abs()
            bad = int((diff > ATOL + RTOL * r.abs()).sum())
            err = float(diff.max())
            rel = float((o - r).norm() / r.norm())
            copies = rotating(w, w.nbytes)
            ms = cuda_time_ms(
                lambda: sm.stream_matmul_kernel(x, next(copies), variant),
                iters=20)
            plain_ms = cuda_time_ms(
                lambda: sm.stream_matmul_reference(x, w, variant), iters=3,
                warmup=1)
            q = w.view(torch.float8_e4m3fn) if variant in (
                "f16trick", "bittrick") else w
            k5 = rotating(q, q.nbytes)
            k5_ms = cuda_time_ms(
                lambda: fm.fp8_matmul_kernel(x, next(k5), unit,
                                             torch.bfloat16), iters=20)
            dense = rotating(sm.dequant(w, variant).to(torch.bfloat16),
                             2 * w.nbytes)
            library_ms = cuda_time_ms(lambda: torch.mm(x, next(dense)),
                                      iters=20)
            del copies, k5, dense
            nbytes = w.nbytes + x.nbytes + out.nbytes
            flops = 2.0 * smb.M * n * k
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_flops = flops / BF16_FLOP_PER_S
            res = dict(case=f"{variant} {label} [{k},{n}] M={smb.M}",
                       max_abs_err=err, atol=ATOL, rtol=RTOL,
                       n_out_of_tol=bad, rel_err=rel, rel_tol=REL_TOL,
                       ref_max_abs=float(r.abs().max()), ms=ms,
                       plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_flops) * 1e3,
                       bound_by=("bytes" if t_bytes >= t_flops
                                 else "operations"),
                       library_ms=library_ms,
                       kernel5_unit_scale_ms=k5_ms, bytes=nbytes,
                       flops=flops)
            res["ok"] = (bad == 0 and rel <= REL_TOL
                         and bool(torch.isfinite(o).all()))
            log("  case " + json.dumps(res))
            cases.append(res)
        del ws, x
        free_cuda_memory()
    failed = [c["case"] for c in cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return cases


# ---------------------------------------------------------------------------
# Phase 4: 2-layer full-width forward, kernels against plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_matmuls():
    """Run the decoder's matmuls (``models/llama.py``, whose layers the
    Qwen and SwiftKV modules share) through the kernels' plain
    versions."""
    from arcticinference_tpu_torch.models import llama
    from arcticinference_tpu_torch.ops import fp8

    saved = llama.matmul
    llama.matmul = fp8.matmul_reference
    try:
        yield
    finally:
        llama.matmul = saved


def reset_counts() -> None:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    ra.reset_launch_counts()
    fm.reset_launch_counts()
    im.reset_launch_counts()
    hp.reset_launch_counts()
    sm.reset_launch_counts()


def launch_counts() -> dict:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    return {"ragged_paged_attention_kernel": ra.ragged_attention_launches,
            "ragged_paged_attention_kernel (tree mask)":
                ra.tree_attention_launches,
            "grouped_decode_attention_kernel": ra.grouped_decode_launches,
            "grouped_decode_attention_kernel (deferred KV)":
                ra.deferred_decode_launches,
            "decode_paged_attention_kernel": ra.decode_paged_launches,
            "fp8_matmul_kernel": fm.fp8_matmul_launches,
            "int4_matmul_kernel": im.int4_matmul_launches,
            "hbm_read_probe": hp.hbm_probe_launches,
            "stream_matmul_kernel": sm.stream_matmul_launches}


def matmul_launches_per_step(arch) -> int:
    """Quantized matmul launches of one forward: wqkv, wo, w_gateup and
    w_down per layer and the LM head; SwiftKV's later layers launch wq in
    place of wqkv, and its fused KV operand one more."""
    return 4 * arch.num_layers + 1 + int(
        getattr(arch, "num_swift_layers", 0) > 0)


def phase_forward(rng, quantization=None, model="llama-3.1-8b"):
    """``model``'s full width (:data:`MODELS`) at 2 layers: a prefill, a
    decode and a token-tree verify step through ``forward`` with the
    kernels and with the plain versions; logits compared.  SwiftKV at 4
    layers (2 + 2), no tree step (trees do not compose with it): a
    prefill whose sample rows end the chunks (the third prompt chunked),
    a mixed step (its rest beside two decode rows), a pure decode step;
    logits and caches compared."""
    import torch

    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)
    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.runner import ModelRunner
    from arcticinference_tpu_torch.engine.scheduler import Scheduler
    from arcticinference_tpu_torch.models.loader import load_model

    arch_name, dims = MODELS[model]
    swift = arch_name == "llama_swiftkv"
    layers = ({"num_hidden_layers": 4, "num_key_value_layers": 2} if swift
              else {"num_hidden_layers": 2})
    cfg = EngineConfig(
        model=ModelConfig(model=arch_name, dtype="bfloat16",
                          max_model_len=4096,
                          hf_overrides={**dims, **layers},
                          quantization=quantization),
        cache=CacheConfig(num_blocks=256),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048))
    dev = torch.device("cuda")
    module, arch, params = load_model(cfg.model, dev)
    runner = ModelRunner(cfg, module, arch, params, dev)
    sched = Scheduler(cfg.scheduler, cfg.cache, runner.num_blocks)
    for i, n in enumerate((1200, 600, 900) if swift
                          else (200, 500, 1000, 300)):
        sched.add_request(Request(
            f"f{i}", [int(x) for x in rng.integers(0, arch.vocab_size, n)],
            SamplingParams(max_tokens=4)))
    matmul_key = {"fp8": "fp8_matmul_kernel",
                  "int4": "int4_matmul_kernel"}.get(quantization)
    tree_key = "ragged_paged_attention_kernel (tree mask)"
    results = []
    for step in (("prefill", "mixed", "decode") if swift
                 else ("prefill", "decode", "tree verify")):
        if step == "tree verify":
            # Each request verifies a 12-node draft tree next.
            for i, req in enumerate(sched.running):
                req.spec_token_ids = [int(x) for x in rng.integers(
                    0, arch.vocab_size, 12)]
                req.spec_parents = _best_first_parents(i, 12)
        out = sched.schedule()
        si = runner.prepare_inputs(out)
        inputs = runner.upload(si.arrays)
        inputs["kv_scale"] = runner.kv_scale
        logits, launches, caches = {}, {}, {}
        n_rows = sum(si.sample_row_count)
        with torch.inference_mode():
            for name in ("kernel", "plain"):
                kv = runner.kv.clone()
                reset_counts()
                with (contextlib.nullcontext() if name == "kernel"
                      else plain_matmuls()):
                    attn = (module.make_attn_impl(si.attn_qb)
                            if name == "kernel" else module.plain_attn)
                    kv, h = module.forward(runner.params, arch, kv,
                                           dict(inputs), attn_impl=attn)
                    rows = (h[:n_rows] if runner.returns_rows else
                            h[inputs["logits_indices"].long()[:n_rows]])
                    logits[name] = module.compute_logits(runner.params, rows)
                torch.cuda.synchronize()
                launches[name] = launch_counts()
                caches[name] = kv
        runner.kv = caches["kernel"]
        a, b = logits["kernel"], logits["plain"]
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = a.argmax(-1) == b.argmax(-1)
        # A row whose top two plain logits are within twice the largest
        # difference is a near tie: its argmax may flip either way.
        top2 = b.topk(2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
        finite = bool(torch.isfinite(a).all())
        # The caches but block 0 (the padding rows' slot -1 writes).
        ck, cp = (caches[n][:, 1:].float() for n in ("kernel", "plain"))
        cache_rel = float((ck - cp).norm() / cp.norm())
        res = dict(model=model, step=step, quantization=quantization,
                   attn_qb=si.attn_qb, rows=a.shape[0], vocab=a.shape[1],
                   max_abs_diff=diff, max_abs_logit=scale,
                   argmax_agree=float(agree.float().mean()),
                   near_tie_rows=int(near_tie.sum()), finite=finite,
                   cache_rel_diff=cache_rel,
                   kernel_launches=launches["kernel"],
                   plain_launches=launches["plain"])
        del caches, ck, cp
        log("  forward " + json.dumps(res))
        # bf16 activations: each kernel output is rounded to bf16 on both
        # paths and their float32 sums differ in order, so one-ulp flips
        # (2^-8 relative) propagate through 2 layers and the LM head.
        # The cached K / V rows differ by one-ulp bf16 flips where the
        # layers' inputs did.
        ok = (finite and diff <= 0.05 * scale
              and bool((agree | near_tie).all())
              and cache_rel <= 2e-2
              and not any(launches["plain"].values()))
        if matmul_key is not None:
            ok = ok and launches["kernel"][matmul_key] == \
                matmul_launches_per_step(arch)
        if step == "decode":
            # Both halves of a pure decode step on the grouped kernel.
            ok = ok and si.attn_qb == 1 and launches["kernel"][
                "grouped_decode_attention_kernel"] == arch.num_layers
        elif swift:
            ok = ok and launches["kernel"][
                "ragged_paged_attention_kernel"] == arch.num_layers
        # Only the tree step goes through the tree-mask path, every layer.
        want_tree = arch.num_layers if step == "tree verify" else 0
        ok = ok and launches["kernel"][tree_key] == want_tree
        if not ok:
            raise AssertionError(f"forward kernel vs plain: {res}")
        for r, s in enumerate(out.scheduled):
            done = s.request.num_computed_tokens + s.num_new_tokens >= \
                s.request.num_tokens
            tok = int(a[si.sample_row_start[r]].argmax())
            sched.update_after_step(s, [tok] if done else [], 0)
        results.append(res)
    del runner, params
    free_cuda_memory()
    return results


def phase_forward_deferred(rng, quantization=None):
    """The fused loop's wide step shape at full width and 2 layers: B=16
    slots (12 requests at contexts 200-1500, 4 dead slots) x 8 verify
    rows through the grouped kernel, with ARCTIC_TPU_DEFERRED_KV on
    (kernel 3 in each layer, one bulk write after) and off (kernel 2
    after each layer's write), on copies of the cache.  Logits of the
    real rows are compared and the kernels' launches counted.  Caches:
    the bulk write must have stored exactly the rows kernel 3 attended,
    at their slots; nothing else may differ between the two runs outside
    the sink block 0 but the written slots of layers past the first,
    whose inputs carry the attention's rounding (the two kernels sum the
    new tokens in another order), and those within bf16 noise."""
    import os

    import torch

    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)
    from arcticinference_tpu_torch.engine.block_manager import BlockManager
    from arcticinference_tpu_torch.engine.runner import ModelRunner
    from arcticinference_tpu_torch.models.loader import load_model

    b, qlen = 16, 8
    cfg = EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16", max_model_len=4096,
                          hf_overrides={**LLAMA_8B, "num_hidden_layers": 2},
                          quantization=quantization),
        cache=CacheConfig(num_blocks=1024),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048))
    dev = torch.device("cuda")
    module, arch, params = load_model(cfg.model, dev)
    runner = ModelRunner(cfg, module, arch, params, dev)
    bm = BlockManager(runner.num_blocks, BS)
    ctx = [int(c) for c in rng.integers(200, 1501, 12)] + [0] * 4
    bt = np.zeros((b, runner.max_blocks_per_req), np.int32)
    for r, c in enumerate(ctx):
        if c:
            ids = []
            bm.grow_to(ids, c + qlen)
            bt[r, :len(ids)] = ids
    # The cache holds random K/V at every context slot (a prefill's
    # values are not the point here); one tail of 3 slot -1 rows.
    with torch.inference_mode():
        runner.kv.copy_((torch.randn(runner.kv.shape, device=dev) * 0.5
                         ).to(runner.kv.dtype))
    tokens = rng.integers(0, arch.vocab_size, b * qlen).astype(np.int32)
    pos = np.zeros(b * qlen, np.int32)
    slot = np.full(b * qlen, -1, np.int32)
    req = np.full(b * qlen, -1, np.int32)
    for r, c in enumerate(ctx):
        real = 0 if c == 0 else (qlen - 3 if r == 5 else qlen)
        for j in range(qlen):
            pos[r * qlen + j] = c + j
            if j < real:
                p = c + j
                slot[r * qlen + j] = bt[r, p // BS] * BS + p % BS
                req[r * qlen + j] = r
    seq_lens = np.array([c + qlen for c in ctx], np.int32)
    arrays = dict(input_ids=tokens, positions=pos, req_idx=req,
                  slot_mapping=slot, block_tables=bt, seq_lens=seq_lens)
    results = []
    logits, launches, caches = {}, {}, {}
    injected = []                     # (knew, vnew) per layer, flag on
    kernel = module.grouped_decode_attention_kernel

    def spy(*a, **k):
        if k.get("knew") is not None:
            injected.append((k["knew"].clone(), k["vnew"].clone()))
        return kernel(*a, **k)

    module.grouped_decode_attention_kernel = spy
    saved = os.environ.get("ARCTIC_TPU_DEFERRED_KV")
    try:
        for flag in ("1", "0"):
            os.environ["ARCTIC_TPU_DEFERRED_KV"] = flag
            inputs = {k: torch.from_numpy(v).to(dev)
                      for k, v in arrays.items()}
            inputs["kv_scale"] = runner.kv_scale
            kv = runner.kv.clone()
            reset_counts()
            with torch.inference_mode():
                kv, h = module.forward(
                    runner.params, arch, kv, inputs,
                    attn_impl=module.make_attn_impl(1, decode_qlen=qlen))
                live = torch.from_numpy(req >= 0).to(dev)
                logits[flag] = module.compute_logits(runner.params, h[live])
            torch.cuda.synchronize()
            launches[flag] = launch_counts()
            caches[flag] = kv
    finally:
        module.grouped_decode_attention_kernel = kernel
        if saved is None:
            os.environ.pop("ARCTIC_TPU_DEFERRED_KV", None)
        else:
            os.environ["ARCTIC_TPU_DEFERRED_KV"] = saved
    a, b_ = logits["1"], logits["0"]
    diff = float((a - b_).abs().max())
    scale = float(b_.abs().max())
    agree = a.argmax(-1) == b_.argmax(-1)
    top2 = b_.topk(2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
    # The written slots, as (block, offset) pairs.
    real = torch.from_numpy(slot >= 0).to(dev)
    sl = torch.from_numpy(slot).to(dev)[real].long()
    blk, off = sl // BS, sl % BS
    on, off_run = caches["1"], caches["0"]
    stored_injected = all(
        torch.equal(on[layer, blk, 0, off].view(torch.uint8),
                    kn[real].view(torch.uint8))
        and torch.equal(on[layer, blk, 1, off].view(torch.uint8),
                        vn[real].view(torch.uint8))
        for layer, (kn, vn) in enumerate(injected))
    layer0_identical = torch.equal(on[0, 1:].view(torch.uint8),
                                   off_run[0, 1:].view(torch.uint8))
    untouched = torch.ones(on.shape[1:4], dtype=torch.bool, device=dev)
    untouched[0] = False
    untouched[blk, :, off] = False
    rest_identical = torch.equal(on[:, untouched].view(torch.uint8),
                                 off_run[:, untouched].view(torch.uint8))
    written_on = on[:, blk, :, off].float()
    written_off = off_run[:, blk, :, off].float()
    written_diff = float((written_on - written_off).abs().max())
    written_max = float(written_off.abs().max())
    wrote = not torch.equal(on[:, 1:].view(torch.uint8),
                            runner.kv[:, 1:].view(torch.uint8))
    k3 = "grouped_decode_attention_kernel (deferred KV)"
    k2 = "grouped_decode_attention_kernel"
    res = dict(quantization=quantization, slots=b, qlen=qlen,
               rows=int(a.shape[0]), max_abs_diff=diff, max_abs_logit=scale,
               argmax_agree=float(agree.float().mean()),
               near_tie_rows=int(near_tie.sum()),
               finite=bool(torch.isfinite(a).all()),
               bulk_write_stored_the_injected_rows=stored_injected,
               layer0_cache_identical=layer0_identical,
               unwritten_slots_identical=rest_identical,
               written_slots_max_abs_diff=written_diff,
               written_slots_max_abs=written_max,
               step_wrote_the_cache=wrote,
               launches_deferred_on={k: launches["1"][k] for k in (k2, k3)},
               launches_deferred_off={k: launches["0"][k] for k in (k2, k3)})
    log("  forward deferred " + json.dumps(res))
    ok = (res["finite"] and diff <= 0.05 * scale
          and bool((agree | near_tie).all()) and wrote
          and len(injected) == arch.num_layers and stored_injected
          and layer0_identical and rest_identical
          and written_diff <= 0.02 * written_max
          and launches["1"][k3] == arch.num_layers
          and launches["1"][k2] == 0
          and launches["0"][k3] == 0
          and launches["0"][k2] == arch.num_layers)
    if not ok:
        raise AssertionError(f"deferred forward: {res}")
    results.append(res)
    del runner, params, caches, logits, injected, on, off_run
    free_cuda_memory()
    return results


# ---------------------------------------------------------------------------
# Phase 5: end to end through LLM.generate
# ---------------------------------------------------------------------------

def phase_generate(rng):
    """The same 16 requests at 32 layers in bf16, with suffix speculation
    (linear, then token trees) seeded from the bf16 run's output, then
    with fp8 and int4 weights; returns ({run name: result}, prompts)."""
    prompts = [[int(x) for x in rng.integers(0, LLAMA_8B["vocab_size"],
                                             int(n))]
               for n in rng.integers(128, 1025, 16)]
    runs = {}
    runs["bf16"], outs = run_generate(None, prompts, device_steps=True)
    ref = [o.token_ids for o in outs]
    for spec in ("suffix", "suffix tree", "suffix fused",
                 "suffix fused deferred"):
        runs[spec], _ = run_generate(None, prompts, spec=spec, reference=ref)
    # The Arctic drafters (random init, so few drafts are accepted): an
    # MLP drafter on the fused loop and on the synchronous step, an fp8
    # LSTM drafter on the fused loop, and MLP + suffix decoding there.
    with tempfile.TemporaryDirectory() as lstm_dir:
        Path(lstm_dir, "config.json").write_text(
            json.dumps({"method": "sum_lstm"}))
        for spec in DRAFTER_RUNS:
            runs[spec], _ = run_generate(None, prompts, spec=spec,
                                         reference=ref, lstm_dir=lstm_dir)
    for q in ("fp8", "int4"):
        runs[q], _ = run_generate(q, prompts, device_steps=q == "fp8")
    return runs, prompts


# SwiftKV's generate runs: (run name, weights, speculation).
SWIFT_RUNS = (("swiftkv bf16", None, None), ("swiftkv fp8", "fp8", None),
              ("swiftkv suffix", None, "suffix"),
              ("swiftkv suffix fused", None, "suffix fused"),
              ("swiftkv mlp fused", None, "mlp fused"),
              ("swiftkv all", None, "mlp suffix fused"))


def step_time(run, kind) -> dict:
    """A run's ``kind`` steps (``mixed`` or ``decode``): count, p50 and
    mean host milliseconds (each step ends in a device synchronisation)."""
    st = run["steps"].get(kind)
    if not st:
        return {}
    return dict(count=st["count"], p50_ms=st["p50_ms"],
                mean_ms=st["total_s"] / st["count"] * 1e3)


def phase_generate_swift(prompts, llama_runs):
    """``LLM.generate`` at the full width and depth of
    Llama-3.1-SwiftKV-8B (random weights) on the Llama runs' prompts,
    16 x 32 greedy tokens: bf16 and fp8, suffix decoding on the
    synchronous step and on the fused loop (seeded from the SwiftKV bf16
    run), an MLP drafter on the fused loop, and the all-combined config
    (MLP drafter + suffix decoding, fused).  Prints the mixed- and
    decode-step times beside the Llama-3.1-8B runs' from this process.
    Returns {run: result}."""
    runs = {}
    ref = None
    for name, q, spec in SWIFT_RUNS:
        runs[name], outs = run_generate(q, prompts, spec=spec, reference=ref,
                                        model="llama-3.1-swiftkv-8b",
                                        device_steps=spec is None)
        if ref is None:
            ref = [o.token_ids for o in outs]
    for q in ("bf16", "fp8"):
        lr, sr = llama_runs[q], runs[f"swiftkv {q}"]
        cmp = {"weights": q, "card": smi()}
        for kind in ("mixed", "decode"):
            a, b = step_time(lr, kind), step_time(sr, kind)
            cmp[kind] = {"llama-3.1-8b": a, "llama-3.1-swiftkv-8b": b}
            if a and b:
                cmp[kind]["swiftkv_over_llama_p50"] = b["p50_ms"] / a["p50_ms"]
                cmp[kind]["swiftkv_over_llama_mean"] = (b["mean_ms"]
                                                        / a["mean_ms"])
        # The same steps' device time (CUDA graphs), host enqueue apart.
        cmp["device_step_ms"] = {
            step: {"llama-3.1-8b": ms,
                   "llama-3.1-swiftkv-8b": sr["device_step_ms"][step],
                   "swiftkv_over_llama": sr["device_step_ms"][step] / ms}
            for step, ms in lr["device_step_ms"].items()}
        log("  swiftkv vs llama step times " + json.dumps(cmp))
        runs[f"swiftkv {q}"]["vs_llama"] = cmp
    return runs


# The penalties + logprobs run (Qwen3-8B, fp8): request i asks for the
# penalties when i % 4 < 2 and for 5 logprobs when i % 4 is even.
PENALTIES = dict(repetition_penalty=1.2, presence_penalty=0.5,
                 frequency_penalty=0.3)


@contextlib.contextmanager
def checked_penalties():
    """Hold every engine step's ``apply_penalties`` on the card against
    the plain computation of the same inputs on the CPU, bit for bit
    (float32 elementwise arithmetic, integer counts), and count the steps
    and the logits the penalties moved.  Yields the counts."""
    import torch

    from arcticinference_tpu_torch.engine import runner as runner_mod

    orig = runner_mod.apply_penalties
    seen = {"steps": 0, "moved_logits": 0, "not_bitwise_equal": 0}

    def checked(logits, *args):
        out = orig(logits, *args)
        cpu = orig(logits.cpu(), *(a.cpu() for a in args))
        seen["steps"] += 1
        seen["moved_logits"] += int((out != logits).sum())
        seen["not_bitwise_equal"] += int(not torch.equal(out.cpu(), cpu))
        return out

    runner_mod.apply_penalties = checked
    try:
        yield seen
    finally:
        runner_mod.apply_penalties = orig


def phase_generate_qwen(rng):
    """``LLM.generate`` at the full width and depth of Qwen2.5-7B (28
    layers, GQA group 7, q/k/v biases) and Qwen3-8B (36 layers, qk-norm),
    random weights: 16 requests x 32 greedy tokens in bf16 and in fp8
    (kernel 5 launched 4 x layers + 1 times a step), then Qwen3-8B in fp8
    with a quarter of the requests asking for penalties, a quarter for 5
    logprobs, a quarter for both: penalties applied on every step, moving
    logits, bit for bit as the plain version computes them on the CPU;
    each logprob list as long as the tokens, its top id the committed
    token; the requests without penalties giving the plain fp8 run's
    tokens.  Returns {run: result}."""
    from arcticinference_tpu_torch.engine.request import SamplingParams

    runs = {}
    for model in ("qwen2.5-7b", "qwen3-8b"):
        vocab = MODELS[model][1]["vocab_size"]
        prompts = [[int(x) for x in rng.integers(0, vocab, int(n))]
                   for n in rng.integers(128, 1025, 16)]
        for q in (None, "fp8"):
            runs[f"{model} {q or 'bf16'}"], plain = run_generate(
                q, prompts, model=model)
        if model != "qwen3-8b":
            continue
        sampling = [SamplingParams(max_tokens=32,
                                   logprobs=5 if i % 2 == 0 else None,
                                   **(PENALTIES if i % 4 < 2 else {}))
                    for i in range(16)]
        with checked_penalties() as pen:
            res, outs = run_generate("fp8", prompts, model=model,
                                     sampling=sampling)
        lp_ok = all(
            (o.logprobs is None) == (sp.logprobs is None)
            and (o.logprobs is None or (
                len(o.logprobs) == len(o.token_ids)
                and all(len(lp) == 5 and next(iter(lp)) == t
                        and all(np.isfinite(v) and v <= 0
                                for v in lp.values())
                        for lp, t in zip(o.logprobs, o.token_ids))))
            for o, sp in zip(outs, sampling))
        unpenalised_same = all(o.token_ids == p.token_ids
                               for i, (o, p) in enumerate(zip(outs, plain))
                               if i % 4 >= 2)
        res.update(penalty_steps=pen, logprobs_consistent=lp_ok,
                   unpenalised_match_plain_run=unpenalised_same,
                   penalised_match_plain_run=sum(
                       o.token_ids == p.token_ids
                       for i, (o, p) in enumerate(zip(outs, plain))
                       if i % 4 < 2),
                   first_logprobs=outs[0].logprobs[0])
        log("  penalties + logprobs " + json.dumps(
            {k: res[k] for k in ("penalty_steps", "logprobs_consistent",
                                 "unpenalised_match_plain_run",
                                 "penalised_match_plain_run",
                                 "first_logprobs")}))
        # Penalties on the steps that hold a penalised request, moving
        # logits, as the plain version computes them.
        if not (lp_ok and unpenalised_same
                and 0 < pen["steps"] <= res["engine_steps"]
                and pen["moved_logits"] > 0
                and pen["not_bitwise_equal"] == 0):
            raise AssertionError(f"penalties / logprobs run failed: {res}")
        runs[f"{model} fp8 penalties logprobs"] = res
    return runs


def phase_profile(rng) -> None:
    """Profiled runs, last of the script, on engines of their own: no
    timed run follows a profiled run in the same process."""
    for q in (None, "fp8"):
        log("  profile " + json.dumps(dict(quantization=q,
                                           **profile_run(q, rng))))
    with tempfile.TemporaryDirectory() as lstm_dir:
        Path(lstm_dir, "config.json").write_text(
            json.dumps({"method": "sum_lstm"}))
        for spec in ("mlp fused", "lstm fp8 fused"):
            log("  profile chain " + json.dumps(
                profile_drafter_chain(spec, lstm_dir)))
    log("  profile device step " + json.dumps(profile_device_step()))


def profile_device_step(batch: int = 64, ctx: int = 192,
                        replays: int = 10) -> dict:
    """Device time by kernel of the bench's decode step (fp8 Llama-3.1-8B
    at (``batch``, ``ctx``), the CUDA graph the bench times) over
    ``replays`` replays under ``torch.profiler``: where the device step's
    time goes.  A measurement, not a check: an empty trace reads "not
    measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arcticinference_tpu_torch import bench
    from arcticinference_tpu_torch.benchmarks.distill_drafter import (
        LLAMA_8B as BENCH_8B, engine_config, free_llm)
    from arcticinference_tpu_torch.engine.llm import LLM

    llm = LLM(engine_config(BENCH_8B, True, batch))
    si, reqs = bench.decode_step_inputs(llm, batch, ctx)
    graph = bench.capture_step_graph(llm.engine.runner, si,
                                     llm.engine._generator)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    for req in reqs:
        llm.engine.scheduler.block_manager.free(req.block_ids)
    free_llm(llm)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / replays
    if busy_ms == 0:
        return dict(device_step="not measured")
    qmm = sum(e.self_device_time_total for e in events
              if "qmm::" in e.key) / 1e3 / replays
    # Split K is summed on chip: the step must launch no reduction of the
    # quantized matmuls (PyTorch's own reductions are not theirs).
    reductions = [e.key[:90] for e in events
                  if "qmm::" in e.key and "reduce_kernel" in e.key]
    if reductions:
        raise AssertionError(f"the device step launches split-K "
                             f"reductions: {reductions}")
    attn = sum(e.self_device_time_total for e in events
               if "grouped_decode_kernel" in e.key) / 1e3 / replays
    return dict(batch=batch, ctx=ctx, replays=replays,
                device_ms_per_step=busy_ms, fp8_matmul_ms=qmm,
                attention_ms=attn,
                top=[dict(kernel=e.key[:90],
                          ms_per_step=e.self_device_time_total / 1e3
                          / replays, calls_per_step=e.count / replays)
                     for e in events[:12]])


# ---------------------------------------------------------------------------
# Phase 6: the port's headline bench and the weight-stream microbench
# ---------------------------------------------------------------------------

def phase_bench() -> dict:
    """The bench in this process at the full 8B width and depth in fp8,
    then the stream microbench, each with the launch counts set to 0 just
    before it and read just after; returns {"bench": JSON object,
    "bench_launches", "stream": rows, "stream_launches"}."""
    from arcticinference_tpu_torch import bench
    from arcticinference_tpu_torch.benchmarks import stream_microbench

    reset_counts()
    t0 = time.perf_counter()
    out = bench.run_bench("cuda", curve_rates=BENCH_CURVE_RATES)
    wall = time.perf_counter() - t0
    bench_launches = launch_counts()
    # The bench's JSON object, on a line of its own.
    log(json.dumps(out))
    log(f"[bench] {wall:.1f} s; launches {json.dumps(bench_launches)}")
    free_cuda_memory()
    reset_counts()
    rows = stream_microbench.run(log=lambda line: log("  stream " + line))
    stream_launches = launch_counts()
    log(f"[bench] stream microbench launches {json.dumps(stream_launches)}")
    free_cuda_memory()

    problems = []
    probe = out["hbm_gbps_probe"] * 1e9
    if not probe <= 1.05 * HBM_BYTES_PER_S:
        problems.append(f"probe {probe / 1e9:.1f} GB/s above 1.05x the "
                        f"nominal {HBM_BYTES_PER_S / 1e9:.0f} GB/s: bytes "
                        "were skipped")
    if out["finished"] != out["batch"] or out["single_seq_finished"] != 1:
        problems.append("a greedy batch did not finish")
    spec_points = [out] + out["spec_curve"] + [out["spec_heldout"]]
    if out["spec_finished"] != out["spec_batch"] or any(
            p.get("finished", p.get("spec_finished")) != out["spec_batch"]
            for p in spec_points[1:]):
        problems.append("a speculative batch did not finish")
    if not out["spec_acceptance_rate"] > 0.5:
        problems.append(f"distilled drafter accepted "
                        f"{out['spec_acceptance_rate']:.3f} <= 0.5 on its "
                        "own prompts")
    numbers = [out[k] for k in ("value", "single_seq_decode_tokens_per_s",
                                "device_ms_per_step", "hbm_gbps_achieved",
                                "spec_decode_tokens_per_s")]
    if not all(np.isfinite(v) and v > 0 for v in numbers):
        problems.append(f"non-finite or non-positive numbers: {numbers}")
    for key in ("hbm_read_probe", "fp8_matmul_kernel",
                "ragged_paged_attention_kernel",
                "grouped_decode_attention_kernel"):
        if bench_launches[key] == 0:
            problems.append(f"the bench never launched {key}")
    if stream_launches["stream_matmul_kernel"] == 0:
        problems.append("the microbench never launched the stream kernel")
    bad_rows = [r for r in rows if not (r["finite"]
                                        and r["rel_err"] <= REL_TOL)]
    if bad_rows:
        problems.append(f"stream microbench disagrees: {bad_rows}")
    if problems:
        raise AssertionError(f"bench check failed: {problems}")
    return dict(bench=out, bench_launches=bench_launches, stream=rows,
                stream_launches=stream_launches)


SERVE_BENCH_PROMPTS = 32


def phase_serve_bench() -> list:
    """``python -m arcticinference_tpu_torch.benchmarks.serve_bench`` over
    its five configs at its card shapes and the JAX harness's defaults
    (32 prompts, 128 tokens in, 64 out, the random workload), each config
    in a process of its own; every config must finish every prompt.
    Returns the configs' JSON objects."""
    from arcticinference_tpu_torch.benchmarks.serve_bench import CONFIGS

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "arcticinference_tpu_torch.benchmarks.serve_bench",
         "--configs", *CONFIGS, "--num-prompts", str(SERVE_BENCH_PROMPTS)],
        capture_output=True, text=True, timeout=900,
        cwd=str(Path(__file__).resolve().parent))
    wall = time.perf_counter() - t0
    results = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    for r in results:
        log("  serve_bench " + json.dumps(r))
    log(f"[bench] serve_bench: {wall:.1f} s")
    done = {r["config"]: r["finished"] for r in results}
    if proc.returncode != 0 or done != {c: SERVE_BENCH_PROMPTS
                                        for c in CONFIGS}:
        raise AssertionError(f"serve_bench failed (rc {proc.returncode}, "
                             f"finished {done}): {proc.stderr[-3000:]}")
    return results


def seed_suffix_cache(cache, prompts, outputs, vocab):
    """As tests/test_tree_spec.py seeds it: each request's true
    continuation once and a copy with three tokens changed twice, so a
    linear draft follows the (more frequent) wrong branch at those points
    while a tree carries both.  Only the first 24 output tokens are
    seeded, as many as that test generates: past the first change the
    wrong branch then has fewer than 30 tokens, so a 30-node tree takes
    the right one too instead of filling up with the wrong one."""
    for i, (p, out) in enumerate(zip(prompts, outputs)):
        seq = p[-6:] + out[:24]
        bad = list(seq)
        for flip in (9, 14, 19):
            bad[flip] = (bad[flip] + 7) % vocab
        cache.update_response(f"warm-good-{i}", seq)
        cache.update_response(f"warm-bad-{i}", bad)
        cache.update_response(f"warm-bad2-{i}", list(bad))


def token_agreement(outs, reference) -> dict:
    """How many requests give the reference's tokens, and where the
    others first differ (random weights: argmax ties flip, so this is a
    report, not a check)."""
    first = {}
    for i, (o, want) in enumerate(zip(outs, reference)):
        if o.token_ids != want:
            first[i] = next((j for j, (a, b) in enumerate(
                zip(o.token_ids, want)) if a != b), min(len(o.token_ids),
                                                       len(want)))
    return dict(matching=len(outs) - len(first), of=len(outs),
                first_divergence=first)


def speculative_config(spec, lstm_dir=None):
    """``spec``: "suffix" (linear drafts on the synchronous step), "suffix
    tree", "suffix fused" / "suffix fused deferred" (linear drafts on the
    fused decode loop, the default), or one of :data:`DRAFTER_RUNS`
    (``lstm_dir``: a directory whose config.json names sum_lstm)."""
    from arcticinference_tpu_torch.config import SpeculativeConfig

    words = spec.split()
    if words[0] == "suffix":
        return SpeculativeConfig(
            method="suffix", use_tree_spec=spec == "suffix tree",
            enable_fused_decode="fused" in words, **SUFFIX_KNOBS)
    suffix = "suffix" in words
    return SpeculativeConfig(
        method="arctic", num_speculative_tokens=3,
        model=lstm_dir if words[0] == "lstm" else None,
        quantization="fp8" if "fp8" in words else None,
        enable_fused_decode="fused" in words,
        enable_suffix_decoding=suffix, **(SUFFIX_KNOBS if suffix else {}))


def engine_config(quantization, spec=None, lstm_dir=None,
                  model="llama-3.1-8b"):
    """The generate runs' engine: ``model``'s shape (:data:`MODELS`) at
    full depth, with :func:`speculative_config` of ``spec`` (None: no
    speculation)."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)

    arch_name, dims = MODELS[model]
    return EngineConfig(
        model=ModelConfig(model=arch_name, dtype="bfloat16",
                          max_model_len=4096, hf_overrides=dims,
                          quantization=quantization),
        # 2048 blocks x 4 MiB (Llama-3.1-8B: 2 x 32 layers x 8 heads x 32
        # tokens x 128 x 2 B) = 8 GiB of KV beside the weights (~16 GB in
        # bf16); Qwen2.5-7B 3.5 GiB, Qwen3-8B 9 GiB.
        cache=CacheConfig(num_blocks=2048),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048),
        speculative=None if spec is None else speculative_config(spec,
                                                                 lstm_dir))


def free_cuda_memory() -> None:
    """Return a dropped engine's memory to the card (its cycles first)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def sync_checked_fused_dispatch():
    """Run every fused step's dispatch (its uploads, the step and the
    copy of its telemetry; not its drain) under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    inside raises.  Yields the count of dispatches checked."""
    import torch

    from arcticinference_tpu_torch.engine.fused_decode import (
        FusedDecodeLoop)

    orig = FusedDecodeLoop._dispatch
    checked = {"dispatches": 0}

    def guarded(self, *a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked["dispatches"] += 1
        return out

    FusedDecodeLoop._dispatch = guarded
    try:
        yield checked
    finally:
        FusedDecodeLoop._dispatch = orig


@contextlib.contextmanager
def env_flag(name, value):
    import os

    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def drafted_steps():
    """Count the fused steps drained, those with room for drafts (an
    alive slot at least two tokens short of its limit when the step
    began) and those in which an alive slot verified drafts (from each
    step's telemetry, at its drain)."""
    from arcticinference_tpu_torch.engine.fused_decode import (
        FusedDecodeLoop)

    orig = FusedDecodeLoop._drain_one
    count = {"drained": 0, "with_room": 0, "with_drafts": 0}

    def drain(self):
        step, alive = self._inflight[0], list(self._host_alive)
        mml = self.engine.config.model.max_model_len
        room = any(
            a and min(len(r.prompt_token_ids) + r.sampling.max_tokens, mml)
            - self._known_comp[i] - 2 > 0
            for i, (a, r) in enumerate(zip(alive, self._slots)))
        out = orig(self)
        telem = step.telemetry.numpy()
        count["drained"] += 1
        count["with_room"] += room
        count["with_drafts"] += any(
            a and telem[i, step.k + 1] > 0 for i, a in enumerate(alive))
        return out

    FusedDecodeLoop._drain_one = drain
    try:
        yield count
    finally:
        FusedDecodeLoop._drain_one = orig


@contextlib.contextmanager
def fp8_matmul_shapes():
    """Count ``fp8_matmul_kernel`` calls by weight shape (K, N)."""
    from arcticinference_tpu_torch.ops import fp8

    orig = fp8.fp8_matmul_kernel
    shapes: dict = {}

    def spy(x, w, scale, out_dtype=None):
        key = f"{w.shape[0]}x{w.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
        return orig(x, w, scale, out_dtype)

    fp8.fp8_matmul_kernel = spy
    try:
        yield shapes
    finally:
        fp8.fp8_matmul_kernel = orig


def drafter_chain_report(drafter, vocab, hidden) -> dict:
    """Device time of the drafter's greedy chain (``n_predict`` heads) at
    16 and 64 rows, on CUDA events, against its bound: the bytes it must
    stream at HBM rate, each head's projection and LM head read once per
    draft position (the chain is sequential and a 4096 x 128256 head
    cannot stay in the 50 MB L2), gathered embedding rows, the hidden
    rows in and the drafts out; ``bound_once_ms`` counts every parameter
    once instead."""
    import torch

    from arcticinference_tpu_torch.models import speculators as sm

    params, arch, n = drafter.params, drafter.arch, drafter.n_predict

    def row_bytes(e):
        return e.nbytes // e.shape[0]

    if drafter.kind == "mlp":
        heads = [sm._mlp_head_params(params, arch, i) for i in range(n)]
        per_pos = [(p.nbytes + h.nbytes + lw.nbytes + lb.nbytes, e)
                   for e, p, h, lw, lb in heads]
        once = sum({id(x): x.nbytes for hd in heads for x in hd}.values())
    else:
        norms = sum(params[k].nbytes for k in (
            "cell_ln_w", "cell_ln_b", "state_ln_w", "state_ln_b"))
        per_pos = [((params["proj_first"] if i == 0 else
                     params["proj_rest"]).nbytes + params["head"].nbytes
                    + norms, params["forget_emb"]) for i in range(n)]
        once = sum(v.nbytes for v in params.values())
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for b in (16, 64):
        tok = torch.randint(0, vocab, (b,), device="cuda", generator=gen,
                            dtype=torch.int32)
        hid = torch.randn((b, hidden), device="cuda", generator=gen).to(
            torch.bfloat16)
        # Tens of ops a chain: a 40 ms spin covers the host's enqueue of
        # the 10 timed chains (host_us says what one costs).
        ms = cuda_time_ms(lambda: drafter.generate(params, tok, hid),
                          iters=10, sleep_cycles=4 * QUEUE_SLEEP_CYCLES)
        host_us = host_time_us(lambda: drafter.generate(params, tok, hid),
                               calls=5)
        io = hid.nbytes + tok.nbytes + b * n * 4
        nbytes = io + sum(w + b * row_bytes(e) for w, e in per_pos)
        out[f"B={b}"] = dict(
            ms=ms, host_us=host_us,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=nbytes, bound_once_ms=(once + io) / HBM_BYTES_PER_S * 1e3)
    return out


def prefill_step_inputs(llm, n: int):
    """A prefill step of one ``n``-token prompt (its blocks allocated;
    the caller frees them)."""
    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.scheduler import (ScheduledRequest,
                                                            SchedulerOutput)

    runner = llm.engine.runner
    rng = np.random.default_rng(8)
    req = Request(req_id="prefill", prompt_token_ids=[
        int(x) for x in rng.integers(1, runner.arch.vocab_size - 1, n)],
        sampling=SamplingParams(max_tokens=4))
    llm.engine.scheduler.block_manager.grow_to(req.block_ids, n)
    sched = SchedulerOutput()
    sched.scheduled.append(ScheduledRequest(req, n, []))
    return runner.prepare_inputs(sched), req


# The device steps timed beside the generate runs of Llama-3.1-8B and
# Llama-3.1-SwiftKV-8B: a 2048-token prefill chunk (one prompt) and a
# decode step of 16 sequences at 512 tokens.
DEVICE_PREFILL_TOKENS = 2048
DEVICE_DECODE = (16, 512)


def device_step_ms(llm) -> dict:
    """Device ms of a prefill step of :data:`DEVICE_PREFILL_TOKENS` tokens
    and of a decode step at :data:`DEVICE_DECODE`, each step's launches
    captured in a CUDA graph (``bench.capture_step_graph``) and replayed
    between CUDA events, so the host's enqueue does not show."""
    from arcticinference_tpu_torch import bench
    from arcticinference_tpu_torch.utils import events_ms

    eng = llm.engine
    si, req = prefill_step_inputs(llm, DEVICE_PREFILL_TOKENS)
    try:
        graph = bench.capture_step_graph(eng.runner, si, eng._generator)
        prefill = events_ms(graph.replay, 10)
        del graph
    finally:
        eng.scheduler.block_manager.free(req.block_ids)
    decode = bench.measure_device_step(llm, *DEVICE_DECODE, iters=20)
    return {f"prefill {DEVICE_PREFILL_TOKENS}": prefill,
            f"decode B={DEVICE_DECODE[0]} ctx={DEVICE_DECODE[1]}":
                decode["device_ms"]}


def run_generate(quantization, prompts, spec=None, reference=None,
                 lstm_dir=None, model="llama-3.1-8b", sampling=None,
                 device_steps=False):
    """One timed ``LLM.generate`` run on a new engine of ``model``
    (``reference``: the bf16 run's tokens, which seed a speculative run's
    suffix cache; ``sampling``: one ``SamplingParams`` per prompt, 32
    greedy tokens by default; ``device_steps``: then
    :func:`device_step_ms` on the same engine).  Returns (result,
    outputs)."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    dims = MODELS[model][1]
    t0 = time.perf_counter()
    llm = LLM(engine_config(quantization, spec, lstm_dir, model))  # cuda:0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vocab = llm.engine.arch.vocab_size
    suffix = llm.engine._suffix_cache
    drafter = llm.engine._drafter
    if suffix is not None:
        seed_suffix_cache(suffix, prompts, reference, vocab)
    fused = spec is not None and "fused" in spec.split()
    # Deferred KV serves only the fused loop's global-wide program, and
    # the loop's width policy picks it from which drafts were consumed,
    # which random weights leave to near-ties: the deferred run pins the
    # width so that every fused step takes the path.
    deferred = spec == "suffix fused deferred"
    torch.cuda.reset_peak_memory_stats()
    steps0 = llm.engine.engine_stats.num_steps
    reset_counts()
    t0 = time.perf_counter()
    with host_breakdown(llm.engine.runner) as host, \
            sync_checked_fused_dispatch() as checked, \
            drafted_steps() as drafted, fp8_matmul_shapes() as fp8_shapes, \
            env_flag("ARCTIC_TPU_DEFERRED_KV", "1" if deferred else None), \
            env_flag("ARCTIC_TPU_FUSED_FORCE_WIDTH",
                     "wide" if deferred else None):
        outs = llm.generate(prompt_token_ids=prompts,
                            sampling_params=sampling
                            or SamplingParams(max_tokens=32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    n_steps = llm.engine.engine_stats.num_steps - steps0
    steps = llm.engine.step_times.summary()
    dec = steps.get("decode", {})
    n_tok = sum(len(o.token_ids) for o in outs)
    res = dict(
        model=model, quantization=quantization, spec=spec,
        layers=dims["num_hidden_layers"], requests=len(outs),
        finished=sum(o.finish_reason == "finished_length" for o in outs),
        prompt_tokens=sum(len(p) for p in prompts), generated_tokens=n_tok,
        wall_s=wall, init_s=init_s, engine_steps=n_steps,
        decode_tok_per_s=(dec["tokens"] / dec["total_s"]) if dec else None,
        steps=steps, decode_host_p50_ms=host.summary(), launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        card=smi())
    tree_key = "ragged_paged_attention_kernel (tree mask)"
    deferred_key = "grouped_decode_attention_kernel (deferred KV)"
    if spec is not None:
        st = llm.engine.spec_stats
        res.update(
            tokens_per_step=n_tok / n_steps,
            native_suffix_tree=suffix is not None and suffix.is_native(),
            drafts=st.num_drafts, draft_tokens=st.num_draft_tokens,
            accepted_tokens=st.num_accepted_tokens,
            accepted_per_position=st.num_accepted_tokens_per_pos,
            step_p50_ms={k: v["p50_ms"] for k, v in steps.items()},
            agreement_with_bf16=token_agreement(outs, reference))
    if fused:
        res.update(fused_steps=steps.get("fused", {}).get("count", 0),
                   width_stats=llm.engine.width_stats,
                   sync_checked_dispatches=checked["dispatches"],
                   drained_steps=drafted)
    head_key = f"{dims['hidden_size']}x{dims['vocab_size']}"
    if drafter is not None:
        res.update(drafter=drafter.kind, drafter_quantization=(
            llm.engine.spec_config.quantization),
            fp8_matmul_launches_by_shape=fp8_shapes,
            drafter_chain=drafter_chain_report(
                drafter, vocab, dims["hidden_size"]))
    log("  generate " + json.dumps(res))
    matmul = {"fp8": "fp8_matmul_kernel",
              "int4": "int4_matmul_kernel"}.get(quantization)
    ok = (res["finished"] == 16 and n_tok == 16 * 32
          and all(len(o.token_ids) == 32 for o in outs)
          and all(0 <= t < vocab for o in outs for t in o.token_ids)
          and launches["ragged_paged_attention_kernel"] > 0)
    if spec is None:
        ok = ok and launches["grouped_decode_attention_kernel"] > 0 \
            and launches[tree_key] == 0
    else:
        ok = ok and res["drafts"] > 0
        ok = ok and ((launches[tree_key] > 0) == (spec == "suffix tree"))
    if suffix is not None:
        # Seeded suffix paths are accepted (beside a drafter too: they
        # clear its score bar of num_speculative_tokens).
        ok = ok and res["native_suffix_tree"] and res["accepted_tokens"] > 0
    if fused:
        # Every fused step was dispatched under the sync check.
        ok = ok and res["fused_steps"] > 0 and \
            checked["dispatches"] == sum(
                v for k, v in res["width_stats"].items() if k != "entries")
    if fused and drafter is not None:
        # Every fused step with room for drafts verifies some but an
        # entry's first (the sync steps before it leave the drafting to
        # the loop); every step is wide.
        ws = res["width_stats"]
        ok = ok and ws["narrow"] == 0 and \
            drafted["with_drafts"] >= drafted["with_room"] - ws["entries"]
    ok = ok and ((launches[deferred_key] > 0)
                 == (spec == "suffix fused deferred"))
    drafter_fp8 = drafter is not None and \
        llm.engine.spec_config.quantization == "fp8"
    # wqkv, wo, w_gateup and w_down per layer, and the LM head (and
    # SwiftKV's fused KV operand).
    per_step = matmul_launches_per_step(llm.engine.arch)
    res["matmul_launches_per_step"] = per_step if matmul else 0
    for key in ("fp8_matmul_kernel", "int4_matmul_kernel"):
        want = per_step * n_steps if key == matmul else 0
        if key == "fp8_matmul_kernel" and drafter_fp8:
            # The fp8 drafter's products (a bf16 target): its head at
            # every draft position of every fused step at least.
            want = launches[key]
            ok = ok and fp8_shapes.get(head_key, 0) >= \
                drafter.n_predict * checked["dispatches"] > 0
        ok = ok and launches[key] == want
    if not ok:
        raise AssertionError(f"end-to-end check failed: {res}")
    if device_steps:
        res["device_step_ms"] = device_step_ms(llm)
        log("  device steps " + json.dumps(dict(
            model=model, quantization=quantization,
            device_step_ms=res["device_step_ms"], card=res["card"])))
    llm.close()
    del llm
    free_cuda_memory()
    return res, outs


def profile_run(quantization, rng) -> dict:
    """:func:`profile_generate` on a new engine, after a short generate
    that warms it up."""
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    llm = LLM(engine_config(quantization))
    vocab = llm.engine.arch.vocab_size
    llm.generate(prompt_token_ids=[[int(x) for x in rng.integers(0, vocab,
                                                                  256)]],
                 sampling_params=SamplingParams(max_tokens=4))
    out = profile_generate(llm, rng, vocab)
    llm.close()
    del llm
    free_cuda_memory()
    return out


def profile_drafter_chain(spec, lstm_dir, rows: int = 64,
                          chains: int = 5) -> dict:
    """Device time by kernel of the drafter chain alone (a drafter of
    :func:`speculative_config` ``spec`` at the 8B width, ``rows`` rows)
    over ``chains`` chains under ``torch.profiler``: where the chain's
    time goes.  A measurement, not a check: an empty trace reads "not
    measured"."""
    import types

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arcticinference_tpu_torch.spec.proposer import ArcticProposer

    hidden, vocab = LLAMA_8B["hidden_size"], LLAMA_8B["vocab_size"]
    drafter = ArcticProposer(
        speculative_config(spec, lstm_dir),
        types.SimpleNamespace(hidden_size=hidden, vocab_size=vocab),
        torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(2)
    tok = torch.randint(0, vocab, (rows,), device="cuda", generator=gen,
                        dtype=torch.int32)
    hid = torch.randn((rows, hidden), device="cuda", generator=gen).to(
        torch.bfloat16)
    for _ in range(2):
        drafter.generate(drafter.params, tok, hid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chains):
            drafter.generate(drafter.params, tok, hid)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / chains
    del drafter
    free_cuda_memory()
    if busy_ms == 0:
        return dict(spec=spec, device_busy="not measured")
    return dict(spec=spec, rows=rows, chains=chains,
                device_ms_per_chain=busy_ms,
                top=[dict(kernel=e.key[:90],
                          ms_per_chain=e.self_device_time_total / 1e3
                          / chains, calls_per_chain=e.count / chains)
                     for e in events[:8]])


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

    def timed_execute(step_inputs, *a, **k):
        out = timed("execute", execute)(step_inputs, *a, **k)
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
    # Both quantized matmul kernels (kernel 8's, too, on its own path).
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
    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    sources = (ra.SOURCE, fm.SOURCE, im.SOURCE, hp.SOURCE, sm.SOURCE)
    t0 = time.perf_counter()
    libs = build.build_all(sources)
    log(f"[build] {', '.join(sources)} in {time.perf_counter() - t0:.1f} s "
        "(one nvcc each, at once)")
    for src in sources:
        log(f"  {src}:")
        for line in build.build_logs.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("    " + line.strip())
    # The attention kernels run their products on the tensor cores: every
    # instance (4 of kernel 1, 8 of kernels 2-3, 8 of kernel 4) must hold
    # HMMA instructions.
    hmma = hmma_counts(libs[0])
    log(f"[build] HMMA instructions per attention kernel instance: "
        f"{json.dumps(hmma)}")
    n_grouped = sum(k.startswith("grouped") for k in hmma)
    n_range = sum(k.startswith("decode_range") for k in hmma)
    if (len(hmma) != 20 or n_grouped != 8 or n_range != 8
            or min(hmma.values()) == 0):
        raise AssertionError(
            f"attention kernel instances missing or without HMMA: {hmma}")
    # The quantized matmuls run their products on wgmma: every instance
    # (9 plans per weight format: e4m3 and int8, int4, and kernel 8's f16
    # trick, bit trick, e4m3 and int8) must hold HGMMA.
    hgmma = {src: hgmma_counts(lib) for src, lib in zip(sources, libs)
             if src in (fm.SOURCE, im.SOURCE, sm.SOURCE)}
    log(f"[build] HGMMA instructions per quantized matmul instance: "
        f"{json.dumps(hgmma)}")
    if (len(hgmma[fm.SOURCE]) != 18 or len(hgmma[im.SOURCE]) != 9
            or len(hgmma[sm.SOURCE]) != 36
            or min(min(c.values()) for c in hgmma.values()) == 0):
        raise AssertionError(
            f"quantized matmul instances missing or without HGMMA: {hgmma}")

    csrc = "arcticinference_tpu_torch/csrc/"
    kernels = {
        "ragged_paged_attention_kernel": dict(
            name="ragged_paged_attention_kernel", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:292"),
        "ragged_paged_attention_kernel (tree mask)": dict(
            name="ragged_paged_attention_kernel (tree mask)", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:292 "
                     "(use_tree)"),
        "grouped_decode_attention_kernel": dict(
            name="grouped_decode_attention_kernel", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:1080"),
        "grouped_decode_attention_kernel (deferred KV)": dict(
            name="grouped_decode_attention_kernel (deferred KV)",
            route="cuda", source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:1126 "
                     "(knew / vnew)"),
        "decode_paged_attention_kernel": dict(
            name="decode_paged_attention_kernel", route="cuda",
            source=csrc + ra.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/ragged_attention.py:620"),
        "fp8_matmul_kernel": dict(
            name="fp8_matmul_kernel", route="cuda", source=csrc + fm.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/fp8_matmul.py:65"),
        "int4_matmul_kernel": dict(
            name="int4_matmul_kernel", route="cuda", source=csrc + im.SOURCE,
            replaces="arcticinference_tpu/ops/pallas/int4_matmul.py:105"),
        "hbm_read_probe": dict(
            name="hbm_read_probe", route="cuda", source=csrc + hp.SOURCE,
            replaces="bench.py:120 (_measure_dma_read)"),
        "stream_matmul_kernel": dict(
            name="stream_matmul_kernel", route="cuda",
            source=csrc + sm.SOURCE,
            replaces="benchmarks/stream_microbench.py:167 "
                     "(make_pallas_body)"),
    }
    if "kernels" in phases:
        log(f"[kernels] kernel vs plain, Hq={HQ} Hkv={HKV} D={D}, "
            f"{LAYERS}-layer cache")
        ragged, grouped, paged, invariance = phase_kernels(rng)
        log("[kernels] deferred-KV path (kernel 3) vs plain, and kernel 2 "
            "on the same steps with the rows written")
        deferred_cases, grouped_written = phase_deferred_kernels(rng)
        grouped = grouped + grouped_written
        log("[kernels] tree-mask path vs plain, token-tree verify steps")
        tree_cases = phase_tree_kernels(rng)
        log(f"[kernels] kernels 1, 2 and 4 at GQA group 7 (Qwen2.5-7B: "
            f"Hq={G7_HQ} Hkv={G7_HKV} D={D}) vs plain")
        g7 = phase_kernels(rng, hq=G7_HQ, hkv=G7_HKV,
                           layers=QWEN25_7B["num_hidden_layers"],
                           prefix="g7 ", long_context=False)
        ragged, grouped, paged, invariance = (
            a + b for a, b in zip((ragged, grouped, paged, invariance), g7))
        log("[kernels] ragged kernel on SwiftKV's swift half (the sample "
            "rows' schedule) vs plain")
        ragged = ragged + phase_swift_kernels(rng)
        log("[kernels] quantized matmuls vs plain, Llama-3.1-8B weights; "
            "kernel 5 at Qwen2.5-7B's and Qwen3-8B's and on SwiftKV's "
            "fused KV operand")
        fp8_cases, int4_cases, replay = phase_matmul_kernels(args.seed)
        log("[kernels] HBM read probe vs plain, 4 GiB of random bf16")
        probe_cases = phase_probe_kernel(args.seed)
        log("[kernels] weight-stream matmul variants vs plain, "
            "Llama-3.1-8B decode shapes, 64 rows")
        stream_cases = phase_stream_kernels(args.seed)
        # The summary line reports, for each kernel, the case of its
        # heaviest main-path step (a 2048-token prefill chunk; a batch-64
        # decode step) or, for the matmuls, the decode weight stream they
        # exist for (w_gateup at 16 rows), and every case beside it.
        for key, cases, rep_name in (
                ("ragged_paged_attention_kernel", ragged,
                 "prefill 2048@ctx2048 bf16 qb=32"),
                ("ragged_paged_attention_kernel (tree mask)", tree_cases,
                 f"tree verify 16x(1+{TREE_NODES})@ctx~1024 bf16 qb=32"),
                ("grouped_decode_attention_kernel", grouped,
                 "decode B=64 qlen=1 bf16"),
                ("grouped_decode_attention_kernel (deferred KV)",
                 deferred_cases, "deferred B=64 qlen=8 bf16"),
                ("decode_paged_attention_kernel", paged,
                 "decode_paged decode B=64 qlen=1 bf16"),
                ("fp8_matmul_kernel", fp8_cases,
                 "fp8 w_gateup [4096,28672] M=16"),
                ("int4_matmul_kernel", int4_cases,
                 "int4 w_gateup [4096,28672] M=16"),
                ("hbm_read_probe", probe_cases, probe_cases[0]["case"]),
                ("stream_matmul_kernel", stream_cases,
                 "astype_e4m3 gateup-fused [4096,28672] M=64")):
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
                    "library_ms", "max_abs_err", "rel_err", "kernel2_ms",
                    "host_us", "kernel2_host_us", "kernel5_unit_scale_ms")
                    if k in c}
                       for c in cases])
        kernels["grouped_decode_attention_kernel"]["row_invariance"] = [
            c for c in invariance if c["kernel"] == 2]
        kernels["decode_paged_attention_kernel"]["row_invariance"] = [
            c for c in invariance if c["kernel"] == 4]
        for key, mode, src in (("fp8_matmul_kernel", "fp8", fm.SOURCE),
                               ("int4_matmul_kernel", "int4", im.SOURCE)):
            kernels[key]["hgmma"] = hgmma[src]
            kernels[key]["replay"] = [c for c in replay
                                      if c["case"].startswith(mode)]
        kernels["hbm_read_probe"].update(
            tolerance="|out-plain| <= 1e-6 * sum(|summed values|)",
            library_note=probe_cases[0]["library_note"])
        kernels["stream_matmul_kernel"]["kernel5_unit_scale_ms"] = next(
            c["kernel5_unit_scale_ms"] for c in stream_cases
            if c["case"] == kernels["stream_matmul_kernel"]["case"])
        kernels["stream_matmul_kernel"]["hgmma"] = hgmma[sm.SOURCE]
        kernels["decode_paged_attention_kernel"]["hmma"] = {
            k: v for k, v in hmma.items() if k.startswith("decode_range")}
    if "forward" in phases:
        for quantization in (None, "fp8", "int4"):
            log(f"[forward] Llama-3.1-8B width, 2 layers, "
                f"{quantization or 'bf16'} weights, kernels vs plain")
            phase_forward(rng, quantization)
        for quantization in (None, "fp8"):
            log(f"[forward] fused wide step (16 slots x 8 rows), 2 layers, "
                f"{quantization or 'bf16'} weights, deferred KV on vs off")
            phase_forward_deferred(rng, quantization)
        for model in ("qwen2.5-7b", "qwen3-8b"):
            for quantization in (None, "fp8"):
                log(f"[forward] {model} width, 2 layers, "
                    f"{quantization or 'bf16'} weights, kernels vs plain")
                phase_forward(rng, quantization, model)
        for quantization in (None, "fp8", "int4"):
            log(f"[forward] Llama-3.1-SwiftKV-8B width, 4 layers (2 + 2), "
                f"{quantization or 'bf16'} weights, kernels vs plain")
            phase_forward(rng, quantization, "llama-3.1-swiftkv-8b")
    if "generate" in phases:
        log("[generate] LLM.generate, Llama-3.1-8B shape, 32 layers, bf16, "
            "suffix speculation (linear, tree, fused loop, fused loop with "
            "deferred KV), Arctic drafters (MLP fused and sync, fp8 LSTM "
            "fused, MLP + suffix fused), then fp8 and int4 weights")
        runs, prompts = phase_generate(rng)
        log("[generate] LLM.generate, Llama-3.1-SwiftKV-8B shape, 32 layers "
            "(16 + 16), bf16 and fp8, suffix (sync and fused), MLP drafter "
            "fused, all-combined (MLP + suffix, fused)")
        swift_runs = phase_generate_swift(prompts, runs)
        log("[generate] LLM.generate, Qwen2.5-7B (28 layers) and Qwen3-8B "
            "(36 layers) shapes, bf16 and fp8; Qwen3-8B fp8 with penalties "
            "and logprobs")
        qwen_runs = phase_generate_qwen(rng)
        # This slice's path: the Qwen runs' launches, each run's own.
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            kernels[key]["launches_qwen"] = {
                run: dict(launches=r["launches"][key],
                          engine_steps=r["engine_steps"])
                for run, r in qwen_runs.items()}
        # SwiftKV's runs: kernels 1, 2 and 5 on the swift half's
        # schedules and the fused KV operand.
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            kernels[key]["launches_swiftkv"] = {
                run: dict(launches=r["launches"][key],
                          engine_steps=r["engine_steps"])
                for run, r in swift_runs.items()}
        kernels["fp8_matmul_kernel"]["swiftkv_launches_per_step"] = \
            swift_runs["swiftkv fp8"]["matmul_launches_per_step"]
        # Each kernel's launches from the run of its own path.
        for key, run in (("ragged_paged_attention_kernel", "bf16"),
                         ("ragged_paged_attention_kernel (tree mask)",
                          "suffix tree"),
                         ("grouped_decode_attention_kernel", "bf16"),
                         ("grouped_decode_attention_kernel (deferred KV)",
                          "suffix fused deferred"),
                         # No caller on the engine's path (as in the JAX
                         # package): 0.
                         ("decode_paged_attention_kernel", "bf16"),
                         ("fp8_matmul_kernel", "fp8"),
                         ("int4_matmul_kernel", "int4")):
            kernels[key]["launches"] = runs[run]["launches"][key]
    if "bench" in phases:
        log("[bench] the serving matrix (benchmarks/serve_bench.py): "
            "baseline, suffix, spec, swiftkv, all; Llama-3.1-8B shapes, "
            "fp8, one process each")
        phase_serve_bench()
        log("[bench] the port's bench: Llama-3.1-8B, 32 layers, fp8 "
            "weights, drafter distilled here; then the stream microbench")
        res = phase_bench()
        # Kernels 7 and 8 run on the bench's path: their launches are
        # those of the bench's run and the microbench's.
        kernels["hbm_read_probe"]["launches"] = \
            res["bench_launches"]["hbm_read_probe"]
        kernels["stream_matmul_kernel"]["launches"] = \
            res["stream_launches"]["stream_matmul_kernel"]
    if "generate" in phases:
        log("[profile] shorter bf16 and fp8 runs and the drafter chains "
            "under torch.profiler")
        phase_profile(rng)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
