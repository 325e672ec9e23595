#!/usr/bin/env python3
"""Drive the PyTorch port (``arcticinference_tpu_torch``) on one H100.

    python3 chip_smoke.py                # every phase (the default)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each reported on its own lines:

1. device:   card name and power limit (nvidia-smi), torch's device name.
2. build:    nvcc builds every kernel source of ``arcticinference_tpu_torch/
             csrc`` (the attention kernels, the two quantized matmuls,
             the HBM read probe, the weight-stream matmul variants and
             the grouped MoE matmul) at once, one process each (printing
             ``-Xptxas -v``:
             registers, shared memory, spills); ``cuobjdump -sass`` must
             find HMMA (tensor-core) instructions in every instance of
             the ragged kernel, the grouped decode kernel and the
             page-range decode kernel (kernel 4), and HGMMA (wgmma)
             instructions in every instance of the quantized matmul
             pipeline (kernels 5 and 6, and kernel 8's variants on it)
             and in every instance of the grouped MoE matmul (which must
             hold no HMMA: no mma.sync path is left).
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
7. pipeline: the pipelined step (the JAX engine's default without
             speculation) against the synchronous one on one engine of
             Llama-3.1-8B at full width and depth (random weights, prefix
             caching off), bf16 then fp8: ``LLM.generate`` over 32 prompts
             of 64-1024 tokens x 64 new tokens, greedy (three alternating
             pairs, for the decode-phase step wall times) and
             seeded at temperature 0.8; every pipelined pure-decode
             dispatch (and the copy of its output vector) under
             ``torch.cuda.set_sync_debug_mode("error")``.  fp8 tokens must
             be identical and kernel 5 launch 129 times a dispatch; a bf16
             divergence is allowed only where some step up to it ran at
             another shape in the two runs (cuBLAS picks its algorithm by
             shape).  Then guided decoding on the fp8 engine over a
             synthetic tokenizer of 128256 tokens made from a seed: a JSON
             schema, a date regex and a 5-way choice compiled with the
             native sweeper (compile time, states, transitions, pool
             upload time), 32 requests of 48 tokens (8 per grammar, 8
             unguided; half greedy, half seeded at temperature 1.0)
             through the device grammar pool (pipelined) and through host
             masks (synchronous): the same tokens, every guided output
             alive in its DFA, a finished one accepting, a finished JSON
             one parsing, none aborted, guided pipelined dispatches under
             the sync check.
8. serve:    the OpenAI-compatible server at the serving matrix's
             baseline config (Llama-3.1-8B at full width and depth, fp8,
             random weights from the config's seed; 4096-token contexts,
             32 sequences, 2048 batched tokens, 800 blocks).  (a) ``python
             -m arcticinference_tpu_torch serve`` as a subprocess: /health,
             /v1/models, 4 greedy completions one at a time by token ids
             (prompts of 128-1024 tokens that share no prefix, 64 tokens,
             ``ignore_eos``), a warm-up burst and a burst of 32 such
             completions arriving 25 ms apart (half over SSE; each must finish with ``length`` and
             64 tokens, a stream end in ``[DONE]``), 2 ``echo`` /
             ``max_tokens: 0`` scoring requests, /start_profile, 2
             requests, /stop_profile (the Chrome trace must name the CUDA
             kernels of kernels 1, 2 and 5), a streamed client that
             disconnects after its first chunk (/metrics must show no
             running request within 5 s), the burst twice through the
             port's router (``serving/router.py``) with a dead backend
             beside the server and once more directly (direct, router,
             router, direct, each on fresh prompts of the same lengths;
             every request succeeds, /replicas marks the dead one
             unhealthy), /metrics, and SIGTERM (the server must exit
             within 30 s).  Client-observed TTFT p50 / p99, mean TPOT and
             output tok/s of each burst, and the median ms of GET /health
             and /v1/models directly and through the router.  (b) The same
             config in this process: ``LLM.generate`` of each sequential
             prompt alone must give the server's tokens id for id, and
             ``LLM.score`` of each echo prompt its ``token_logprobs``
             exactly.  (c) An in-process ``OpenAIServer`` over the
             synthetic tokenizer: a chat completion (the fallback
             template), ``guided_choice``, ``guided_regex`` and a
             ``json_schema`` response format (each output must conform),
             ``n: 2`` with a seed, an echo request and a streamed chat
             through the port's Dynasor proxy (the stream passes through,
             the backend counts the probes); kernels 1, 2 and 5 must
             launch in this part (``launches_serve``).
9. embed:    (a) ``LLM.encode`` on BERT at the published widths of
             Snowflake/snowflake-arctic-embed-m-v1.5 (hidden 768, 12
             layers, 12 heads of 64, intermediate 3072, vocab 30522, 512
             positions) and snowflake-arctic-embed-l (hidden 1024, 24
             layers, 16 heads, intermediate 4096), random bf16 weights
             from the seed: 256 prompts of 16-512 tokens with cls and
             mean pooling, each embedding held against the same weights
             in float32 through the same plain path (cosine >=
             EMBED_COS per row); Ktok/s (wall clock) against the flops
             bound of the real tokens, the padding share (bucketed over
             real tokens) and the device ms of every (batch, tokens)
             bucket (CUDA events).  (b) ``LLM.encode`` on Llama-3.1-8B at
             full width and depth with fp8 weights: 64 prompts of
             128-1024 tokens, last and mean pooling, kernels 1 and 5
             launched 32 and 128 times a device batch (no LM head), the
             embeddings held against the route through the plain
             versions (cosine >= CAUSAL_COS per row), and the device ms
             of a 2048-token pooled forward beside the 2048-token prefill
             step's CUDA graph.  (c) The embedding fleet: ``python -m
             arcticinference_tpu_torch embed`` with 1 and with 2
             BERT-base replica processes on the card, the port's
             ``embedding_bench`` against each in turns (1, 2, 2, 1; batch
             64, concurrency 8, ``uniform:64,512``), the managers' summed
             ``GetReplicaInfo`` counters against what was sent, requests
             without input each followed at once by a good one (the bad
             one answered INVALID_ARGUMENT, the good one answered), and a
             run during which one replica of the 2-replica fleet is
             killed: every request is answered.
10. quality: the tiny trained checkpoint (``benchmarks/tiny_markov.py``:
             2 layers, hidden 128, 2 q heads of 64 over 1 kv head, a
             256-byte vocabulary), trained here for QUALITY_TRAIN_STEPS
             (300, the JAX gate's) Adam steps on the Markov corpus
             (seconds and losses logged).  (b) The quality
             gate (``benchmarks/quality_gate.py``): held-out perplexity
             through ``LLM.score`` (6 x 256 tokens, 32-token pages) in
             bf16, fp8, int8, int4 and fp8 weights over an fp8 KV cache,
             each also through the plain versions on the same engine
             (within PLAIN_PPL_TOL), with the JAX gate's bounds (bf16 <
             2.5; fp8, int8 < 1.02x; int4 < 1.06x; fp8 KV < 1.03x) and
             the logit KL of fp8 / int8 / int4 against bf16 over a
             256-token prefill (< 0.05, 0.05, 0.20); kernel 1 must launch
             in every run, kernel 5 in the fp8 / int8 / fp8-KV runs,
             kernel 6 in the int4 run, no quantized kernel in bf16, and
             the fp8-KV run's pages must be fp8.  (c) The accuracy matrix
             (``benchmarks/accuracy_harness.py``): the JAX accuracy
             test's tasks over bf16, fp8 and int8 ``LocalClient``s with
             its bars (kernels 1 and 2, and 5 when quantized, launched in
             each), and ``HTTPClient`` against ``python -m
             arcticinference_tpu_torch serve`` on bf16 (echo logprob
             within 5e-2 of local, 4 generated tokens).  (d) The bench's
             ``spec_transfer`` block (``bench.spec_transfer``, the
             transfer drafter at the JAX script's defaults) on this
             checkpoint: MLP and LSTM held-out acceptance > 0.3, MLP
             tokens per step > 1.5, held-out tokens equal to the greedy
             comparator's.  (f) Kernels 1 and 2 at the checkpoint's
             attention (bf16 and fp8 pages: the gate's 2 x 256 score
             batch and the transfer's 16 x 64 prefill at qb 32; decode
             B=16 at qlen 1 and 4, B=1; the qlen-4 rows bit for bit
             against qlen-1 launches) and kernels 5 and 6 at its weights
             (fp8, int8, int4 at 16 and 256 rows) against their plain
             versions.  Phase 6's bench skips ``spec_transfer``: this
             phase runs it.
11. moe:     (a) the grouped MoE matmul (``csrc/grouped_matmul.cu``,
             the counterpart of ``jax.lax.ragged_dot``) against its plain
             version at Mixtral-8x7B's expert stacks (w_gate / w_up
             [8, 4096, 14336], w_down [8, 14336, 4096]) in bf16, fp8,
             int8 and int4, at 128, 512 and 4096 rows routed uniformly,
             skewed (~70% on one expert), with one expert empty and all
             on one expert (atol = rtol = 2e-2 plus a 1e-3 relative
             norm); the uniform cases and fp8's skewed 128 and 4096 rows
             timed beside the plain version, the bound (the bytes of the
             experts with rows or the bf16 products),
             ``torch._grouped_mm`` on the bf16 stack (a per-expert
             ``torch.mm`` loop where the card's torch lacks it);
             rows bit for bit beside fresh rows and at other indices of
             their group, two launches alike, a CUDA graph replayed
             twice alike, rows past the last group exactly 0, rows
             one-hot at a column equal to the dequantized weight row.
             (b) Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's config) at
             full width and depth in fp8, random weights:
             ``LLM.generate`` of 16 prompts of 128-1024 tokens x 32 on
             the pipelined step (every pure-decode dispatch under the
             sync check) and on the synchronous step of the same engine
             (tokens may differ only where the two runs' step shapes
             did), 96 grouped and 129 kernel-5 launches a dispatch; a
             2000-token prefill through ``forward`` with the kernels
             and through the plain route, which takes the kernel run's
             experts layer by layer (the tokens whose own choice differs
             counted per layer), at 2 layers with phase 4's tolerance and
             at full depth with phase 9's (cosine >= CAUSAL_COS per row),
             argmax equal or a near tie in both; init
             seconds and peak memory; the B=64, ctx-512 decode step as a
             CUDA graph against its byte bound; then the fused suffix
             loop (the suffix cache seeded from the pipelined run) with
             every fused dispatch under the sync check.  (c) Mixtral-8x7B
             in bf16 at 8 layers (its 32 would take ~93 GB): the same
             generate runs and prefill check.
12. parallel: tensor, Ulysses sequence and shift parallelism
             (``arcticinference_tpu_torch/parallel/``) on one card: the
             ranks of a world share cuda:0 over gloo, whose collectives
             stage through host memory (NCCL refuses two ranks on one
             device), so no time here says anything about NCCL across
             cards.  (a) Kernels 1, 2 and 5 at a rank's shapes
             (:data:`SHARD_ATTN_HEADS`, :data:`SHARD_MATMUL_SHAPES`)
             against their plain versions, timed beside the bound and
             SDPA / ``torch.mm`` (in the kernels phase when it runs).
             Also kernel 1 on a pipeline microbatch at a stage's heads
             and kernel 2 at a dp group's batch and at a fused
             microbatch's slots.
             (b) Llama-3.1-8B fp8 (random weights from the seed) on one
             device, then, on one world of 4 ranks, world (i) tp 2 (its
             ranks 0-1), (ii) sp 2 x tp 2 with shift (prefill steps on
             the Ulysses program, decode steps on the shift program),
             (iii) dp 2 x tp 2 (in-engine data parallelism) and (iv) pp
             2 x sp 2 with shift (two pipeline stages of half the
             layers; prefills on the ``pp`` program, decodes on
             ``pp_shift``): at 2 layers (worlds (i) and (ii)) and at
             full depth, 8 prompts of 128-1024 tokens each prefilled and
             then decoded one token
             in borrowed blocks (under dp, prompt i in group i mod 2),
             the sample rows' logits and the first and last layers'
             pages (a rank's head slice, of the layers its stage holds,
             through its group's shard-local block ids) against the
             single device's, as are the single device's own through
             the plain matmuls (its noise floor: another summation
             order) (2 layers: phase 4's bound; full depth: the bounds
             above :func:`logits_ok`, set from both readings); then at
             full depth ``LLM.generate``'s step loop, pipelined and
             synchronous, 8 prompts x 16 tokens, and in world (iv) the
             fused suffix loop too (kernel 2 on each microbatch's
             slots): every rank's tokens and output-vector digest
             equal, both modes counted in worlds (ii) and (iv), kernels
             1, 2 and 5 launched on every rank; step wall ms by mode
             beside the single device's, each collective's ms and each
             rank's peak memory.
13. serve_mesh: the OpenAI server on a mesh (``parallel/multihost.py``):
             Llama-3.1-8B fp8 at full width and depth (random weights
             drawn one layer at a time, as phase 12's), ranks sharing
             cuda:0 over gloo (kernels built here first), world (i) tp 2
             on the pipelined step and world (ii) sp 2 x tp 2 with shift
             and suffix speculation on the fused loop.  Rank 0 serves
             HTTP and broadcasts every device step; the others replay
             them.  (a) A 128- and a 1024-token prompt, each sent alone
             (16 greedy tokens): the served tokens equal ``LLM.
             generate``'s step loop on the same engines, exactly (the
             same program).  (b) 8 prompts of 128-1024 tokens x 16 sent
             at once: every request completes, each follower replayed as
             many dispatches as the leader ran, every rank's digest of
             its output vectors is equal; TTFT / TPOT p50 and tok/s
             (gloo, host-staged, one card).  (c) World (ii): the last
             (a) prompt again, its continuation in the suffix cache: fused
             steps and drafts, each fused step replayed on every
             follower.  (d) Kernels 1, 2 and 5 launched on every rank.
14. mesh_models: SwiftKV, Mixtral (expert parallelism), token trees
             and guided decoding on meshes, ranks of one four-rank
             world sharing cuda:0 over gloo (its first two ranks make
             the tp 2 meshes).  First row R (fp8) on a rank's
             Mixtral-8x7B expert stacks ([4, ...] at tp 2, [2, ...] in
             the shift program; 128 and 512 rows, every row of the step
             with the other ranks' experts' rows clamped in), kernel 5 on
             SwiftKV-8B's fused K / V piece ([4096, 16384] and [4096,
             8192]; 16 and 2048 rows) and kernel 1t on the tree verify
             step at a rank's heads, against their plain versions, timed
             beside the bound and ``torch._grouped_mm`` / ``torch.mm`` /
             masked SDPA.  Then each model on one device (its logits and
             pages on 2 prompts, prefilled in the SP program and decoded
             one token in the shift one, written as references; the same
             through the plain matmuls: its noise floor) and on its
             worlds, each rank's logits, pages and tokens held against
             it (the bounds :func:`floor_bounds` sets from phase 12's
             and that floor): (a) Llama-3.1-SwiftKV-8B fp8 at 32 layers
             (16 on the projected KV), 8 prompts of 128-1024 tokens x
             16, on tp 2 (pipelined) and on sp 2 x tp 2 with shift and
             suffix decoding on the fused loop (the cache seeded from the
             single device's tokens), layer 31's pages those of the
             later layers' projection; (b) Mixtral-8x7B fp8 at 32 layers
             on tp 2 (4 experts a rank) and at 16 on sp 2 x tp 2 with
             shift (2 experts a rank in the shift program), its routers
             forced onto the single device's experts for the checks,
             held to the single device with the rounding of the world's
             row-parallel sums (the expert block's and attention's output
             projection's: each rank's share rounded to bf16, then the
             shares added), whose own reading against the plain single
             device is printed beside, 4 prompts x 16; (c) token trees
             on sp 2 x tp 2 with shift, Llama-3.1-8B fp8 at 32 layers, 4
             prompts x 16, the suffix cache seeded as phase 5 seeds it:
             drafts verified and
             accepted on every rank, the tokens the single device's tree
             run's up to a near tie (a parting only where its top-2
             margin is within twice the world's largest logits
             difference); (d) one guided request (a date) on world (a)
             tp 2's pipelined step, each rank's grammar pool, the tokens
             the single device's up to a near tie.  Every rank's tokens
             equal; kernels 1 (1t for trees), 2, 5 and R launched on
             every rank where the world's path runs them; step ms by
             mode, init seconds and peak memory per rank (gloo,
             host-staged, one card).
Last, one BERT-base device batch of phase 9 (64 x 512 tokens), a
shorter bf16 and fp8 run of phase 5, the drafter chains and the bench's
device step (its CUDA graph) under ``torch.profiler``, each on an engine
of its own (no timed run follows a profiled one); the device step must
launch no split-K reduction of the quantized matmuls.

The bench's JSON line comes before the kernels JSON; the last lines are
the kernels JSON, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Any failed check exits non-zero; the
script needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
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
# mistralai/Mixtral-8x7B-v0.1 (its config.json): 8 experts, top-2 (its
# 4096-token sliding window is not applied, as in the JAX package).
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-5,
    max_position_embeddings=32768, tie_word_embeddings=False,
    num_local_experts=8, num_experts_per_tok=2)
# Architecture (registry name) and dims of each model the script drives.
MODELS = {"llama-3.1-8b": ("llama", LLAMA_8B),
          "llama-3.1-swiftkv-8b": ("llama_swiftkv", LLAMA_SWIFTKV_8B),
          "qwen2.5-7b": ("qwen2", QWEN25_7B),
          "qwen3-8b": ("qwen3", QWEN3_8B),
          "mixtral-8x7b": ("mixtral", MIXTRAL_8X7B)}
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

PHASES = ("device", "build", "kernels", "forward", "generate", "bench",
          "pipeline", "serve", "embed", "quality", "moe", "parallel",
          "serve_mesh", "mesh_models")
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
# The LM head's rows: the sampled rows of those decode batches, then echo
# scoring's chunks of the prompt rows (ModelRunner.SCORE_CHUNK = 256, the
# BM=128 plan with a float32 epilogue) and a ragged remainder of one.
LM_HEAD_ROWS = (16, 64, 256, 137)
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
# ---------------------------------------------------------------------------
# Phase 9: encoders, causal encode and the embedding fleet
# ---------------------------------------------------------------------------

# Snowflake/snowflake-arctic-embed-m-v1.5 (its config.json: BertModel) and
# Snowflake/snowflake-arctic-embed-l (BertModel at BERT-large's widths).
ARCTIC_EMBED_M = dict(
    vocab_size=30522, hidden_size=768, intermediate_size=3072,
    num_hidden_layers=12, num_attention_heads=12,
    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
    hidden_act="gelu", pad_token_id=0)
ARCTIC_EMBED_L = dict(ARCTIC_EMBED_M, hidden_size=1024,
                      intermediate_size=4096, num_hidden_layers=24,
                      num_attention_heads=16)
EMBED_PROMPTS = 256
CAUSAL_PROMPTS = 64
# Per-row cosine of each bf16 embedding against the float32 plain path on
# the same weights (BERT), and of the kernel route against the plain
# route on the same bf16 weights (32-layer Llama: both round each layer's
# output to bf16, in different summation orders).
EMBED_COS = 0.999
CAUSAL_COS = 0.99
FLEET_BENCH = dict(batch=64, concurrency=8, len_dist="uniform:64,512")
# When a replica is killed in the killed run (its seconds must exceed it).
KILL_AFTER_S = 0.5


def bert_config(dims, dtype="bfloat16"):
    from arcticinference_tpu_torch.config import (EngineConfig, ModelConfig,
                                                  SchedulerConfig)

    return EngineConfig(
        model=ModelConfig(model="bert", dtype=dtype, max_model_len=512,
                          hf_overrides=dims),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=16384))


def bert_flops(dims, lengths) -> float:
    """Flops of the real tokens' work: per layer and token the six
    projections (2 x (4 D^2 + 2 D F)), and per prompt of n tokens the
    two attention products (2 x 2 n^2 D)."""
    d, f = dims["hidden_size"], dims["intermediate_size"]
    per_layer = sum(2 * (4 * d * d + 2 * d * f) * n + 4 * n * n * d
                    for n in lengths)
    return float(dims["num_hidden_layers"] * per_layer)


def cosines(a, b) -> np.ndarray:
    a, b = np.stack(a).astype(np.float64), np.stack(b).astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def embed_bert(rng, name, dims) -> dict:
    """Phase 9 (a) for one width."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.utils import events_ms

    lengths = [int(n) for n in rng.integers(16, 513, EMBED_PROMPTS)]
    prompts = [[int(x) for x in rng.integers(1, dims["vocab_size"], n)]
               for n in lengths]
    llm = LLM(bert_config(dims), device="cuda")
    enc = llm.encoder
    batches = list(enc.batches(prompts))
    shapes = [enc.bucket(b) for b in batches]
    real = sum(lengths)
    res = dict(model=name, prompts=len(prompts), real_tokens=real,
               batches=len(batches),
               padding_share=sum(b * t for b, t in shapes) / real)
    bound_s = bert_flops(dims, lengths) / BF16_FLOP_PER_S
    res["bound_ktok_per_s"] = real / bound_s / 1e3
    params16 = enc.params
    params32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params16.items()}
    for pooling in ("cls", "mean"):
        llm.encode(prompt_token_ids=prompts[:8], pooling=pooling)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        embs = llm.encode(prompt_token_ids=prompts, pooling=pooling)
        wall = time.perf_counter() - t
        enc.params = params32
        try:
            ref = enc.encode(prompts, pooling=pooling)
        finally:
            enc.params = params16
        cos = cosines(embs, ref)
        res[pooling] = dict(ktok_per_s=real / wall / 1e3, wall_s=wall,
                            min_cos=float(cos.min()),
                            mean_cos=float(cos.mean()),
                            finite=bool(np.isfinite(np.stack(embs)).all()),
                            norm_max_dev=float(np.abs(np.linalg.norm(
                                np.stack(embs), axis=-1) - 1).max()))
    # Device ms of each bucket, mean pooling.
    per_bucket = {}
    for batch, (b, t) in zip(batches, shapes):
        key = f"{b}x{t}"
        if key in per_bucket:
            continue
        ids, mask = enc.inputs(batch)
        per_bucket[key] = dict(ms=events_ms(
            lambda: enc.pooled(ids, mask, "mean"), 3),
            bound_ms=bert_flops(dims, [len(x) for x in batch])
            / BF16_FLOP_PER_S * 1e3,
            padded_bound_ms=bert_flops(dims, [t] * b)
            / BF16_FLOP_PER_S * 1e3)
    res["device_ms_per_bucket"] = per_bucket
    res["device_ms_all_batches"] = sum(
        per_bucket[f"{b}x{t}"]["ms"] for b, t in shapes)
    res["device_ktok_per_s"] = real / res["device_ms_all_batches"]
    del llm, enc, params16, params32
    free_cuda_memory()
    ok = all(res[p]["finite"] and res[p]["min_cos"] >= EMBED_COS
             and res[p]["norm_max_dev"] < 1e-3 for p in ("cls", "mean"))
    log("  embed (a) " + json.dumps(dict(res, card=smi())))
    if not ok:
        raise AssertionError(f"BERT {name} against float32: {res}")
    return res


@contextlib.contextmanager
def plain_route(module):
    """The decoder's attention and matmuls through the kernels' plain
    versions (as phase 4 holds the logits)."""
    saved = module.make_attn_impl
    module.make_attn_impl = lambda *a, **kw: module.plain_attn
    try:
        with plain_matmuls():
            yield
    finally:
        module.make_attn_impl = saved


def embed_causal(rng) -> dict:
    """Phase 9 (b): Llama-3.1-8B fp8 at full depth."""
    import torch

    from arcticinference_tpu_torch import bench
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  SchedulerConfig)
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.utils import events_ms

    cfg = EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16",
                          max_model_len=2048, hf_overrides=LLAMA_8B,
                          quantization="fp8"),
        cache=CacheConfig(num_blocks=512),
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=8192))
    t = time.perf_counter()
    llm = LLM(cfg, device="cuda")
    res = dict(init_s=time.perf_counter() - t)
    eng = llm.engine
    lengths = [int(n) for n in rng.integers(128, 1025, CAUSAL_PROMPTS)]
    prompts = [[int(x) for x in rng.integers(1, 128000, n)]
               for n in lengths]
    llm.encode(prompt_token_ids=prompts[:2])            # warm
    torch.cuda.synchronize()
    reset_counts()
    embs, walls = {}, {}
    for pooling in ("last", "mean"):
        t = time.perf_counter()
        embs[pooling] = llm.encode(prompt_token_ids=prompts,
                                   pooling=pooling)
        walls[pooling] = time.perf_counter() - t
    torch.cuda.synchronize()
    launches = launch_counts()
    # Device batches of the run (the engine's split by tokens and seqs).
    n_batches, total = 1, 0
    for i, n in enumerate(lengths):
        if i and total + n > 8192:
            n_batches, total = n_batches + 1, 0
        total += n
    with plain_route(eng.runner.module):
        plain = {p: llm.encode(prompt_token_ids=prompts, pooling=p)
                 for p in ("last", "mean")}
    torch.cuda.synchronize()
    for p in ("last", "mean"):
        cos = cosines(embs[p], plain[p])
        res[p] = dict(wall_s=walls[p],
                      ktok_per_s=sum(lengths) / walls[p] / 1e3,
                      min_cos=float(cos.min()), mean_cos=float(cos.mean()),
                      finite=bool(np.isfinite(np.stack(embs[p])).all()))
    # A 2048-token pooled forward against the 2048-token prefill step.
    si, req = prefill_step_inputs(llm, DEVICE_PREFILL_TOKENS)
    try:
        inputs = eng.runner.upload(si.arrays)
        res["encode_2048_ms"] = events_ms(
            lambda: eng.runner.pooled(inputs, si.attn_qb, "mean"), 5)
        graph = bench.capture_step_graph(eng.runner, si, eng._generator)
        res["prefill_2048_graph_ms"] = events_ms(graph.replay, 5)
        del graph
    finally:
        eng.scheduler.block_manager.free(req.block_ids)
    res.update(prompts=len(prompts), tokens=sum(lengths),
               device_batches=n_batches,
               launches={k: launches[k] for k in (
                   "ragged_paged_attention_kernel",
                   "grouped_decode_attention_kernel", "fp8_matmul_kernel")})
    llm.close()
    del llm, eng
    free_cuda_memory()
    log("  embed (b) " + json.dumps(dict(res, card=smi())))
    nl = LLAMA_8B["num_hidden_layers"]
    want = {"ragged_paged_attention_kernel": 2 * n_batches * nl,
            "grouped_decode_attention_kernel": 0,
            "fp8_matmul_kernel": 2 * n_batches * 4 * nl}
    ok = (res["launches"] == want
          and all(res[p]["finite"] and res[p]["min_cos"] >= CAUSAL_COS
                  for p in ("last", "mean")))
    if not ok:
        raise AssertionError(f"causal encode: {res}, launches wanted "
                             f"{want}")
    res["launch_counts"] = launches
    return res


def start_fleet(cfg_path, replicas, workdir, tag):
    port, base = free_port(), free_port()
    log_path = os.path.join(workdir, f"manager_{tag}.log")
    proc = start_process(
        [sys.executable, "-m", "arcticinference_tpu_torch", "embed",
         "--port", str(port), "--replica-base-port", str(base),
         "--num-replicas", str(replicas), "--config", cfg_path,
         "--host", "127.0.0.1"], log_path)
    return dict(proc=proc, port=port, log=log_path, replicas=replicas,
                target=f"127.0.0.1:{port}", started=time.perf_counter())


def wait_fleet(fleet, timeout: float) -> float:
    """Seconds from the manager's start to its ready line."""
    while True:
        text = Path(fleet["log"]).read_text()
        if "manager ready" in text:
            fleet["pids"] = [int(x.split(")")[0]) for x in
                             text.split("(pid ")[1:]]
            return time.perf_counter() - fleet["started"]
        if fleet["proc"].poll() is not None or \
                time.perf_counter() - fleet["started"] > timeout:
            raise AssertionError(f"fleet {fleet['target']} not ready:\n"
                                 + text[-4000:])
        time.sleep(0.2)


def fleet_bench(fleet, iters: int) -> dict:
    """The port's embedding bench against ``fleet``, with the manager's
    summed counters before and after."""
    from arcticinference_tpu_torch.benchmarks import embedding_bench
    from arcticinference_tpu_torch.embedding.client import InferenceClient

    client = InferenceClient(fleet["target"])
    before = client.info()
    res, = embedding_bench.main([
        "--target", fleet["target"], "--batch-sizes",
        str(FLEET_BENCH["batch"]), "--concurrency",
        str(FLEET_BENCH["concurrency"]), "--iters", str(iters),
        "--len-dist", FLEET_BENCH["len_dist"]])
    after = client.info()
    res["info_requests"] = after.total_requests - before.total_requests
    res["info_tokens"] = after.total_tokens - before.total_tokens
    res["replicas"] = fleet["replicas"]
    return res


def embed_fleet(workdir) -> dict:
    """Phase 9 (c)."""
    from arcticinference_tpu_torch.embedding import wire
    from arcticinference_tpu_torch.embedding.client import InferenceClient
    from arcticinference_tpu_torch.embedding.transport import (RpcError,
                                                               StatusCode)

    cfg_path = os.path.join(workdir, "bert_base.json")
    Path(cfg_path).write_text(json.dumps(bert_config(ARCTIC_EMBED_M)
                                         .to_dict()))
    fleets = {n: start_fleet(cfg_path, n, workdir, n) for n in (1, 2)}
    out: dict = {"runs": []}
    try:
        out["ready_s"] = {n: wait_fleet(f, 300) for n, f in fleets.items()}
        for n in (1, 2):                           # warm-up
            fleet_bench(fleets[n], 1)
        for n in (1, 2, 2, 1):
            r = fleet_bench(fleets[n], 4)
            r["card"] = smi()
            log("  embed (c) bench " + json.dumps(r))
            out["runs"].append(r)
        # A request without input, then a good one at once: INVALID_ARGUMENT
        # for the first, an answer for the second, every time.
        client = InferenceClient(fleets[2]["target"])
        bad = []
        for i in range(4):
            try:
                client.stub.Encode(wire.EncodeRequest(request_id=f"bad{i}"),
                                   timeout=30)
                bad.append("answered")
            except RpcError as e:
                bad.append(int(e.code()))
            t = time.perf_counter()
            embs = client.embed(token_ids=[[1, 2, 3] * 30] * 4)
            bad.append(round((time.perf_counter() - t) * 1e3, 3)
                       if len(embs) == 4 else "short")
        out["bad_then_good"] = bad
        # Kill one replica of the 2-replica fleet during a run.
        killer = threading.Timer(KILL_AFTER_S, os.kill,
                                 (fleets[2]["pids"][0], signal.SIGKILL))
        killer.start()
        try:
            r = fleet_bench(fleets[2], 8)
        finally:
            killer.join()
        r["killed_pid"] = fleets[2]["pids"][0]
        r["killed_after_s"] = KILL_AFTER_S
        out["killed_run"] = r
        log("  embed (c) killed run " + json.dumps(dict(r, card=smi())))
        out["health_after_kill"] = client.health()
    finally:
        for f in fleets.values():
            f["exit_s"] = stop_process(f["proc"], 60)
            f["exit_code"] = f["proc"].returncode
    out["exit"] = {n: (f["exit_s"], f["exit_code"])
                   for n, f in fleets.items()}
    log("  embed (c) " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("runs", "killed_run")}))
    killed = out["killed_run"]
    # Counters: every request of a run counted once (the killed replica's
    # own counters leave the sum with it, so not in the killed run).
    ok = (all(r["info_requests"] == r["requests"] == r["concurrency"] * 4
              and r["info_tokens"] == r["tokens"] for r in out["runs"])
          and killed["requests"] == killed["concurrency"] * 8
          and killed["seconds"] > KILL_AFTER_S
          and bad[0::2] == [int(StatusCode.INVALID_ARGUMENT)] * 4
          and all(isinstance(x, float) for x in bad[1::2])
          and out["health_after_kill"]
          and all(f["exit_s"] < 60 for f in fleets.values()))
    if not ok:
        raise AssertionError(f"embedding fleet: {out}")
    return out


def profile_bert() -> dict:
    """One BERT-base device batch (64 x 512 tokens, mean pooling) under
    ``torch.profiler``: device ms per call and the heaviest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arcticinference_tpu_torch.engine.encoder import EncoderRunner

    enc = EncoderRunner(bert_config(ARCTIC_EMBED_M), device="cuda")
    rng = np.random.default_rng(5)
    batch = [[int(x) for x in rng.integers(1, 30000, n)]
             for n in rng.integers(16, 513, 64)]
    ids, mask = enc.inputs(batch)
    enc.pooled(ids, mask, "mean")
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            enc.pooled(ids, mask, "mean")
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / calls
    del enc
    free_cuda_memory()
    if busy == 0:
        return dict(device_ms="not measured")
    return dict(batch=list(ids.shape), device_ms_per_call=busy,
                top=[dict(kernel=e.key[:90],
                          ms_per_call=e.self_device_time_total / 1e3
                          / calls) for e in events[:12]])


def phase_embed(rng) -> dict:
    """Phase 9 (see the module docstring): parts (a), (b) and (c)."""
    t = time.perf_counter()
    bert = {name: embed_bert(rng, name, dims) for name, dims in (
        ("arctic-embed-m-v1.5", ARCTIC_EMBED_M),
        ("arctic-embed-l", ARCTIC_EMBED_L))}
    log(f"[embed] (a) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    causal = embed_causal(rng)
    log(f"[embed] (b) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="embed_phase_") as workdir:
        fleet = embed_fleet(workdir)
    log(f"[embed] (c) {time.perf_counter() - t:.1f} s")
    return dict(bert=bert, causal=causal, fleet=fleet,
                launches=causal["launch_counts"])


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
    with scattered page ids, ``hq`` q heads over ``hkv`` kv heads of
    ``d``; everything on the card."""

    def __init__(self, name, reqs, kv_dtype, rng, t_pad=None, slot_rows=0,
                 layer=17, layers=None, n_blocks=None, hq=HQ, hkv=HKV,
                 d=D):
        import torch

        self.name, self.reqs, self.layer = name, reqs, layer
        self.hq, self.hkv, self.d = hq, hkv, d
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
        kv = torch.randn((layers, n_blocks, 2, BS, hkv * d), device=dev,
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
        self.q = torch.randn((t, hq, d), device=dev,
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
        kv_bytes = int(self.seq_np.sum()) * 2 * self.hkv * self.d * kv_elem
        io_bytes = (int(live.sum()) + self.t) * self.hq * self.d * 2
        flops = 4.0 * self.d * self.hq * float(self.attended(live).sum())
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
            qd = torch.empty((n, hkv, ql * g, self.d), device="cuda",
                             dtype=torch.bfloat16)
            kd = torch.zeros((n, hkv, s_max, self.d), device="cuda",
                             dtype=torch.bfloat16)
            vd = torch.zeros_like(kd)
            mask = torch.zeros((n, 1, ql * g, s_max), device="cuda",
                               dtype=torch.bool)
            for i, r in enumerate(rs):
                c = self.reqs[r][0]
                s = c + ql
                pg = self.block_tables[r, :-(-s // BS)].long()
                kd[i, :, :s] = (kv_l[pg, 0].reshape(-1, hkv, self.d)[:s]
                                * ks[0]).transpose(0, 1)
                vd[i, :, :s] = (kv_l[pg, 1].reshape(-1, hkv, self.d)[:s]
                                * ks[1]).transpose(0, 1)
                rows_np = np.nonzero(self.req_np == r)[0]
                rows = torch.from_numpy(rows_np)
                # [ql, Hq, D] -> [Hkv, ql * g, D]: row = token * g + head.
                qd[i] = self.q[rows.cuda()].view(
                    ql, hkv, g, self.d).transpose(0, 1).reshape(
                    hkv, ql * g, self.d)
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

    def __init__(self, name, tree_reqs, kv_dtype, rng, t_pad, **kw):
        import torch

        from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
            tree_masks)

        n_new = [c + len(p or ()) for _, c, p in tree_reqs]
        super().__init__(name, [(ctx, n) for (ctx, _, _), n in
                                zip(tree_reqs, n_new)], kv_dtype, rng,
                         t_pad=t_pad, **kw)
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


_SASS: dict = {}


def sass_text(lib) -> str:
    """The library's SASS (``cuobjdump -sass``, read once); raises if
    the tool is missing."""
    from arcticinference_tpu_torch.ops.cuda import build

    key = str(lib)
    if key not in _SASS:
        tool = Path(build.nvcc_path()).with_name("cuobjdump")
        if not tool.exists():
            raise AssertionError(
                f"cuobjdump not found beside nvcc ({tool})")
        _SASS[key] = subprocess.run(
            [str(tool), "-sass", key], capture_output=True, text=True,
            check=True).stdout
    return _SASS[key]


def read_sass(libs) -> None:
    """Every library's SASS at once, one ``cuobjdump`` each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(sass_text, libs))


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


def grouped_matmul_sass(lib) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instruction counts of each
    instance of the grouped MoE matmul (weight format, rows per tile,
    consumer warpgroups), read from the library's SASS."""
    import re

    counts, fn = {}, None
    for line in sass_text(lib).splitlines():
        if "Function :" in line:
            m = re.search(r"grouped_matmul_kernelI\w*?(Bf16|E4M3|Int8|Int4)"
                          r"ELi(\d+)ELi(\d+)E", line)
            fn = (f"{m.group(1)} BM={m.group(2)} WGS={m.group(3)}" if m
                  else None)
            if fn:
                counts[fn] = dict(HGMMA=0, HMMA=0)
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
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
            for m in LM_HEAD_ROWS if name == "lm_head" else MATMUL_ROWS:
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
    Qwen, SwiftKV and Mixtral modules share) and Mixtral's expert
    products through the kernels' plain versions."""
    from arcticinference_tpu_torch.models import llama, mixtral
    from arcticinference_tpu_torch.ops import fp8, moe

    saved = llama.matmul, mixtral.grouped_matmul
    llama.matmul = fp8.matmul_reference
    mixtral.grouped_matmul = moe.grouped_matmul_plain
    try:
        yield
    finally:
        llama.matmul, mixtral.grouped_matmul = saved


def reset_counts() -> None:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    ra.reset_launch_counts()
    fm.reset_launch_counts()
    im.reset_launch_counts()
    hp.reset_launch_counts()
    sm.reset_launch_counts()
    gm.reset_launch_counts()


def launch_counts() -> dict:
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
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
            "stream_matmul_kernel": sm.stream_matmul_launches,
            "grouped_matmul_kernel": gm.grouped_matmul_launches}


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


def graph_profile(llm, batch: int, ctx: int, replays: int) -> tuple:
    """The decode step of ``llm`` at (``batch``, ``ctx``) as a CUDA graph,
    replayed ``replays`` times under ``torch.profiler``: (device events by
    self time, busy ms per step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arcticinference_tpu_torch import bench

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
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    return events, sum(e.self_device_time_total
                       for e in events) / 1e3 / replays


def profile_device_step(batch: int = 64, ctx: int = 192,
                        replays: int = 10) -> dict:
    """Device time by kernel of the bench's decode step (fp8 Llama-3.1-8B
    at (``batch``, ``ctx``), the CUDA graph the bench times) over
    ``replays`` replays under ``torch.profiler``: where the device step's
    time goes.  A measurement, not a check: an empty trace reads "not
    measured"."""
    from arcticinference_tpu_torch.benchmarks.distill_drafter import (
        LLAMA_8B as BENCH_8B, engine_config, free_llm)
    from arcticinference_tpu_torch.engine.llm import LLM

    llm = LLM(engine_config(BENCH_8B, True, batch))
    events, busy_ms = graph_profile(llm, batch, ctx, replays)
    free_llm(llm)
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
    # The bench's spec_transfer block runs in phase 10, through the same
    # function (bench.spec_transfer), on the checkpoint trained there.
    out = bench.run_bench("cuda", curve_rates=BENCH_CURVE_RATES,
                          transfer=False)
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
        # These runs time and break down the synchronous step
        # (``host_breakdown``); the pipeline phase runs the pipelined one.
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_num_batched_tokens=2048,
                                  async_scheduling=False),
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


# The pipeline phase: 32 prompts of 64-1024 tokens, 64 new tokens each;
# the guided runs 32 requests of 48 tokens over three grammars and
# unguided requests.
PIPELINE_PROMPTS, PIPELINE_NEW, GUIDED_NEW = 32, 64, 48
# Alternating pipelined / synchronous timing pairs (greedy).
PIPELINE_PAIRS = 3
# The second schema of tests/test_guided_dfa.py (a bounded string and
# an array of enums), a date and a 5-way choice.
GUIDED_SPECS = (
    ("schema", {"json": {
        "type": "object",
        "properties": {"name": {"type": "string", "maxLength": 8},
                       "tags": {"type": "array",
                                "items": {"enum": ["x", "y"]},
                                "maxItems": 3}},
        "required": ["name"]}}),
    ("date", {"regex": r"\d{4}-\d{2}-\d{2}"}),
    ("choice", {"choice": ["positive", "negative", "neutral", "mixed",
                           "unknown"]}),
)


class SyntheticTokenizer:
    """A tokenizer of Llama-3.1's vocabulary size (128256) made from a
    fixed seed: ids 0-255 are single characters (printable ASCII first),
    ids 256-127999 strings of 2-12 characters over printable ASCII with
    extra JSON punctuation (a third with a leading space), and ids
    128000-128255 special tokens that decode to "" (Llama-3.1's
    ``eos_token_id`` 128001 among them).  It gives the token sweeper and
    the device pool a real vocabulary width; no tokenizer of a supported
    model is in the repository."""

    eos_token_id = 128001

    def __init__(self, vocab_size: int = 128256, seed: int = 0):
        rng = np.random.default_rng(seed)
        singles = [chr(c) for c in range(32, 127)] + ["\n", "\t"]
        singles += [chr(0xA1 + i) for i in range(256 - len(singles))]
        alphabet = np.array(list(
            "".join(chr(c) for c in range(32, 127)) + '{}[]":,' * 4))
        n = 128000 - 256
        lens = rng.integers(2, 13, n)
        chars = rng.choice(alphabet, int(lens.sum()))
        space = rng.random(n) < 1 / 3
        words, k = [], 0
        for ln, sp in zip(lens, space):
            w = "".join(chars[k:k + ln])
            k += ln
            words.append(" " + w[1:] if sp else w)
        self.vocab = singles + words + [""] * (vocab_size - 128000)
        self._char_ids = {c: i for i, c in enumerate(self.vocab[:256])}

    def __len__(self):
        return len(self.vocab)

    def decode(self, ids, **kw):
        return "".join(self.vocab[i] for i in ids)

    def encode(self, text, **kw):
        """Each character to its single-character id (ids 0-255): what
        chat prompts and Dynasor's text prompts need."""
        return [self._char_ids[c] for c in text]


@contextlib.contextmanager
def pipeline_recorder(llm):
    """Record each engine step's wall time and each produced token's step
    shape (t_pad, s_pad, attn_qb), and run every pipelined pure-decode
    dispatch, with the copy of its output vector, under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    there raises.  Yields a dict of lists and counts."""
    import torch

    from arcticinference_tpu_torch.engine import engine as engine_mod

    eng = llm.engine
    runner = eng.runner
    prep, dispatch, step = runner.prepare_inputs, runner.dispatch, eng.step
    inflight_cls = engine_mod._InflightStep
    rec = dict(steps=[], shapes={}, dispatches=0, checked=0,
               checked_guided=0, guided_dispatches=0, prepare=[])
    cur = {}

    def recorded_prepare(sched_out, *a, **k):
        t = time.perf_counter()
        si = prep(sched_out, *a, **k)
        rec["prepare"].append((time.perf_counter() - t,
                               "guided_mask" in si.arrays))
        shape = (si.t_pad, si.s_pad, si.attn_qb)
        cur["qb"] = si.attn_qb
        for s in sched_out.scheduled:
            req = s.request
            if req.num_computed_tokens + s.num_new_tokens >= req.num_tokens:
                rec["shapes"][(req.req_id, len(req.output_token_ids))] = \
                    shape
        return si

    def checked_dispatch(si, *a, **k):
        rec["dispatches"] += 1
        guided = "gd_slot" in si.arrays
        rec["guided_dispatches"] += guided
        if not (eng._pipeline and si.attn_qb == 1):
            return dispatch(si, *a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(si, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rec["checked"] += 1
        rec["checked_guided"] += guided
        return out

    class CheckedInflight(inflight_cls):
        def __init__(self, *a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super().__init__(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    def timed_step():
        cur["qb"] = None
        t = time.perf_counter()
        out = step()
        rec["steps"].append((time.perf_counter() - t, cur["qb"]))
        return out

    runner.prepare_inputs, runner.dispatch = recorded_prepare, \
        checked_dispatch
    eng.step = timed_step
    engine_mod._InflightStep = CheckedInflight
    try:
        yield rec
    finally:
        del runner.prepare_inputs, runner.dispatch, eng.step
        engine_mod._InflightStep = inflight_cls


def pipeline_run(llm, prompts, params, pipelined: bool) -> tuple:
    """One ``generate`` with the pipelined step on or off, on ``llm``'s
    engine; returns (result, outputs, recorder)."""
    import torch

    from arcticinference_tpu_torch.stats import StepTimeStats

    eng = llm.engine
    eng._pipeline = pipelined
    eng.step_times = StepTimeStats()
    steps0 = eng.engine_stats.num_steps
    reset_counts()
    t0 = time.perf_counter()
    with pipeline_recorder(llm) as rec:
        outs = llm.generate(prompt_token_ids=prompts, sampling_params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds = dict(eng.step_times._counts)
    decode = [t for t, qb in rec["steps"] if qb == 1]
    res = dict(pipelined=pipelined, wall_s=wall, kinds=kinds,
               engine_steps=eng.engine_stats.num_steps - steps0,
               dispatches=rec["dispatches"],
               sync_checked_dispatches=rec["checked"],
               decode_steps=len(decode),
               decode_step_ms=float(np.median(decode)) * 1e3
               if decode else None,
               tokens=sum(len(o.token_ids) for o in outs),
               launches=launch_counts())
    if ("pipelined" in kinds) != pipelined or \
            any(o.finish_reason == "finished_aborted" for o in outs):
        raise AssertionError(f"pipeline run failed: {res}")
    if pipelined and rec["checked"] == 0:
        raise AssertionError("no pipelined decode dispatch was checked")
    if eng._inflight or eng._pending_ref:
        raise AssertionError("steps left in flight after generate")
    return res, outs, rec


def divergence(pipe, sync, rec_p, rec_s) -> dict:
    """Token agreement of two runs and, per request, the first position
    where they differ and whether some step up to it ran at another
    shape (t_pad, s_pad, attn_qb) in the two runs."""
    firsts = []
    for a, b in zip(pipe, sync):
        if a.token_ids == b.token_ids:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.token_ids,
                                                   b.token_ids)) if x != y),
                 min(len(a.token_ids), len(b.token_ids)))
        shape_differs = any(
            rec_p["shapes"].get((a.req_id, i)) !=
            rec_s["shapes"].get((b.req_id, i)) for i in range(j + 1))
        firsts.append(dict(position=j, shape_differs=shape_differs))
    return dict(agree=len(pipe) - len(firsts), requests=len(pipe),
                first_divergence=min((f["position"] for f in firsts),
                                     default=None),
                divergences=firsts)


def phase_pipeline(rng) -> dict:
    """The pipelined step (the JAX engine's default) against the
    synchronous one on one Llama-3.1-8B engine (full width and depth,
    random weights, prefix caching off), bf16 then fp8: greedy and
    seeded tokens, decode-phase step wall times, every pipelined decode
    dispatch under the sync check; then guided decoding on the fp8
    engine over :class:`SyntheticTokenizer`: three grammars compiled
    with the native sweeper, their tables uploaded into the device
    pool, 32 requests through the pool (pipelined) and through host
    masks (synchronous).  Returns {run: result}."""
    import dataclasses

    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    prompts = [[int(x) for x in rng.integers(0, LLAMA_8B["vocab_size"],
                                             int(n))]
               for n in rng.integers(64, 1025, PIPELINE_PROMPTS)]
    greedy = SamplingParams(max_tokens=PIPELINE_NEW, ignore_eos=True)
    seeded = [SamplingParams(max_tokens=PIPELINE_NEW, ignore_eos=True,
                             temperature=0.8, seed=i)
              for i in range(PIPELINE_PROMPTS)]
    runs = {}
    for quantization in (None, "fp8"):
        name = quantization or "bf16"
        cfg = engine_config(quantization)
        cfg = dataclasses.replace(
            cfg, cache=dataclasses.replace(cfg.cache,
                                           enable_prefix_caching=False),
            scheduler=dataclasses.replace(cfg.scheduler,
                                          async_scheduling=True))
        t0 = time.perf_counter()
        llm = LLM(cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pairs = []
        for _ in range(PIPELINE_PAIRS):
            pipe, outs_p, rec_p = pipeline_run(llm, prompts, greedy, True)
            sync, outs_s, rec_s = pipeline_run(llm, prompts, greedy, False)
            pairs.append((pipe, sync, divergence(outs_p, outs_s, rec_p,
                                                 rec_s)))
        pipe_s, outs_p, rec_p = pipeline_run(llm, prompts, seeded, True)
        sync_s, outs_s, rec_s = pipeline_run(llm, prompts, seeded, False)
        div_seeded = divergence(outs_p, outs_s, rec_p, rec_s)
        pipe, sync, div = pairs[0]
        per_step = matmul_launches_per_step(llm.engine.arch)
        res = dict(
            model="llama-3.1-8b", quantization=name, init_s=init_s,
            greedy=div, seeded=div_seeded,
            greedy_agree_per_pair=[d["agree"] for _, _, d in pairs],
            decode_step_ms=dict(
                pipelined=[p["decode_step_ms"] for p, _, _ in pairs],
                sync=[q["decode_step_ms"] for _, q, _ in pairs],
                pipelined_median=float(np.median(
                    [p["decode_step_ms"] for p, _, _ in pairs])),
                sync_median=float(np.median(
                    [q["decode_step_ms"] for _, q, _ in pairs]))),
            wall_s=dict(pipelined=[p["wall_s"] for p, _, _ in pairs],
                        sync=[q["wall_s"] for _, q, _ in pairs]),
            runs=dict(greedy_pipelined=pipe, greedy_sync=sync,
                      seeded_pipelined=pipe_s, seeded_sync=sync_s),
            card=smi())
        res["ratio_pipelined_to_sync"] = (
            res["decode_step_ms"]["pipelined_median"]
            / res["decode_step_ms"]["sync_median"])
        log(f"  pipeline {name} " + json.dumps(res))
        ok = all(p["launches"]["ragged_paged_attention_kernel"] > 0
                 and p["launches"]["grouped_decode_attention_kernel"] > 0
                 for p in (pipe, sync, pipe_s, sync_s))
        if quantization:
            # fp8: kernel 5's rows are bit for bit whatever their
            # neighbours, so the two steps give the same tokens; every
            # dispatch launches it 129 times.
            ok = ok and all(d["agree"] == PIPELINE_PROMPTS
                            for _, _, d in pairs) \
                and div_seeded["agree"] == PIPELINE_PROMPTS
            ok = ok and all(
                r["launches"]["fp8_matmul_kernel"]
                == per_step * r["dispatches"]
                for r in (pipe, sync, pipe_s, sync_s))
        else:
            # bf16: cuBLAS picks its algorithm by shape, so a divergence
            # is allowed where the two runs' step shapes differ.
            ok = ok and all(f["shape_differs"]
                            for d in [d for _, _, d in pairs] + [div_seeded]
                            for f in d["divergences"])
        if not ok:
            raise AssertionError(f"pipeline check failed: {res}")
        runs[name] = res
        if quantization:
            runs["guided"] = phase_guided(llm)
        llm.close()
        del llm
        free_cuda_memory()
    return runs


def phase_guided(llm) -> dict:
    """Guided decoding on ``llm`` (fp8) over a synthetic 128256-token
    vocabulary: compile time, DFA states and transitions of each grammar,
    its pool upload time; 32 requests (8 per grammar and 8 unguided, half
    greedy, half seeded at temperature 1.0) through the device pool and
    through host masks, held against each other and their grammars."""
    import torch

    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.serving import guided_dfa
    from arcticinference_tpu_torch.serving.structured import (
        make_guided_decoder)

    eng = llm.engine
    vocab = eng.arch.vocab_size
    t0 = time.perf_counter()
    tok = SyntheticTokenizer(vocab)
    tok_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    guided_dfa.vocab_codepoints(tok, vocab)
    vocab_s = time.perf_counter() - t0
    grammars, decoders = {}, {}
    for name, spec in GUIDED_SPECS:
        t0 = time.perf_counter()
        dec = make_guided_decoder(tok, spec, vocab_size=vocab)
        compile_s = time.perf_counter() - t0
        if not isinstance(dec, guided_dfa.DfaGuidedDecoder) or \
                dec.index._handle is None:
            raise AssertionError(f"{name}: no native DFA decoder ({dec})")
        dfa = dec.index.dfa
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._guided_slot(dec)
        torch.cuda.synchronize()
        grammars[name] = dict(
            compile_s=compile_s, states=dfa.n_states,
            transitions=len(dfa.trans_lo),
            fits_pool=eng.runner.guided_fits_pool(dec.index),
            pool_upload_ms=(time.perf_counter() - t0) * 1e3)
        decoders[name] = dec
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(0, 128000, int(n))]
               for n in rng.integers(64, 257, 32)]
    groups = [name for name, _ in GUIDED_SPECS] + [None]

    def params():
        out = []
        for i in range(32):
            g = groups[i // 8]
            out.append(SamplingParams(
                max_tokens=GUIDED_NEW, temperature=1.0 * (i % 2),
                seed=1000 + i if i % 2 else None,
                guided=None if g is None else decoders[g].clone()))
        return out

    mask_time = [0.0, 0]
    mask_words = guided_dfa.DfaGuidedDecoder.mask_words

    def timed_mask_words(self):
        t = time.perf_counter()
        m = mask_words(self)
        mask_time[0] += time.perf_counter() - t
        mask_time[1] += 1
        return m

    pipe, outs_p, rec_p = pipeline_run(llm, prompts, params(), True)
    guided_dfa.DfaGuidedDecoder.mask_words = timed_mask_words
    try:
        sync, outs_s, rec_s = pipeline_run(llm, prompts, params(), False)
    finally:
        guided_dfa.DfaGuidedDecoder.mask_words = mask_words
    mask_steps = [t for t, has in rec_s["prepare"] if has]
    plain_steps = [t for t, has in rec_p["prepare"]]
    checks = []
    for i, (a, b) in enumerate(zip(outs_p, outs_s)):
        g = groups[i // 8]
        if g is None:
            continue
        idx = decoders[g].index
        st = idx.dfa.start
        for t in a.token_ids:
            st = idx.advance(st, t)
            if st < 0:
                break
        done = a.finish_reason == "finished_stopped"
        parsed = None
        if done and g == "schema":
            parsed = json.loads(tok.decode(a.token_ids))
        checks.append(dict(group=g, alive=st >= 0,
                           finished=done, accepting=idx.is_accept(st),
                           text=tok.decode(a.token_ids)[:40],
                           json=parsed is not None))
    res = dict(
        tokenizer_s=tok_s, vocab_table_s=vocab_s, grammars=grammars,
        pipelined=pipe, sync=sync,
        guided_dispatches=rec_p["guided_dispatches"],
        sync_checked_guided_dispatches=rec_p["checked_guided"],
        tokens_equal=[a.token_ids == b.token_ids
                      for a, b in zip(outs_p, outs_s)].count(True),
        sync_mask_steps=len(mask_steps),
        sync_prepare_ms_p50=float(np.median(mask_steps)) * 1e3
        if mask_steps else None,
        pipelined_prepare_ms_p50=float(np.median(plain_steps)) * 1e3,
        sync_mask_words_ms_per_step=(mask_time[0] / len(mask_steps) * 1e3
                                     if mask_steps else None),
        finished=sum(c["finished"] for c in checks),
        outputs=checks, card=smi())
    log("  guided " + json.dumps(res))
    ok = (all(g["fits_pool"] for g in grammars.values())
          and res["guided_dispatches"] > 0
          and res["sync_checked_guided_dispatches"] > 0
          and res["tokens_equal"] == 32 and res["sync_mask_steps"] > 0
          and all(c["alive"] and (c["accepting"] or not c["finished"])
                  for c in checks)
          and all(c["json"] for c in checks
                  if c["group"] == "schema" and c["finished"]))
    if not ok:
        raise AssertionError(f"guided check failed: {res}")
    return res

# The serve phase: serve_bench's baseline config behind the OpenAI server;
# 4 sequential completions, bursts of 32 arriving 25 ms apart, 64 tokens
# each.
SERVE_SEQUENTIAL, SERVE_BURST, SERVE_NEW, SERVE_ARRIVAL_S = 4, 32, 64, 0.025
# The CUDA kernels of kernels 1, 2 and 5 as a profiler trace names them.
SERVE_TRACE_KERNELS = {"ragged_paged_attention_kernel":
                           "ragged_attention_kernel",
                       "grouped_decode_attention_kernel":
                           "grouped_decode_kernel",
                       "fp8_matmul_kernel": "qmm_wgmma_kernel"}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_process(cmd, log_path):
    """``cmd`` in the repository root, its output into ``log_path``."""
    out = open(log_path, "w")
    try:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                cwd=str(Path(__file__).resolve().parent))
    finally:
        out.close()


def stop_process(proc, timeout: float) -> float:
    """SIGTERM, then wait up to ``timeout`` s (killed past it); returns
    the seconds it took to exit, inf when it had to be killed."""
    if proc.poll() is not None:
        return 0.0
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return float("inf")
    return time.perf_counter() - t0


async def wait_healthy(url, proc, log_path, timeout: float) -> float:
    from arcticinference_tpu_torch.serving import http

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"{url} exited ({proc.returncode}): "
                                 f"{Path(log_path).read_text()[-3000:]}")
        try:
            async with http.get(url + "/health", timeout=2) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except (OSError, EOFError, ValueError):
            pass
        await asyncio.sleep(0.5)
    raise AssertionError(f"{url} not healthy after {timeout} s: "
                         f"{Path(log_path).read_text()[-3000:]}")


async def get_json(url: str):
    from arcticinference_tpu_torch.serving import http

    async with http.get(url, timeout=60) as r:
        return r.status, await r.json()


async def completion(url: str, body: dict, stream: bool = False) -> dict:
    """One /v1/completions request, timed on the client: its tokens,
    finish reason, end-to-end seconds, and for a stream the time to its
    first token and the seconds between its first and last token."""
    from arcticinference_tpu_torch.serving import http

    t0 = time.perf_counter()
    res = dict(stream=stream, status=None, ids=[], finish=None)
    async with http.post(url + "/v1/completions",
                         json=dict(body, stream=stream), timeout=600) as r:
        res["status"] = r.status
        if not stream:
            data = await r.json()
            if r.status == 200:
                ch = data["choices"][0]
                res.update(ids=ch["token_ids"], finish=ch["finish_reason"],
                           usage=data["usage"], body=data)
            else:
                res["body"] = data
        else:
            times, done = [], False
            async for line in r.iter_lines():
                if not line.startswith(b"data: "):
                    continue
                payload = line[6:].strip()
                if payload == b"[DONE]":
                    done = True
                    continue
                ch = json.loads(payload)["choices"][0]
                if ch.get("token_ids"):
                    times.append(time.perf_counter())
                    res["ids"].extend(ch["token_ids"])
                res["finish"] = ch.get("finish_reason", res["finish"])
            res.update(done=done, ttft_s=times[0] - t0 if times else None,
                       decode_s=times[-1] - times[0] if times else None)
    res["t0"], res["t1"] = t0, time.perf_counter()
    return res


async def burst(url: str, prompts) -> dict:
    """The burst: one request per prompt, arriving SERVE_ARRIVAL_S apart,
    every other one streamed; each must finish with ``length`` and
    SERVE_NEW tokens.  Returns the client-side summary and results."""

    start = time.perf_counter()

    async def one(i, p):
        await asyncio.sleep(max(0.0, start + i * SERVE_ARRIVAL_S
                                - time.perf_counter()))
        return await completion(url, dict(
            prompt_token_ids=p, max_tokens=SERVE_NEW, ignore_eos=True),
            stream=i % 2 == 0)

    results = await asyncio.gather(*[one(i, p)
                                     for i, p in enumerate(prompts)])
    bad = [i for i, r in enumerate(results)
           if r["status"] != 200 or r["finish"] != "length"
           or len(r["ids"]) != SERVE_NEW
           or (r["stream"] and not r["done"])
           or (not r["stream"]
               and r["usage"]["completion_tokens"] != len(r["ids"]))]
    if bad:
        raise AssertionError(f"burst requests failed: "
                             f"{[results[i] for i in bad[:3]]}")
    streamed = [r for r in results if r["stream"]]
    ttft = np.array([r["ttft_s"] for r in streamed]) * 1e3
    tpot = [r["decode_s"] / (len(r["ids"]) - 1) * 1e3 for r in streamed]
    wall = max(r["t1"] for r in results) - min(r["t0"] for r in results)
    summary = dict(
        requests=len(results), streamed=len(streamed),
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p99_ms=float(np.percentile(ttft, 99)),
        tpot_mean_ms=float(np.mean(tpot)),
        e2e_p50_ms=float(np.median([(r["t1"] - r["t0"]) * 1e3
                                    for r in results])),
        output_tokens_per_s=sum(len(r["ids"]) for r in results) / wall,
        wall_s=wall)
    return summary


async def http_overhead(url: str, n: int = 50) -> dict:
    """Median client-side ms of GET /health and GET /v1/models over ``n``
    requests each (a new connection each): the HTTP layer's cost of a
    request with no engine work (through a router: plus its hop)."""
    out = {}
    for path in ("/health", "/v1/models"):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            status, _ = await get_json(url + path)
            times.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"GET {path}: {status}")
        out[path] = float(np.median(times))
    return out


async def disconnect_after_first_chunk(url: str) -> float:
    """A streamed client that closes its connection after the first
    chunk; returns the seconds until /metrics shows no running or waiting
    request (at most 5)."""
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    reader, writer = await asyncio.open_connection(parts.hostname,
                                                   parts.port)
    body = json.dumps(dict(prompt_token_ids=list(range(1000, 1256)),
                           max_tokens=2048, ignore_eos=True,
                           stream=True)).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    await writer.drain()
    await asyncio.wait_for(reader.readuntil(b"data: "), 120)
    writer.close()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 5.0:
        _, m = await get_json(url + "/metrics")
        if m["num_running"] == 0 and m["num_waiting"] == 0:
            return time.perf_counter() - t0
        await asyncio.sleep(0.05)
    raise AssertionError(f"disconnected request still running: {m}")


def trace_kernel_counts(trace_dir: str) -> dict:
    """Launches of each of kernels 1, 2 and 5 that the profiler's Chrome
    trace in ``trace_dir`` names, and the trace's kernel count."""
    paths = sorted(Path(trace_dir).glob("*.json"))
    if len(paths) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}: {paths}")
    events = json.loads(paths[0].read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    counts = {key: sum(sym in k for k in kernels)
              for key, sym in SERVE_TRACE_KERNELS.items()}
    counts["kernels"] = len(kernels)
    counts["trace_mb"] = paths[0].stat().st_size / 1e6
    return counts


def serve_part_a(cfg_path, prompts, workdir) -> dict:
    """Part (a): the server as a subprocess, driven over HTTP.
    ``prompts``: {"sequential", "bursts" (five of the same lengths, other
    tokens: no prefix-cache hits; a warm-up, then direct, router, router,
    direct), "echo", "profile"}."""
    seq_prompts, echo_prompts = prompts["sequential"], prompts["echo"]

    port, dead = free_port(), free_port()
    url = f"http://127.0.0.1:{port}"
    server_log = os.path.join(workdir, "server.log")
    server = start_process([sys.executable, "-m", "arcticinference_tpu_torch",
                            "serve", "--config", cfg_path, "--port",
                            str(port), "--host", "127.0.0.1"], server_log)
    res = dict(card=smi())
    router = None

    async def run():
        nonlocal router
        t = time.perf_counter()
        res["server_ready_s"] = await wait_healthy(url, server, server_log,
                                                   600)
        status, models = await get_json(url + "/v1/models")
        if status != 200 or models["data"][0]["object"] != "model":
            raise AssertionError(f"/v1/models: {status} {models}")
        seq = []
        for p in seq_prompts:
            r = await completion(url, dict(prompt_token_ids=p,
                                           max_tokens=SERVE_NEW,
                                           ignore_eos=True))
            if r["status"] != 200 or len(r["ids"]) != SERVE_NEW:
                raise AssertionError(f"sequential request failed: {r}")
            seq.append(r)
        res["sequential_ids"] = [r["ids"] for r in seq]
        res["sequential_e2e_ms"] = [(r["t1"] - r["t0"]) * 1e3 for r in seq]
        res["sequential_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["warmup_burst"] = await burst(url, prompts["bursts"][0])
        res["burst"] = await burst(url, prompts["bursts"][1])
        res["burst_s"] = time.perf_counter() - t
        res["http_ms"] = await http_overhead(url)
        t = time.perf_counter()
        echo = []
        for p in echo_prompts:
            r = await completion(url, dict(prompt_token_ids=p, max_tokens=0,
                                           echo=True))
            lp = r["body"]["choices"][0]["logprobs"]["token_logprobs"]
            if r["status"] != 200 or lp[0] is not None or \
                    len(lp) != len(p) or not all(x <= 0 for x in lp[1:]):
                raise AssertionError(f"echo request failed: {r['body']}")
            echo.append(dict(logprobs=lp[1:],
                             ms=(r["t1"] - r["t0"]) * 1e3))
        res["echo"] = echo
        res["echo_ms"] = [e["ms"] for e in echo]
        res["echo_s"] = time.perf_counter() - t
        t = time.perf_counter()
        trace_dir = os.path.join(workdir, "trace")
        from arcticinference_tpu_torch.serving import http

        async with http.post(url + "/start_profile",
                             json={"trace_dir": trace_dir}) as r:
            if r.status != 200:
                raise AssertionError(f"/start_profile: {await r.read()}")
        await asyncio.gather(*[completion(url, dict(
            prompt_token_ids=p, max_tokens=8, ignore_eos=True))
            for p in prompts["profile"]])
        async with http.post(url + "/stop_profile") as r:
            if r.status != 200:
                raise AssertionError(f"/stop_profile: {await r.read()}")
        res["trace"] = trace_kernel_counts(trace_dir)
        res["profile_s"] = time.perf_counter() - t
        if not all(res["trace"][k] > 0 for k in SERVE_TRACE_KERNELS):
            raise AssertionError(f"trace misses kernels: {res['trace']}")
        res["disconnect_abort_s"] = await disconnect_after_first_chunk(url)
        t = time.perf_counter()
        rport = free_port()
        rurl = f"http://127.0.0.1:{rport}"
        router_log = os.path.join(workdir, "router.log")
        router = start_process(
            [sys.executable, "-m", "arcticinference_tpu_torch.serving.router",
             "--backends", f"{url},http://127.0.0.1:{dead}", "--port",
             str(rport), "--host", "127.0.0.1", "--health-interval", "1"],
            router_log)
        res["router_ready_s"] = await wait_healthy(rurl, router, router_log,
                                                   60)
        # Direct and routed bursts in turns (direct, router, router,
        # direct): the bursts' spread is the host clock's.
        res["router_burst"] = await burst(rurl, prompts["bursts"][2])
        res["router_burst_2"] = await burst(rurl, prompts["bursts"][3])
        res["burst_2"] = await burst(url, prompts["bursts"][4])
        res["router_http_ms"] = await http_overhead(rurl)
        _, reps = await get_json(rurl + "/replicas")
        res["replicas"] = reps["replicas"]
        health = {rep["url"]: rep["healthy"] for rep in reps["replicas"]}
        if health != {url: True, f"http://127.0.0.1:{dead}": False}:
            raise AssertionError(f"router replicas: {reps}")
        res["router_s"] = time.perf_counter() - t
        _, res["metrics"] = await get_json(url + "/metrics")

    try:
        asyncio.run(run())
        res["router_exit_s"] = stop_process(router, 10)
        res["server_exit_s"] = stop_process(server, 30)
        if res["server_exit_s"] > 30:
            raise AssertionError("the server did not exit within 30 s of "
                                 "SIGTERM")
    finally:
        for proc in (router, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def serve_part_b(cfg, seq_prompts, echo_prompts, served) -> dict:
    """Part (b): ``LLM.generate`` of each sequential prompt alone and
    ``LLM.score`` of each echo prompt, in this process, against the
    server's answers."""
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    t = time.perf_counter()
    with LLM(cfg) as llm:
        init_s = time.perf_counter() - t
        ids, gen_ms = [], []
        for p in seq_prompts:
            t0 = time.perf_counter()
            ids.append(llm.generate(prompt_token_ids=[p], sampling_params=
                                    SamplingParams(max_tokens=SERVE_NEW,
                                                   ignore_eos=True))[0]
                       .token_ids)
            gen_ms.append((time.perf_counter() - t0) * 1e3)
        scores = [[float(x) for x in llm.score([p])[0]]
                  for p in echo_prompts]
    del llm
    free_cuda_memory()
    res = dict(init_s=init_s, s=time.perf_counter() - t,
               generate_ms=gen_ms,
               server_minus_offline_ms=[
                   a - b for a, b in zip(served["sequential_e2e_ms"],
                                         gen_ms)],
               tokens_equal=[a == b for a, b in
                             zip(ids, served["sequential_ids"])],
               score_equal=[a == e["logprobs"] for a, e in
                            zip(scores, served["echo"])],
               score_max_abs_diff=[float(np.max(np.abs(
                   np.subtract(a, e["logprobs"]))))
                   for a, e in zip(scores, served["echo"])])
    if not (all(res["tokens_equal"]) and all(res["score_equal"])):
        raise AssertionError(f"offline engine differs from the server: "
                             f"{res}")
    return res


def serve_part_c(cfg) -> dict:
    """Part (c): an in-process ``OpenAIServer`` over the synthetic
    tokenizer: chat, guided choice / regex / JSON schema, ``n: 2``, echo,
    and a streamed chat through the Dynasor proxy.  The launch counts are
    set to 0 just before and read just after."""
    import re

    from arcticinference_tpu_torch.dynasor.proxy import DynasorProxy
    from arcticinference_tpu_torch.serving import http
    from arcticinference_tpu_torch.serving.openai_server import OpenAIServer

    t = time.perf_counter()
    srv = OpenAIServer(cfg)
    tok = SyntheticTokenizer(srv.engine.engine.arch.vocab_size)
    srv.tokenizer = srv.engine.engine.tokenizer = tok
    res = dict(init_s=time.perf_counter() - t)
    choices = GUIDED_SPECS[2][1]["choice"]
    date_re = GUIDED_SPECS[1][1]["regex"]
    schema = GUIDED_SPECS[0][1]["json"]

    async def post(url, path, body):
        async with http.post(url + path, json=body, timeout=600) as r:
            return r.status, await r.read()

    async def run():
        port = await srv.app.start("127.0.0.1", 0)
        url = f"http://127.0.0.1:{port}"
        proxy = DynasorProxy(url, probe_interval=32, certainty_window=2)
        purl = f"http://127.0.0.1:{await proxy.app.start('127.0.0.1', 0)}"
        out = {}
        try:
            status, raw = await post(url, "/v1/chat/completions", dict(
                messages=[{"role": "user",
                           "content": "Name three colours."}],
                max_tokens=16, ignore_eos=True))
            data = json.loads(raw)
            out["chat"] = dict(status=status,
                               usage=data.get("usage"),
                               finish=data["choices"][0]["finish_reason"])
            if status != 200 or data["usage"]["completion_tokens"] != 16:
                raise AssertionError(f"chat: {data}")
            guided = {}
            for name, body, check in (
                    ("choice", dict(guided_choice=choices),
                     lambda s: s in choices),
                    ("regex", dict(guided_regex=date_re),
                     lambda s: re.fullmatch(date_re, s) is not None),
                    ("json_schema", dict(response_format={
                        "type": "json_schema",
                        "json_schema": {"schema": schema}}),
                     lambda s: isinstance(json.loads(s), dict))):
                t0 = time.perf_counter()
                status, raw = await post(url, "/v1/completions", dict(
                    prompt_token_ids=list(range(300, 364)),
                    max_tokens=128, **body))
                ch = json.loads(raw)["choices"][0]
                ok = status == 200 and ch["finish_reason"] == "stop" \
                    and check(ch["text"])
                guided[name] = dict(ok=ok, text=ch["text"][:80],
                                    tokens=len(ch["token_ids"]),
                                    ms=(time.perf_counter() - t0) * 1e3)
            out["guided"] = guided
            if not all(g["ok"] for g in guided.values()):
                raise AssertionError(f"guided outputs: {guided}")
            status, raw = await post(url, "/v1/completions", dict(
                prompt_token_ids=list(range(500, 600)), max_tokens=16,
                ignore_eos=True, n=2, temperature=0.8, seed=7))
            data = json.loads(raw)
            out["n2"] = [len(c["token_ids"]) for c in data["choices"]]
            if status != 200 or out["n2"] != [16, 16] or \
                    data["usage"]["completion_tokens"] != 32:
                raise AssertionError(f"n=2: {data}")
            status, raw = await post(url, "/v1/completions", dict(
                prompt_token_ids=list(range(700, 900)), max_tokens=0,
                echo=True))
            lp = json.loads(raw)["choices"][0]["logprobs"]["token_logprobs"]
            if status != 200 or len(lp) != 200:
                raise AssertionError(f"echo: {raw[:300]}")
            _, m0 = await get_json(url + "/metrics")
            status, raw = await post(purl, "/v1/chat/completions", dict(
                messages=[{"role": "user", "content": "What is 6 x 7?"}],
                max_tokens=96, stream=True))
            events = [ln[6:] for ln in raw.decode().splitlines()
                      if ln.startswith("data: ")]
            _, m1 = await get_json(url + "/metrics")
            deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
            out["dynasor"] = dict(
                status=status, events=len(events),
                text_chars=sum(len(d["delta"]["content"]) for d in deltas),
                backend_finished=m1["num_finished"] - m0["num_finished"])
            if status != 200 or events[-1] != "[DONE]" or \
                    out["dynasor"]["backend_finished"] < 2:
                raise AssertionError(f"dynasor: {out['dynasor']}")
        finally:
            await proxy.app.stop()
            await srv.app.stop()
        return out

    reset_counts()
    res.update(asyncio.run(run()))
    res["launches"] = launch_counts()
    res["s"] = time.perf_counter() - t
    del srv
    free_cuda_memory()
    return res


def phase_serve(rng) -> dict:
    """Phase 8 (see the module docstring): parts (a), (b) and (c)."""
    from arcticinference_tpu_torch.benchmarks.serve_bench import build_config

    cfg = build_config("baseline", True)

    def tokens(lengths):
        return [[int(x) for x in rng.integers(0, 128000, int(k))]
                for k in lengths]

    burst_lengths = rng.integers(128, 1025, SERVE_BURST)
    prompts = dict(sequential=tokens(rng.integers(128, 1025,
                                                  SERVE_SEQUENTIAL)),
                   bursts=[tokens(burst_lengths) for _ in range(5)],
                   echo=tokens(rng.integers(128, 1025, 2)),
                   profile=tokens((128, 128)))
    with tempfile.TemporaryDirectory(prefix="serve_phase_") as workdir:
        cfg_path = os.path.join(workdir, "config.json")
        Path(cfg_path).write_text(json.dumps(cfg.to_dict()))
        t = time.perf_counter()
        a = serve_part_a(cfg_path, prompts, workdir)
        a["s"] = time.perf_counter() - t
    card = smi()
    bursts = ("warmup_burst", "burst", "router_burst", "router_burst_2",
              "burst_2")
    for name in bursts:
        log(f"  serve {name} " + json.dumps(dict(a[name], card=card)))
    log("  serve (a) " + json.dumps({k: v for k, v in a.items()
                                     if k not in ("sequential_ids", "echo",
                                                  *bursts)}))
    log(f"[serve] (a) {a['s']:.1f} s; burst TTFT p50 "
        f"{a['burst']['ttft_p50_ms']:.1f} ms, through the router "
        f"{a['router_burst']['ttft_p50_ms']:.1f} ms; {card}")
    t = time.perf_counter()
    b = serve_part_b(cfg, prompts["sequential"], prompts["echo"], a)
    log("  serve (b) " + json.dumps(dict(b, card=smi())))
    log(f"[serve] (b) {time.perf_counter() - t:.1f} s: tokens and scores "
        "equal the server's")
    c = serve_part_c(cfg)
    log("  serve (c) " + json.dumps(dict(c, card=smi())))
    log(f"[serve] (c) {c['s']:.1f} s")
    missing = [k for k in SERVE_TRACE_KERNELS if c["launches"][k] == 0]
    if missing:
        raise AssertionError(f"part (c) launched no {missing}")
    return dict(a=a, b=b, c=c, launches=c["launches"])


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

# --------------------------------------------------------------------- #
# Phase 10: the tiny trained checkpoint, the quality gate, the accuracy
# matrix and the drafter transfer
# --------------------------------------------------------------------- #

# The checkpoint's training steps: the JAX gate's 300 (its transfer script
# trains 500; held-out perplexity rises past ~300 on this small corpus).
QUALITY_TRAIN_STEPS = 300
# Its attention (benchmarks/tiny_markov.py): 2 q heads of 64 over 1 kv
# head, 2 layers.
TINY_HQ, TINY_HKV, TINY_D, TINY_LAYERS = 2, 1, 64, 2
# Its weights as the port fuses them (name, K, N, parts, float32 out).
TINY_MATMUL_SHAPES = (("wqkv", 128, 256, (128, 64, 64), False),
                      ("wo", 128, 128, None, False),
                      ("w_gateup", 128, 512, (256, 256), False),
                      ("w_down", 256, 128, None, False),
                      ("lm_head", 128, 256, None, True))
# Rows: a decode step of the 16-sequence batch, a 256-token score chunk.
TINY_MATMUL_ROWS = (16, 256)
# Each precision's perplexity through the kernels against the plain
# versions on the same engine (relative): the card read at most 3.8e-5,
# and the least effect of a quantization on it is fp8's 3.2e-4.
PLAIN_PPL_TOL = 2e-4
# The JAX slow test's transfer bars (tests/test_bench_smoke.py).
TRANSFER_ACCEPTANCE = 0.3
TRANSFER_TOKENS_PER_STEP = 1.5
# |HTTP echo logprob - local| (tests/benchmarks/test_accuracy.py).
ECHO_TOL = 5e-2


def phase_quality_kernels(rng, seed):
    """Kernels 1 and 2 at the checkpoint's attention (Hq=2, Hkv=1, D=64,
    a 2-layer cache, bf16 and fp8 pages) and kernels 5 and 6 at its
    weights (fp8, int8, int4; 16 and 256 rows) against their plain
    versions.  Kernel 1: the gate's score batch (2 x 256 tokens) and the
    transfer's prefill (16 x 64) at qb 32; kernel 2: the transfer's
    decode (B=16, qlen 1) and verify (qlen 4) steps at contexts 64-200,
    the matrix's one-sequence decode, and the qlen-4 rows bit for bit
    against qlen-1 launches.  Returns (ragged, grouped, invariance,
    fp8 and int8, int4) cases."""
    import torch

    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    dims = dict(hq=TINY_HQ, hkv=TINY_HKV, d=TINY_D, layers=TINY_LAYERS,
                layer=1)
    ragged, grouped, invariance = [], [], []
    for kv_dtype in (torch.bfloat16, torch.float8_e4m3fn):
        dt = "bf16" if kv_dtype == torch.bfloat16 else "fp8"
        for name, reqs, t_pad in (
                (f"tiny score 2x256 {dt} qb=32", [(0, 256)] * 2, 512),
                (f"tiny prefill 16x64 {dt} qb=32", [(0, 64)] * 16, 1024)):
            case = Case(name, reqs, kv_dtype, rng, t_pad=t_pad, **dims)
            sched = case.schedule(32)

            def kern(case=case, sched=sched):
                return ra.ragged_paged_attention_kernel(
                    case.q, case.kv, case.positions, case.req_idx,
                    case.block_tables, case.seq_lens, qb=32,
                    schedule=sched, kv_scale=case.kv_scale,
                    layer=case.layer)

            def plain(case=case):
                return ragged_paged_attention_reference(
                    case.q, case.kv[case.layer], case.positions,
                    case.req_idx, case.block_tables, case.seq_lens,
                    kv_scale=case.kv_scale[case.layer])

            ragged.append(run_case(case, kern, plain))
        for name, b, qlen in ((f"tiny decode B=16 qlen=1 {dt}", 16, 1),
                              (f"tiny decode B=16 qlen=4 {dt}", 16, 4),
                              (f"tiny decode B=1 qlen=1 {dt}", 1, 1)):
            ctx = rng.integers(64, 200, b) if b > 1 else [12]
            reqs = [(int(c), qlen) for c in ctx]
            case = Case(name, reqs, kv_dtype, rng, t_pad=b * qlen,
                        slot_rows=qlen, **dims)
            pos_base, kern, plain = decode_step(case, qlen)
            grouped.append(run_case(case, kern, plain))
            if qlen > 1:
                invariance.append(row_invariance(case, qlen, pos_base))
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fp8_cases, int4_cases = [], []
    for mode, kernel, plain, cases in (
            ("fp8", fm.fp8_matmul_kernel, fm.fp8_matmul_reference,
             fp8_cases),
            ("int8", fm.fp8_matmul_kernel, fm.fp8_matmul_reference,
             fp8_cases),
            ("int4", im.int4_matmul_kernel, im.int4_matmul_reference,
             int4_cases)):
        for name, k, n, parts, f32 in TINY_MATMUL_SHAPES:
            q = quantized_weight(mode, k, n, parts, gen)
            for m in TINY_MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                cases.append(run_matmul_case(
                    f"{mode} tiny {name} [{k},{n}] M={m}", q, x,
                    torch.float32 if f32 else torch.bfloat16, kernel,
                    plain))
    failed = [c["case"] for c in ragged + grouped + invariance + fp8_cases
              + int4_cases if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version at the "
                             f"tiny checkpoint's shapes: {failed}")
    return ragged, grouped, invariance, fp8_cases, int4_cases


def quality_gate(ckpt, heldout) -> dict:
    """Phase 10 (b): held-out perplexity of each precision through
    ``LLM.score`` (the launch counts set to 0 just before it and read
    just after), then through the plain versions on the same engine, and
    the KL of each quantized precision's prefill logits against bf16."""
    import torch

    from arcticinference_tpu_torch.benchmarks import quality_gate as qg
    from arcticinference_tpu_torch.benchmarks.distill_drafter import (
        free_llm)
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.models import llama

    seqs = qg.heldout_sequences(heldout)
    kl_ids = heldout[:qg.KL_TOKENS]
    ppls, plain, launches, logits, kv_dtypes = {}, {}, {}, {}, {}
    for name, quant, kv in qg.PRECISIONS:
        llm = LLM(qg.engine_config(str(ckpt), quant, kv), device="cuda")
        reset_counts()
        ppls[name] = qg.perplexity(llm, seqs)
        if kv == "auto":
            logits[name] = llm.engine.prompt_logits(kl_ids)
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        kv_dtypes[name] = str(llm.engine.runner.kv.dtype)
        with plain_route(llama):
            plain[name] = qg.perplexity(llm, seqs)
        free_llm(llm)
        log(f"  gate {name}: perplexity {ppls[name]:.6f} (plain versions "
            f"{plain[name]:.6f}), kv {kv_dtypes[name]}, launches "
            f"{json.dumps(launches[name])}")
    kls = {name: qg.kl(logits["bf16"], logits[name])
           for name in qg.KL_BOUNDS}
    res = dict(ppl=ppls, ppl_plain=plain,
               ratio={n: ppls[n] / ppls["bf16"] for n in ppls},
               kl=kls, kv_dtype=kv_dtypes, launches=launches)
    problems = qg.failures(ppls, kls)
    for name in ppls:
        if not abs(ppls[name] / plain[name] - 1) < PLAIN_PPL_TOL:
            problems.append(f"{name} perplexity {ppls[name]} against "
                            f"{plain[name]} through the plain versions")
    for name, quant, kv in qg.PRECISIONS:
        n = launches[name]
        if n["ragged_paged_attention_kernel"] == 0:
            problems.append(f"{name}: kernel 1 never launched")
        want = {None: None, "fp8": "fp8_matmul_kernel",
                "int8": "fp8_matmul_kernel",
                "int4": "int4_matmul_kernel"}[quant]
        if want and n[want] == 0:
            problems.append(f"{name}: {want} never launched")
        if quant is None and (n["fp8_matmul_kernel"]
                              or n["int4_matmul_kernel"]):
            problems.append(f"{name}: a quantized matmul launched")
        if (kv == "fp8") != (kv_dtypes[name] == str(torch.float8_e4m3fn)):
            problems.append(f"{name}: kv cache in {kv_dtypes[name]}")
    log("  gate " + json.dumps(dict(res, card=smi())))
    if problems:
        raise AssertionError(f"quality gate failed: {problems}")
    return res


def accuracy_matrix(ckpt, heldout, workdir) -> dict:
    """Phase 10 (c): the JAX accuracy test's tasks (rng 5) over bf16, fp8
    and int8 ``LocalClient``s, each client's launches counted around its
    suite; then ``HTTPClient`` against the port's server (a subprocess on
    the bf16 config): echo scoring against the local client's, and a
    4-token generation."""
    import urllib.request

    from arcticinference_tpu_torch.benchmarks import accuracy_harness as ah
    from arcticinference_tpu_torch.benchmarks import quality_gate as qg
    from arcticinference_tpu_torch.benchmarks.distill_drafter import (
        free_llm)
    from arcticinference_tpu_torch.engine.llm import LLM

    tasks = ah.markov_tasks(heldout, np.random.default_rng(5))
    rows, launches, seconds = [], {}, {}
    for name, quant in (("bf16", None), ("fp8", "fp8"), ("int8", "int8")):
        llm = LLM(qg.engine_config(str(ckpt), quant), device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        rows += ah.run_suite({name: ah.LocalClient(llm)}, tasks)
        seconds[name] = time.perf_counter() - t0
        launches[name] = launch_counts()
        if name == "bf16":
            local = ah.LocalClient(llm)
            prompt = [int(t) for t in heldout[:12]]
            cont = [int(t) for t in heldout[12:16]]
            local_lp = local.continuation_logprob(prompt, cont)
            local_toks, _ = local.generate(prompt, 4)
        free_llm(llm)
    rows.sort(key=lambda r: (r["config"], r["task"]))
    problems = ah.matrix_failures(rows)
    for name, n in launches.items():
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel") + (
                        ("fp8_matmul_kernel",) if name != "bf16" else ()):
            if n[key] == 0:
                problems.append(f"matrix {name}: {key} never launched")

    cfg_path = Path(workdir) / "bf16.json"
    cfg = qg.engine_config(str(ckpt))
    cfg_path.write_text(json.dumps(dict(
        model=dict(model=cfg.model.model, max_model_len=2048),
        cache=dict(block_size=cfg.cache.block_size, num_blocks=256),
        scheduler=dict(max_num_seqs=8, max_num_batched_tokens=512))))
    port = free_port()
    log_path = Path(workdir) / "server.log"
    proc = start_process([sys.executable, "-m", "arcticinference_tpu_torch",
                          "serve", "--config", str(cfg_path), "--port",
                          str(port), "--host", "127.0.0.1"], log_path)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server exited: "
                                     f"{log_path.read_text()[-3000:]}")
            try:
                with urllib.request.urlopen(url + "/health", timeout=2):
                    break
            except OSError:
                if time.perf_counter() - t0 > 120:
                    raise
                time.sleep(0.5)
        http = ah.HTTPClient(url)
        http_lp = http.continuation_logprob(prompt, cont)
        http_toks, http_text = http.generate(prompt, 4)
    finally:
        stop_process(proc, 30)
    echo = dict(http=http_lp, local=local_lp, diff=abs(http_lp - local_lp),
                http_tokens=http_toks, local_tokens=local_toks,
                http_text=http_text)
    if not echo["diff"] < ECHO_TOL:
        problems.append(f"HTTP echo logprob {http_lp} against local "
                        f"{local_lp}")
    if len(http_toks) != 4:
        problems.append(f"HTTP generated {len(http_toks)} tokens, not 4")
    res = dict(rows=rows, launches=launches, seconds=seconds, http=echo)
    log("  matrix " + json.dumps(dict(res, card=smi())))
    if problems:
        raise AssertionError(f"accuracy matrix failed: {problems}")
    return res


def transfer(ckpt, workdir) -> dict:
    """Phase 10 (d): the bench's ``spec_transfer`` block
    (``bench.spec_transfer``: ``benchmarks/transfer_drafter.py`` at the
    JAX script's defaults) on the phase's checkpoint, the launch counts
    set to 0 just before it and read just after, gated on the JAX slow
    test's bars and on the held-out tokens equalling greedy."""
    from arcticinference_tpu_torch import bench

    reset_counts()
    t0 = time.perf_counter()
    out = bench.spec_transfer("cuda", ckpt=ckpt,
                              drafter_out=Path(workdir) / "drafter")
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log("  spec_transfer " + json.dumps(dict(out, seconds=seconds,
                                             card=smi())))
    problems = []
    for kind, block in (("mlp", out), ("lstm", out["lstm"])):
        if block["drafter_kind"] != kind:
            problems.append(f"{kind}: drafter kind {block['drafter_kind']}")
        if not block["transfer_acceptance"] > TRANSFER_ACCEPTANCE:
            problems.append(f"{kind} held-out acceptance "
                            f"{block['transfer_acceptance']}")
        if block["tokens_match_greedy"] is not True:
            problems.append(f"{kind}: held-out tokens differ from greedy")
    if not out["transfer_tokens_per_step"] > TRANSFER_TOKENS_PER_STEP:
        problems.append(f"mlp tokens per step "
                        f"{out['transfer_tokens_per_step']}")
    for key in ("ragged_paged_attention_kernel",
                "grouped_decode_attention_kernel"):
        if launches[key] == 0:
            problems.append(f"the transfer never launched {key}")
    if problems:
        raise AssertionError(f"drafter transfer failed: {problems}")
    return dict(out, seconds=seconds, launches=launches)


def phase_quality(rng, seed) -> dict:
    """Phase 10: train the tiny checkpoint on the card, then the gate,
    the matrix and the transfer on it (each run's launches counted), then
    kernels 1, 2, 5 and 6 at its shapes against their plain versions."""
    import torch

    from arcticinference_tpu_torch.benchmarks import tiny_markov as tm

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="quality_phase_") as workdir:
        ckpt = Path(workdir) / "tiny-markov"
        t0 = time.perf_counter()
        _, heldout = tm.train_tiny_checkpoint(
            ckpt, steps=QUALITY_TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train = dict(tm.read_train_metrics(ckpt),
                     wall_s=time.perf_counter() - t0)
        log(f"[quality] (a) trained the tiny checkpoint: "
            f"{json.dumps(train)}")
        log("[quality] (b) the perplexity gate and logit KL")
        gate = quality_gate(ckpt, heldout)
        log("[quality] (c) the accuracy matrix (bf16, fp8, int8) and the "
            "server's echo")
        matrix = accuracy_matrix(ckpt, heldout, workdir)
        log("[quality] (d) the drafter transfer (spec_transfer)")
        xfer = transfer(ckpt, workdir)
        free_cuda_memory()
    log("[quality] (f) kernels 1, 2, 5 and 6 at the checkpoint's shapes")
    cases = phase_quality_kernels(rng, seed)
    seconds = time.perf_counter() - t_phase
    log(f"[quality] phase took {seconds:.1f} s")
    return dict(train=train, gate=gate, matrix=matrix, transfer=xfer,
                cases=cases, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 11: Mixtral (sparse MoE) and the grouped matmul
# ---------------------------------------------------------------------------

# Mixtral-8x7B's expert weights (mistralai/Mixtral-8x7B-v0.1 config.json):
# w_gate / w_up [8, 4096, 14336], w_down [8, 14336, 4096].
MOE_SHAPES = (("w_gate", 4096, 14336), ("w_down", 14336, 4096))
# Rows: a batch-64 decode step (64 x top-2), 512, a 2048-token chunk x 2.
MOE_ROWS = (128, 512, 4096)
MOE_ROUTINGS = ("uniform", "skewed", "one empty", "one expert")
MOE_FORMATS = ("bf16", "fp8", "int8", "int4")
# Phase 11's generate traffic: 16 prompts of 128-1024 tokens x 32 tokens.
MOE_PROMPTS, MOE_NEW = 16, 32
# Layers of the bf16 Mixtral run (its 32 layers of bf16 experts take ~93
# GB, more than the card's 80).
MOE_BF16_LAYERS = 8


def moe_counts(rng, routing, r, e=8) -> np.ndarray:
    """Rows per expert of a routing: uniform, skewed (~70% of the rows on
    one expert), one expert empty, every row on one expert."""
    if routing == "one expert":
        c = np.zeros(e, np.int64)
        c[0] = r
        return c
    p = np.ones(e) / e
    if routing == "skewed":
        p = np.full(e, 0.3 / (e - 1))
        p[3] = 0.7
    elif routing == "one empty":
        p[5] = 0
        p /= p.sum()
    return rng.multinomial(r, p)


def moe_weight(fmt, k, n, gen):
    """An [8, k, n] expert stack drawn from N(0, 1) in bf16 on the card,
    quantized as the Mixtral module quantizes one layer."""
    import torch

    from arcticinference_tpu_torch.models.mixtral import quantize_experts

    w = torch.randn((8, k, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    return w if fmt == "bf16" else quantize_experts(w, fmt)


def grouped_call(fn, xs, q, offsets):
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    if isinstance(q, QuantizedLinear):
        return fn(xs, q.weight, q.scale, offsets)
    return fn(xs, q, None, offsets)


def grouped_library_ms(xs, q, offsets, counts) -> tuple:
    """The yardstick: one ``torch._grouped_mm`` over the bf16 stack (the
    quantized one dequantized ahead of time; bf16 out), or, where this
    torch lacks it, a per-expert ``torch.mm`` loop over the counts read on
    the host beforehand.  Returns (ms, what was timed)."""
    import torch

    from arcticinference_tpu_torch.ops.cuda.grouped_matmul import dequantized
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    wd = (dequantized(q.weight, q.scale) if isinstance(q, QuantizedLinear)
          else q)
    dense = rotating(wd, wd.nbytes)
    ends = offsets[1:].contiguous()
    try:
        torch._grouped_mm(xs, wd, offs=ends)
        torch.cuda.synchronize()

        def lib():
            torch._grouped_mm(xs, next(dense), offs=ends)
        what = "torch._grouped_mm (bf16 out)"
    except (AttributeError, RuntimeError) as err:
        bounds = np.concatenate([[0], np.cumsum(counts)])

        def lib():
            w = next(dense)
            for e in range(len(counts)):
                a, b = int(bounds[e]), int(bounds[e + 1])
                if b > a:
                    torch.mm(xs[a:b], w[e], out_dtype=torch.float32)
        what = f"torch.mm per expert ({type(err).__name__}: {err})"[:200]
    ms = cuda_time_ms(lib, iters=10)
    del dense, wd
    return ms, what


def moe_kernel_case(name, xs, q, offsets, counts, timed) -> dict:
    """The grouped kernel against its plain version on one case; with
    ``timed`` its time, the plain version's, the bound and the library
    yardstick too."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    out = grouped_call(gm.grouped_matmul_kernel, xs, q, offsets)
    ref = grouped_call(gm.grouped_matmul_reference, xs, q, offsets)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    bad = int((diff > ATOL + RTOL * ref.abs()).sum())
    rel = float((out - ref).norm() / ref.norm())
    res = dict(case=name, rows=int(xs.shape[0]), counts=[int(c) for c in
                                                          counts],
               max_abs_err=float(diff.max()), n_out_of_tol=bad, rel_err=rel,
               ref_max_abs=float(ref.abs().max()),
               finite=bool(torch.isfinite(out).all()))
    res["ok"] = bad == 0 and rel <= REL_TOL and res["finite"]
    if timed:
        w = q.weight if isinstance(q, QuantizedLinear) else q
        e, k, n = w.shape[0], xs.shape[1], w.shape[2]
        per_expert = w.nbytes // e + (
            q.scale.nbytes // e if isinstance(q, QuantizedLinear)
            and q.scale.numel() > 1 else 0)
        live = int((np.asarray(counts) > 0).sum())
        nbytes = xs.nbytes + live * per_expert + out.nbytes
        flops = 2.0 * int(np.sum(counts)) * k * n
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        nb = w.nbytes + (q.scale.nbytes if isinstance(q, QuantizedLinear)
                         else 0)
        copies = rotating(q, nb)
        res["ms"] = cuda_time_ms(lambda: grouped_call(
            gm.grouped_matmul_kernel, xs, next(copies), offsets), iters=10)
        del copies
        res["plain_ms"] = cuda_time_ms(lambda: grouped_call(
            gm.grouped_matmul_reference, xs, q, offsets), iters=1, warmup=1)
        res["library_ms"], res["library"] = grouped_library_ms(
            xs, q, offsets, counts)
        res.update(bound_ms=max(t_bytes, t_flops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_flops else "operations",
                   bytes=nbytes, flops=flops,
                   plan=list(gm.launch_plan(xs.shape[0], e, n)))
    log("  moe case " + json.dumps(res))
    return res


def moe_replay(fmt, wname, k, n, r, gen, rng) -> dict:
    """The grouped kernel bit for bit: rows moved within their expert's
    group to other indices, beside fresh rows, give the same bits; two
    launches alike; a CUDA graph of one launch replayed twice alike the
    eager launch; the rows past ``offsets[E]`` (a routing 7 rows short)
    exactly 0; rows one-hot at column k give the dequantized weight row
    ``float(bf16(W[e][k] * scale))`` exactly (a kernel that scaled the
    float32 sums instead would miss it by each weight's bf16 rounding)."""
    import torch

    from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    q = moe_weight(fmt, k, n, gen)
    counts = moe_counts(rng, "skewed", r - 7)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device="cuda")
    bounds = offsets.tolist()

    def launch(x):
        return grouped_call(gm.grouped_matmul_kernel, x, q, offsets)

    xs = torch.randn((r, k), generator=gen, device="cuda").to(torch.bfloat16)
    xs2 = torch.randn((r, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    moves = {}
    for e in range(8):
        a, b = bounds[e], bounds[e + 1]
        for j in range(a, b, max(1, (b - a) // 4)):
            moves[j] = a + (j - a + (b - a) // 2 + 1) % (b - a)
    for j, j2 in moves.items():
        xs2[j2] = xs[j]
    out, out2, again = launch(xs), launch(xs2), launch(xs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(xs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(xs)
    replays = []
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(captured, out)))
    cols = torch.randint(0, k, (r,), generator=gen, device="cuda")
    hot = torch.zeros((r, k), dtype=torch.bfloat16, device="cuda")
    hot[torch.arange(r, device="cuda"), cols] = 1
    expert = torch.repeat_interleave(
        torch.arange(8, device="cuda"), offsets.diff().long())
    wd = (gm.dequantized(q.weight, q.scale) if isinstance(q, QuantizedLinear)
          else q)
    one_hot = launch(hot)
    want = wd[expert, cols[:expert.numel()]].float()
    res = dict(case=f"{fmt} {wname} [8,{k},{n}] R={r}",
               plan=list(gm.launch_plan(r, 8, n)), rows_moved=len(moves),
               rows_not_bitwise_equal=sum(not torch.equal(out2[j2], out[j])
                                          for j, j2 in moves.items()),
               launches_equal=bool(torch.equal(again, out)),
               graph_replays_equal=replays,
               tail_rows_zero=bool((out[bounds[-1]:] == 0).all()),
               one_hot_rows_not_exact=int(
                   (one_hot[:expert.numel()] != want).any(1).sum()))
    res["ok"] = (res["rows_not_bitwise_equal"] == 0 and res["launches_equal"]
                 and all(replays) and res["tail_rows_zero"]
                 and res["one_hot_rows_not_exact"] == 0)
    log("  moe replay " + json.dumps(res))
    del graph, q, wd
    return res


def phase_moe_kernels(seed) -> tuple:
    """The grouped kernel against its plain version at Mixtral-8x7B's
    expert shapes: every weight format x rows x routing (timed at the
    uniform routing, and fp8's skewed 128 and 4096 rows, where one
    expert's rows take several row tiles that each read its weight),
    then :func:`moe_replay`; returns (cases, replays)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    cases, replays = [], []
    for fmt in MOE_FORMATS:
        for wname, k, n in MOE_SHAPES:
            q = moe_weight(fmt, k, n, gen)
            for r in MOE_ROWS:
                xs = torch.randn((r, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                for routing in MOE_ROUTINGS:
                    counts = moe_counts(rng, routing, r)
                    offsets = torch.tensor(
                        np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device="cuda")
                    timed = routing == "uniform" or (
                        fmt == "fp8" and routing == "skewed"
                        and r in (128, 4096))
                    cases.append(moe_kernel_case(
                        f"{fmt} {wname} [8,{k},{n}] R={r} {routing}", xs, q,
                        offsets, counts, timed=timed))
            del q
            free_cuda_memory()
    for fmt in MOE_FORMATS:
        replays.append(moe_replay(fmt, "w_gate", 4096, 14336, 128, gen, rng))
    replays.append(moe_replay("fp8", "w_down", 14336, 4096, 4096, gen, rng))
    bad = [c["case"] for c in cases + replays if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped kernel vs plain failed: {bad}")
    return cases, replays


def moe_engine_config(quantization, layers=None, spec=None):
    """Mixtral-8x7B at full width (``layers``: cut depth), 2048 cache
    blocks (8 GiB of KV), prefix caching off; the pipelined step on
    unless ``spec`` is set."""
    import dataclasses

    from arcticinference_tpu_torch.config import EngineConfig, ModelConfig

    cfg = engine_config(quantization, spec, model="mixtral-8x7b")
    dims = dict(MIXTRAL_8X7B)
    if layers:
        dims["num_hidden_layers"] = layers
    return EngineConfig(
        model=dataclasses.replace(cfg.model, hf_overrides=dims),
        cache=dataclasses.replace(cfg.cache, enable_prefix_caching=False),
        scheduler=dataclasses.replace(cfg.scheduler,
                                      async_scheduling=spec is None),
        speculative=cfg.speculative)


@contextlib.contextmanager
def recorded_routing(forced=None, sp_rank=0, save=None):
    """Record every MoE layer's chosen experts (``moe.route``'s top-k).
    With ``forced`` (a list of each layer's top-k from another run, or
    the directory :func:`save_routes` wrote them into) each layer takes
    those experts instead, their gate weights a softmax over this run's
    logits at them, and the record is this run's own top-k.  A forced
    top-k of more rows than the call routes is a whole step's, of which
    a rank of the SP program routes its ``sp_rank``-th chunk.  ``save``:
    a directory the record is written into at the end."""
    import torch

    from arcticinference_tpu_torch.ops import moe

    if isinstance(forced, Path):
        forced = [torch.from_numpy(np.load(forced / f"route_{i}.npy"))
                  for i in range(len(list(forced.glob("route_*.npy"))))]
    orig = moe.route
    calls = []

    def route(x, w_router, k):
        gate, top_i = orig(x, w_router, k)
        calls.append(top_i)
        if forced is None:
            return gate, top_i
        top_i = forced[len(calls) - 1].to(x.device)
        if top_i.shape[0] != x.shape[0]:
            c = x.shape[0]
            top_i = top_i[sp_rank * c:(sp_rank + 1) * c]
        logits = torch.matmul(x.float(), w_router.float())
        return torch.softmax(logits.gather(1, top_i), dim=-1), top_i

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = orig
    if save is not None:
        save_routes(calls, save)


def save_routes(calls, path: Path) -> None:
    """:func:`recorded_routing`'s record as ``route_<call>.npy`` files."""
    path.mkdir(exist_ok=True)
    for i, top_i in enumerate(calls):
        np.save(path / f"route_{i}.npy", top_i.cpu().numpy())


def moe_forward_pair(runner, si, inputs, num_layers) -> dict:
    """The first ``num_layers`` layers of the runner's Mixtral on one
    prefill step through ``forward`` with the kernels and through the
    plain route (on caches of their own), the plain run taking the kernel
    run's experts layer by layer; returns both runs' logits, launches and
    own expert choices."""
    import dataclasses

    import torch

    module, arch = runner.module, runner.arch
    arch = dataclasses.replace(arch, num_layers=num_layers)
    params = dict(runner.params, layers={
        k: v[:num_layers] for k, v in runner.params["layers"].items()})
    inputs = dict(inputs, kv_scale=runner.kv_scale[:num_layers])
    n_rows = sum(si.sample_row_count)
    blocks = max(int(inputs["block_tables"].max()) + 1, 2)
    out = {}
    with torch.inference_mode():
        for name in ("kernel", "plain"):
            kv = torch.zeros((num_layers, blocks)
                             + tuple(runner.kv.shape[2:]),
                             dtype=runner.kv.dtype, device=runner.kv.device)
            reset_counts()
            forced = out["kernel"]["routes"] if name == "plain" else None
            with (contextlib.nullcontext() if name == "kernel"
                  else plain_route(module)), \
                    recorded_routing(forced) as calls:
                attn = module.make_attn_impl(si.attn_qb)
                _, h = module.forward(params, arch, kv, dict(inputs),
                                      attn_impl=attn)
                rows = h[inputs["logits_indices"].long()[:n_rows]]
                logits = module.compute_logits(params, rows)
            torch.cuda.synchronize()
            out[name] = dict(logits=logits, launches=launch_counts(),
                             routes=calls)
            del kv
    return out


def moe_forward_check(llm, rng) -> dict:
    """One prefill step (prompts of 200, 500, 1000 and 300 tokens) of the
    engine's model with the kernels and through the plain route, at 2
    layers and at the model's depth (:func:`moe_forward_pair`).  A router
    near-tie turns a one-ulp difference into another expert, and on
    random weights such tokens spread through the later layers'
    attention (PERF.md, PR 17), so the plain run takes the kernel run's
    experts; the tokens whose own choice differs are counted per layer.
    At 2 layers the logits are held as phase 4 holds them (max |diff| <=
    5% of the largest logit, argmax equal or a near tie); at full depth,
    where one-ulp flips compound over the layers, as phase 9 holds a
    full-depth model's outputs (cosine >= CAUSAL_COS per row) with the
    argmax equal or a near tie."""
    import torch

    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.scheduler import Scheduler

    runner = llm.engine.runner
    arch, cfg = runner.arch, llm.engine.config
    sched = Scheduler(cfg.scheduler, cfg.cache, 80)
    for i, n in enumerate((200, 500, 1000, 300)):
        sched.add_request(Request(
            f"m{i}", [int(x) for x in rng.integers(0, arch.vocab_size, n)],
            SamplingParams(max_tokens=4)))
    si = runner.prepare_inputs(sched.schedule())
    inputs = runner.upload(si.arrays)
    live = si.total_tokens
    res = dict(step="prefill", tokens=live, ok=True)
    for depth in sorted({min(2, arch.num_layers), arch.num_layers}):
        pair = moe_forward_pair(runner, si, inputs, depth)
        a, b = pair["kernel"]["logits"], pair["plain"]["logits"]
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        agree = a.argmax(-1) == b.argmax(-1)
        top2 = b.topk(2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
        cos = torch.nn.functional.cosine_similarity(a.float(), b.float(),
                                                    dim=-1)
        own = [int((x[:live].sort(-1).values != y[:live].sort(-1).values)
                   .any(-1).sum())
               for x, y in zip(pair["kernel"]["routes"],
                               pair["plain"]["routes"])]
        kl, pl = pair["kernel"]["launches"], pair["plain"]["launches"]
        r = dict(layers=depth, rows=a.shape[0], max_abs_diff=diff,
                 max_abs_logit=scale, min_cosine=float(cos.min()),
                 argmax_agree=float(agree.float().mean()),
                 near_tie_rows=int(near_tie.sum()),
                 finite=bool(torch.isfinite(a).all()),
                 plain_own_choice_differs_per_layer=own,
                 kernel_launches={k: v for k, v in kl.items() if v},
                 plain_launches=sum(pl.values()))
        close = (diff <= 0.05 * scale if depth == 2
                 else float(cos.min()) >= CAUSAL_COS)
        r["ok"] = (r["finite"] and close and bool((agree | near_tie).all())
                   and not any(pl.values())
                   and kl["grouped_matmul_kernel"] == 3 * depth
                   and kl["ragged_paged_attention_kernel"] == depth)
        res[f"{depth} layers"] = r
        res["ok"] = res["ok"] and r["ok"]
    return res


def moe_device_step(llm, batch=64, ctx=512, replays=5) -> dict:
    """The decode step at (``batch``, ``ctx``) as a CUDA graph
    (``bench.measure_device_step``) against its byte bound: every weight
    but the embedding (at batch 64, 128 assignments leave an expert
    without rows with probability ~8 x (7/8)^128 < 1e-6) and the KV;
    then, after the timing, the same graph's device time by kernel under
    ``torch.profiler`` (an empty trace reads "not measured")."""
    from arcticinference_tpu_torch import bench

    step = bench.measure_device_step(llm, batch, ctx, iters=10)
    nbytes = bench.step_bytes(llm, batch, ctx)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    events, busy_ms = graph_profile(llm, batch, ctx, replays)

    def ms(*names):
        return sum(e.self_device_time_total for e in events
                   if any(n in e.key for n in names)) / 1e3 / replays
    profiled = dict(
        busy_ms=busy_ms, grouped_matmul_ms=ms("grouped_matmul_kernel"),
        fp8_matmul_ms=ms("qmm::"), attention_ms=ms("grouped_decode_kernel"),
        top=[dict(kernel=e.key[:90], ms_per_step=e.self_device_time_total
                  / 1e3 / replays, calls_per_step=e.count / replays)
             for e in events[:10]]) if busy_ms else "not measured"
    return dict(batch=batch, ctx=ctx, device_ms=step["device_ms"],
                dispatch_ms=step["dispatch_ms"], bytes=nbytes,
                bound_ms=bound, bound_share=bound / step["device_ms"],
                profile=profiled)


def moe_generate(quantization, prompts, layers=None) -> dict:
    """``LLM.generate`` of Mixtral at full width: the pipelined step, then
    the synchronous one on the same engine (every pipelined decode
    dispatch under the sync check), the launches per dispatch, the
    prefill logits against the plain route and, at full depth, the
    decode step's device time against its bound."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    name = f"mixtral {quantization or 'bf16'}" + (
        f" {layers} layers" if layers else "")
    free_cuda_memory()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    llm = LLM(moe_engine_config(quantization, layers))       # cuda:0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    arch = llm.engine.arch
    greedy = SamplingParams(max_tokens=MOE_NEW)
    pipe, outs_p, rec_p = pipeline_run(llm, prompts, greedy, True)
    sync, outs_s, rec_s = pipeline_run(llm, prompts, greedy, False)
    div = divergence(outs_p, outs_s, rec_p, rec_s)
    check = moe_forward_check(llm, np.random.default_rng(12))
    res = dict(model=name, layers=arch.num_layers,
               experts=arch.num_experts, top_k=arch.num_experts_per_tok,
               init_s=init_s, init_peak_mem_gib=init_peak,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               pipelined=pipe, sync=sync, agreement=div, forward=check,
               card=smi())
    per_dispatch = {}
    ok = check["ok"]
    for run in (pipe, sync):
        lc, d = run["launches"], run["dispatches"]
        per_dispatch["pipelined" if run["pipelined"] else "sync"] = {
            k: lc[k] / d for k in ("ragged_paged_attention_kernel",
                                   "grouped_decode_attention_kernel",
                                   "fp8_matmul_kernel",
                                   "grouped_matmul_kernel")}
        ok = ok and run["tokens"] == MOE_PROMPTS * MOE_NEW
        ok = ok and lc["grouped_matmul_kernel"] == 3 * arch.num_layers * d
        ok = ok and lc["ragged_paged_attention_kernel"] > 0 \
            and lc["grouped_decode_attention_kernel"] > 0
        # q, k, v and o unfused (no fuse_params, as in JAX) and the head.
        ok = ok and lc["fp8_matmul_kernel"] == (
            (4 * arch.num_layers + 1) * d if quantization == "fp8" else 0)
    res["launches_per_dispatch"] = per_dispatch
    # The router's float32 product is cuBLAS's, whose algorithm follows
    # the shape: a divergence is allowed only where some step up to it
    # ran at another shape in the two runs.
    ok = ok and all(f["shape_differs"] for f in div["divergences"])
    if not layers:
        res["device_step"] = moe_device_step(llm)
    log(f"  moe generate " + json.dumps(res))
    if not ok:
        raise AssertionError(f"Mixtral generate check failed: {res}")
    llm.close()
    del llm
    free_cuda_memory()
    return dict(res, outputs=[o.token_ids for o in outs_p])


def moe_fused_run(prompts, reference) -> dict:
    """Mixtral-8x7B fp8 with suffix speculation on the fused decode loop,
    the suffix cache seeded from ``reference`` (the pipelined run's
    tokens): every fused dispatch under the sync check, drafts verified,
    the grouped kernel launched."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams

    llm = LLM(moe_engine_config("fp8", spec="suffix fused"))
    eng = llm.engine
    seed_suffix_cache(eng._suffix_cache, prompts, reference,
                      eng.arch.vocab_size)
    reset_counts()
    t0 = time.perf_counter()
    with sync_checked_fused_dispatch() as checked:
        outs = llm.generate(prompt_token_ids=prompts,
                            sampling_params=SamplingParams(
                                max_tokens=MOE_NEW))
    torch.cuda.synchronize()
    st, ws = eng.spec_stats, eng.width_stats
    res = dict(model="mixtral fp8", spec="suffix fused",
               wall_s=time.perf_counter() - t0,
               tokens=sum(len(o.token_ids) for o in outs),
               fused_steps=eng.step_times.summary().get("fused", {}).get(
                   "count", 0),
               width_stats=ws, sync_checked_dispatches=checked["dispatches"],
               drafts=st.num_drafts, accepted_tokens=st.num_accepted_tokens,
               agreement_with_pipelined=token_agreement(outs, reference),
               launches=launch_counts(), card=smi())
    log("  moe fused " + json.dumps(res))
    ok = (res["tokens"] == MOE_PROMPTS * MOE_NEW and res["fused_steps"] > 0
          and res["drafts"] > 0
          and checked["dispatches"] == sum(
              v for k, v in ws.items() if k != "entries")
          and res["launches"]["grouped_matmul_kernel"] > 0)
    if not ok:
        raise AssertionError(f"Mixtral fused-loop check failed: {res}")
    llm.close()
    del llm, eng
    free_cuda_memory()
    return res


def phase_moe(rng, seed) -> dict:
    """Phase 11: the grouped kernel at Mixtral-8x7B's expert shapes, then
    ``LLM.generate`` on Mixtral-8x7B in fp8 at full depth (pipelined,
    synchronous, the fused suffix loop under the sync check) and in bf16
    at :data:`MOE_BF16_LAYERS` layers."""
    t_phase = time.perf_counter()
    log("[moe] (a) the grouped kernel vs plain, Mixtral-8x7B's experts")
    cases, replays = phase_moe_kernels(seed)
    prompts = [[int(x) for x in rng.integers(0, MIXTRAL_8X7B["vocab_size"],
                                             int(n))]
               for n in rng.integers(128, 1025, MOE_PROMPTS)]
    log("[moe] (b) Mixtral-8x7B fp8, 32 layers: LLM.generate pipelined and "
        "synchronous, prefill logits vs the plain route, decode device "
        "step; then the fused suffix loop")
    fp8 = moe_generate("fp8", prompts)
    fused = moe_fused_run(prompts, fp8.pop("outputs"))
    log(f"[moe] (c) Mixtral-8x7B bf16, {MOE_BF16_LAYERS} layers")
    bf16 = moe_generate(None, prompts, layers=MOE_BF16_LAYERS)
    bf16.pop("outputs")
    seconds = time.perf_counter() - t_phase
    log(f"[moe] phase took {seconds:.1f} s")
    return dict(cases=cases, replays=replays, fp8=fp8, fused=fused,
                bf16=bf16, seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 12: tensor, Ulysses sequence and shift parallelism on one card
# ---------------------------------------------------------------------------

# The worlds of phase 12: ranks share cuda:0 over gloo (collectives staged
# through host memory; NCCL refuses two ranks on one device).  The shift
# threshold sends the prefill steps (>= 128 tokens) to the Ulysses
# program and the decode steps (8 tokens) to the shift program.
PARALLEL_WORLDS = (
    ("tp2", dict(tensor_parallel_size=2)),
    ("sp2 x tp2 shift", dict(tensor_parallel_size=2,
                             ulysses_sequence_parallel_size=2,
                             enable_shift_parallel=True,
                             shift_parallel_threshold=64)),
    ("dp2 x tp2", dict(data_parallel_size=2, tensor_parallel_size=2)),
    ("pp2 x sp2 shift", dict(pipeline_parallel_size=2,
                             ulysses_sequence_parallel_size=2,
                             enable_shift_parallel=True,
                             shift_parallel_threshold=64)),
)
# The worlds that also run the fused suffix loop (with suffix decoding
# configured; its first runs are pipelined and synchronous all the same).
PARALLEL_FUSED_WORLDS = ("pp2 x sp2 shift",)
# The worlds checked at full depth only (no 2-layer pass: the script's
# time; the 2-layer pass of tp 2 and sp 2 x tp 2 stays).
PARALLEL_FULL_DEPTH_ONLY = ("dp2 x tp2", "pp2 x sp2 shift")
PARALLEL_LAYERS = 32          # Llama-3.1-8B's full depth
PARALLEL_PROMPTS = 8          # of 128-1024 tokens
PARALLEL_NEW_TOKENS = 16
PARALLEL_BLOCKS = 320         # 8 x 1040 tokens in 32-token pages, and room
# The prompts whose pages are compared with the single device's.
PARALLEL_PAGE_PROMPTS = 2
# Intra-op threads of each rank (4 ranks share the 8 host cores).
PARALLEL_THREADS = 2
# Kernel 5 on Llama-3.1-8B's weights as the mesh ranks hold them: (name,
# K, N, fused part widths, float32 out).  tp2: the tp pieces; sp2 x tp2
# with shift on: the SP-mode tp pieces (two interleaved groups) and the
# shift-mode fused pieces.
SHARD_MATMUL_SHAPES = (
    ("tp2 wqkv", 4096, 3072, (2048, 512, 512), False),
    ("sp2tp2 wqkv", 4096, 3072, (1024, 256, 256, 1024, 256, 256), False),
    ("sp2tp2 shift wqkv", 4096, 1536, (1024, 256, 256), False),
    ("tp2 w_gateup", 4096, 14336, (7168, 7168), False),
    ("sp2tp2 shift w_gateup", 4096, 7168, (3584, 3584), False),
    ("tp2 wo", 2048, 4096, None, False),
    ("sp2tp2 shift wo", 1024, 4096, None, False),
    ("tp2 w_down", 7168, 4096, None, False),
    ("sp2tp2 shift w_down", 3584, 4096, None, False),
    ("tp2 lm_head", 4096, 64128, None, True),
)
# Decode and shift steps (8 sequences: the 16-row bucket) and an SP
# prefill chunk (a 2048-token step over sp 2); the LM head at the sample
# rows only.
SHARD_MATMUL_ROWS = (16, 1024)
# Attention heads per rank: (Hq, Hkv) of tp2 and of sp2 x tp2.
SHARD_ATTN_HEADS = ((16, 4), (8, 2))
# dp 2 x tp 2 and pp 2 x sp 2: kernel 1 on a pp microbatch (the second
# 1024-row half of a 2048-token prefill step: its rows at ctx 1024-2048)
# at a stage's heads after the sp all-to-all; kernel 2 on a dp group's
# decode step (4 of phase 12's 8 sequences, ctx 128-1040) at a tp 2
# rank's heads, and on a fused microbatch (4 of 8 slots, qlen 8: the
# suffix loop's wide step) at the shift program's heads.
SHARD_PP_HEADS = (16, 4)
SHARD_DP_DECODE = 4
SHARD_FUSED_SLOTS, SHARD_FUSED_QLEN = 4, 8


def phase_shard_kernels(rng, seed):
    """Kernels 1, 2 and 5 against their plain versions at the shapes a
    mesh rank runs (timed, with the bound and SDPA / ``torch.mm``
    beside): kernel 1 on a 2048-token prefill chunk at qb 32 and kernel 2
    on a B=64 decode step at qlen 1, each at 16 / 4 and 8 / 2 heads, bf16
    KV; kernel 5 (fp8) on :data:`SHARD_MATMUL_SHAPES`.  Returns (ragged,
    grouped, fp8) cases."""
    import torch

    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    ragged, grouped, fp8_cases = [], [], []
    for hq, hkv in SHARD_ATTN_HEADS:
        tag = f"rank Hq={hq} Hkv={hkv}"
        case = Case(f"{tag} prefill 2048@ctx2048 bf16 qb=32",
                    [(2048, 2048)], torch.bfloat16, rng, t_pad=2048, hq=hq,
                    hkv=hkv)
        sched = case.schedule(32)

        def kern(case=case, sched=sched):
            return ra.ragged_paged_attention_kernel(
                case.q, case.kv, case.positions, case.req_idx,
                case.block_tables, case.seq_lens, qb=32, schedule=sched,
                kv_scale=case.kv_scale, layer=case.layer)

        def plain(case=case):
            return ragged_paged_attention_reference(
                case.q, case.kv[case.layer], case.positions, case.req_idx,
                case.block_tables, case.seq_lens,
                kv_scale=case.kv_scale[case.layer])

        ragged.append(run_case(case, kern, plain))
        del case
        ctx = rng.integers(128, 4096, 64)
        case = Case(f"{tag} decode B=64 qlen=1 bf16",
                    [(int(c), 1) for c in ctx], torch.bfloat16, rng,
                    t_pad=64, slot_rows=1, hq=hq, hkv=hkv)
        _, kern, plain = decode_step(case, 1)
        grouped.append(run_case(case, kern, plain))
        del case, kern, plain
        torch.cuda.empty_cache()
    hq, hkv = SHARD_PP_HEADS
    case = Case(f"pp stage Hq={hq} Hkv={hkv} microbatch 1024@ctx2048 bf16 "
                "qb=32", [(1024, 1024)], torch.bfloat16, rng, t_pad=1024,
                hq=hq, hkv=hkv)
    sched = case.schedule(32)

    def kern(case=case, sched=sched):
        return ra.ragged_paged_attention_kernel(
            case.q, case.kv, case.positions, case.req_idx,
            case.block_tables, case.seq_lens, qb=32, schedule=sched,
            kv_scale=case.kv_scale, layer=case.layer)

    def plain(case=case):
        return ragged_paged_attention_reference(
            case.q, case.kv[case.layer], case.positions, case.req_idx,
            case.block_tables, case.seq_lens,
            kv_scale=case.kv_scale[case.layer])

    ragged.append(run_case(case, kern, plain))
    del case
    for tag, (hq, hkv), b, qlen in (
            ("dp group", SHARD_ATTN_HEADS[0], SHARD_DP_DECODE, 1),
            ("fused microbatch", SHARD_PP_HEADS, SHARD_FUSED_SLOTS,
             SHARD_FUSED_QLEN)):
        ctx = rng.integers(128, 1041, b)
        case = Case(f"{tag} Hq={hq} Hkv={hkv} decode B={b} qlen={qlen} "
                    "bf16", [(int(c), qlen) for c in ctx], torch.bfloat16,
                    rng, t_pad=b * qlen, slot_rows=qlen, hq=hq, hkv=hkv)
        _, kern, plain = decode_step(case, qlen)
        grouped.append(run_case(case, kern, plain))
        del case, kern, plain
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    for name, k, n, parts, f32 in SHARD_MATMUL_SHAPES:
        q = quantized_weight("fp8", k, n, parts, gen)
        out_dtype = torch.float32 if f32 else torch.bfloat16
        for m in (16,) if f32 else SHARD_MATMUL_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            fp8_cases.append(run_matmul_case(
                f"fp8 {name} [{k},{n}] M={m}", q, x, out_dtype,
                fm.fp8_matmul_kernel, fm.fp8_matmul_reference))
        del q
        torch.cuda.empty_cache()
    failed = [c["case"] for c in ragged + grouped + fp8_cases
              if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return ragged, grouped, fp8_cases


def mesh_world(world=None):
    """``world`` when given (one world of 4 ranks shared by phases 12-14,
    :func:`main`'s), else a new one, closed on exit."""
    from arcticinference_tpu_torch.parallel.world import World

    if world is not None:
        return contextlib.nullcontext(world)
    return World(4, backend="gloo", timeout_s=600,
                 threads=PARALLEL_THREADS)


def parallel_config(par, dims, spec=None):
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  ParallelConfig,
                                                  SchedulerConfig,
                                                  SpeculativeConfig)

    dp = (par or {}).get("data_parallel_size", 1)
    return EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16",
                          max_model_len=2048, quantization="fp8",
                          hf_overrides=dims),
        # A dp group holds 1 / dp of the blocks: each the single device's.
        cache=CacheConfig(num_blocks=PARALLEL_BLOCKS * dp,
                          enable_prefix_caching=False),
        scheduler=SchedulerConfig(max_num_seqs=PARALLEL_PROMPTS,
                                  max_num_batched_tokens=2048),
        parallel=ParallelConfig(**(par or {})),
        speculative=None if spec is None else SpeculativeConfig(**spec))


def sp_then_shift(eng, ids, shard=0) -> dict:
    """A prefill of ``ids[:-1]`` in blocks borrowed from the engine's
    cache (the SP program on the shift world: >= 128 tokens), then one
    decode step of ``ids[-1]`` reading its pages (the shift program: one
    token); the sample row's float32 logits of each and the request's
    slots of the first and last layer after each (float32, on the host;
    ``{layer: [2, tokens, Hkv*D]}`` of the layers this rank's stage
    holds, when its dp group is ``shard``, the request's group)."""
    import torch

    from arcticinference_tpu_torch.engine.request import (Request,
                                                          SamplingParams)
    from arcticinference_tpu_torch.engine.scheduler import (ScheduledRequest,
                                                            SchedulerOutput)

    runner = eng.runner
    bm = eng.scheduler.block_managers[shard]
    req = Request(req_id="pages", prompt_token_ids=list(ids),
                  sampling=SamplingParams(max_tokens=1), dp_shard=shard)
    bm.grow_to(req.block_ids, len(ids))
    mine = eng.mesh is None or eng.mesh.dp_rank == shard
    held = runner.stage_layers
    layers = [layer for layer in (0, runner.arch.num_layers - 1)
              if layer in held and mine]
    out = {}
    try:
        with torch.inference_mode():
            for stage, ctx, n in (("prefill", 0, len(ids) - 1),
                                  ("decode", len(ids) - 1, 1)):
                req.num_computed_tokens = ctx
                sched = SchedulerOutput()
                sched.scheduled.append(ScheduledRequest(req, n, []))
                si = runner.prepare_inputs(sched)
                inputs = runner.upload(si.arrays)
                h = runner.prefill_hidden(inputs, si.attn_qb)
                # SwiftKV's forward returns the sample rows themselves.
                row = (h[:1] if runner.returns_rows
                       else h[inputs["logits_indices"][:1].long()])
                out[f"{stage}_logits"] = runner.logits(row)[0].cpu().numpy()
                # The slots the request wrote, K and V: [2, ctx + n, Hkv*D]
                # (a page's stale tail depends on which requests the
                # blocks served before, which dp changes).
                blocks = torch.tensor(req.block_ids, device=runner.kv.device)
                out[f"{stage}_pages"] = {
                    layer: runner.kv[layer - held.start][blocks]
                    .transpose(0, 1).flatten(1, 2)[:, :ctx + n].float()
                    .cpu().numpy() for layer in layers}
    finally:
        bm.free(req.block_ids)
    return out


def timed_generate(eng, prompts, params) -> tuple:
    """``LLMEngine``'s step loop over ``prompts`` with the
    ``SamplingParams`` ``params`` (the loop ``LLM.generate`` runs);
    returns (tokens per prompt, each token's top log-probabilities (when
    asked for), the wall ms of the steps by the mesh mode their forwards
    ran: ``sp``, ``shift`` or ``single``)."""
    import torch

    runner = eng.runner
    reqs = [eng.add_request(f"p{i}", p, params)
            for i, p in enumerate(prompts)]
    step_ms = {}
    while eng.has_unfinished:
        before = dict(runner.mode_steps)
        t = time.perf_counter()
        eng.step()
        if runner.device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ran = [m for m, c in runner.mode_steps.items()
               if c > before.get(m, 0)]
        if len(ran) == 1:
            step_ms.setdefault(ran[0], []).append(ms)
    return ([list(r.output_token_ids) for r in reqs],
            [[{int(k): float(v) for k, v in d.items()}
              for d in r.output_logprobs] for r in reqs],
            {m: dict(steps=len(v), p50_ms=float(np.median(v)),
                     mean_ms=float(np.mean(v))) for m, v in step_ms.items()})


def engine_checks(eng, prompts, ref: Path, write: bool, save=None,
                  also=None) -> dict:
    """:func:`sp_then_shift` over ``prompts``: the single device's
    kernel run (``write``) saves its logits and pages into ``ref``; any
    other run (a rank, or the single device through the plain matmuls)
    holds its own against them (a rank: its head slice of the pages).
    ``save``: a directory this run's own are written into too (another
    reference); ``also``: a second reference directory, its checks under
    the keys ``also/<key>``."""
    from arcticinference_tpu_torch.parallel import mesh as mesh_lib

    ref.mkdir(exist_ok=True)
    if save is not None:
        save.mkdir(exist_ok=True)
    count, first = eng.arch.num_kv_heads, 0
    if eng.mesh is not None:
        count, first = mesh_lib.kv_cache_heads(eng.arch.num_kv_heads,
                                               eng.mesh)
    d = eng.arch.head_dim
    checks = {}

    def check(key, got):
        for where in (ref, also):
            if where is None:
                continue
            want = np.load(where / f"{key}.npy")
            name = key if where is ref else f"also/{key}"
            if "logits" in key:
                checks[name] = logits_check(got, want)
                continue
            want = want[..., first * d:(first + count) * d]
            # The layers this rank's stage holds, of the first and last.
            order = (0, eng.arch.num_layers - 1)
            checks[name] = [dict(
                layer=layer,
                rel_diff=float(np.linalg.norm(g - want[order.index(layer)])
                               / np.linalg.norm(want[order.index(layer)])),
                max_abs_diff=float(np.abs(
                    g - want[order.index(layer)]).max()))
                for layer, g in got.items()]

    dp = eng.runner.dp
    for i, ids in enumerate(prompts):
        # Under dp, prompt i runs in group i mod dp, so each group's pages
        # are held against the single device's.
        got = sp_then_shift(eng, ids, shard=i % dp)
        for stage in ("prefill", "decode"):
            for kind in ("logits", "pages"):
                if kind == "pages" and i >= PARALLEL_PAGE_PROMPTS:
                    continue
                key = f"{stage}_{kind}_{i}"
                val = got[f"{stage}_{kind}"]
                if kind == "pages":
                    if not val:
                        continue       # another group's or stage's pages
                    val_w = np.stack([val[k] for k in sorted(val)])
                for where in (ref if write else None, save):
                    if where is not None:
                        np.save(where / f"{key}.npy",
                                val_w if kind == "pages" else val)
                if not write:
                    check(key, val)
    return checks


def collective_ms(eng, rows: int = 1024) -> dict:
    """ms per call of the mesh's collectives on this rank, at the shapes
    a Llama-3.1-8B step gives them (gloo, staged through host memory):
    the tp sum of an SP step's ``rows / sp`` hidden rows and of a decode
    step's 8, the sp all-to-all of their q chunk, the fused group's sum
    of 8 rows (a shift step), the LM head's gather of 16 sample rows."""
    import torch
    import torch.distributed as dist

    from arcticinference_tpu_torch.parallel.ulysses import all_gather_cat

    mesh, arch = eng.mesh, eng.arch
    dev = eng.runner.device
    d = arch.hidden_size
    hq = arch.num_heads // mesh.tp
    rows = min(rows, 2048 // mesh.sp // mesh.stages)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(fn, iters=10):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t) / iters * 1e3

    bf16 = dict(dtype=torch.bfloat16, device=dev)
    big = torch.zeros((rows // mesh.sp, d), **bf16)
    small = torch.zeros((8, d), **bf16)
    out = {}
    if mesh.tp_group is not None:
        out[f"tp all_reduce [{rows // mesh.sp}, {d}] bf16"] = timed(
            lambda: dist.all_reduce(big, group=mesh.tp_group))
        out[f"tp all_reduce [8, {d}] bf16"] = timed(
            lambda: dist.all_reduce(small, group=mesh.tp_group))
        head = eng.runner.params["lm_head"].shape[-1]
        logits = torch.zeros((16, head), dtype=torch.float32, device=dev)
        out[f"tp all_gather [16, {head}] f32"] = timed(
            lambda: all_gather_cat(logits, mesh.tp_group, dim=-1))
    if mesh.sp_group is not None:
        q = torch.zeros((mesh.sp, rows // mesh.sp, hq // mesh.sp,
                         arch.head_dim), **bf16)
        q_out = torch.empty_like(q)
        out[f"sp all_to_all {list(q.shape)} bf16"] = timed(
            lambda: dist.all_to_all_single(q_out, q, group=mesh.sp_group))
    if mesh.sp_tp_group is not None and mesh.sp > 1:
        out[f"sp_tp all_reduce [8, {d}] bf16"] = timed(
            lambda: dist.all_reduce(small, group=mesh.sp_tp_group))
    if mesh.dp_group is not None:
        # The gather of a group's hidden rows (a prefill step's, a
        # decode step's).
        for n in (rows, 8):
            x = torch.zeros((n, d), **bf16)
            out[f"dp all_gather [{n}, {d}] bf16"] = timed(
                lambda x=x: all_gather_cat(x, mesh.dp_group))
    if mesh.pp_group is not None:
        # A microbatch's activation handed to the next stage (a broadcast
        # over the pair; pp 2: each rank has one neighbour), and the last
        # stage's rows to every stage.
        from arcticinference_tpu_torch.parallel.pp import recv_prev, send_next

        for n in (rows, 8):
            x = torch.zeros((n, d), **bf16)
            if mesh.next_group is not None:
                fn = (lambda x=x: send_next(x, mesh))
            else:
                fn = (lambda n=n: recv_prev((n, d), torch.bfloat16, dev,
                                            mesh))
            out[f"pp stage hand-on [{n}, {d}] bf16"] = timed(fn)
        x = torch.zeros((2 * rows, d), **bf16)
        out[f"pp broadcast [{2 * rows}, {d}] bf16"] = timed(
            lambda: dist.broadcast(x, src=mesh.last_rank,
                                   group=mesh.pp_group))
    return out


def parallel_run(par, prompts, ref_dir, device, dims, members=None,
                 fused=False, two_layers=True) -> dict:
    """Phase 12's engines on ``device`` (``cuda:0``; every rank of a world
    shares it): the single device (``par`` None; it writes the references
    into ``ref_dir``) or one rank of a world over ``members`` (it holds
    its logits and pages against them; then it runs the same checks
    through the plain matmuls, the one device's own noise floor: another
    summation order).  First at ``dims``' width with 2 layers (phase 4's
    depth; not without ``two_layers``), then at full depth: the checks,
    the collectives' ms, and the
    pipelined and the synchronous generate runs, and with ``fused`` the
    fused suffix loop (its suffix cache seeded by the synchronous run),
    with the kernels' launches counted over them."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.parallel.world import subgroup

    cuda = device.startswith("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ref = Path(ref_dir)
    group = None if members is None else subgroup(members)
    res = {}
    full = dims["num_hidden_layers"]
    for depth in (2, full) if two_layers else (full,):
        t0 = time.perf_counter()
        spec = (dict(method="suffix", **SUFFIX_KNOBS)
                if fused and depth > 2 else None)
        llm = LLM(parallel_config(par, dict(dims, num_hidden_layers=depth),
                                  spec), device=device, group=group)
        if cuda:
            torch.cuda.synchronize()
        eng = llm.engine
        res["init_s"] = time.perf_counter() - t0
        res[f"checks_{depth}l"] = engine_checks(
            eng, prompts, ref / f"{depth}l", write=eng.mesh is None)
        if eng.mesh is None:
            # A fresh cache, as the kernel run had (a page's tail past
            # the prompt is compared too).
            eng.runner.kv.zero_()
            with plain_matmuls():
                res[f"noise_{depth}l"] = engine_checks(
                    eng, prompts, ref / f"{depth}l", write=False)
        if depth == 2:
            llm.close()
            del llm, eng
            continue
        if eng.mesh is not None:
            res["collective_ms"] = collective_ms(eng)
        reset_counts()
        eng.runner.digest = torch.zeros((), dtype=torch.int64,
                                        device=eng.runner.device)
        runs = {}
        loop = eng._fused
        eng._fused = None
        for name, pipelined in (("pipelined", True), ("sync", False),
                                ("fused", False)):
            if name == "fused":
                if loop is None:
                    continue
                eng._fused = loop
            eng._pipeline = pipelined
            toks, _, step_ms = timed_generate(eng, prompts, SamplingParams(
                max_tokens=PARALLEL_NEW_TOKENS, ignore_eos=True))
            runs[name] = dict(tokens=toks, step_ms=step_ms)
        if loop is not None:
            runs["fused"].update(width_stats=dict(loop.width_stats),
                                 spec=eng.spec_stats.summary())
        res["digest"] = int(eng.runner.digest)
        res["launches"] = launch_counts()
        res["runs"] = runs
        res["mode_steps"] = dict(eng.runner.mode_steps)
        res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if cuda else None)
        res["kv_shape"] = list(eng.runner.kv.shape)
        llm.close()
        del llm, eng
    if cuda:
        free_cuda_memory()
    return res


def logits_check(got, want) -> dict:
    """One row of float32 logits against the single device's: max |diff|
    against max |logit|, the argmax equal or a near tie (top two within
    twice the largest difference), and the cosine."""
    diff = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    top2 = np.sort(want)[-2:]
    cos = float(np.dot(got, want) / (np.linalg.norm(got)
                                     * np.linalg.norm(want)))
    return dict(max_abs_diff=diff, max_abs_logit=scale, cosine=cos,
                argmax_agree=int(np.argmax(got)) == int(np.argmax(want)),
                near_tie=bool(top2[1] - top2[0] <= 2 * diff),
                finite=bool(np.isfinite(got).all()))


# Phase 12's bounds.  Two layers: phase 4's (logits max |diff| <= 0.05 x
# max |logit|, the argmax equal or a near tie; the last layer's pages
# within its cache bound, 2e-2 relative).  Full depth: on random weights
# 32 layers carry bf16 roundings far, so the bounds stand on the one
# device's own noise floor, which each run measures (the single device
# through the plain matmuls against its kernels: another summation
# order, no mesh): the logits' max |diff| and cosine, and the last
# layer's pages, set just above that reading and the meshes' (Llama-3.1-
# 8B fp8 at 32 layers on an H100: one device 5.2% of max |logit|, cosine
# >= 0.99885, layer 31's pages 4.7%; the meshes 6.6%, >= 0.99812, 5.4%;
# PERF.md, Findings).  Layer 0's pages at either depth: within 2^-8
# relative (bf16 roundings of the projections only).
PAGES_LAYER0_TOL = 2 ** -8
PAGES_LAST_TOL = 2e-2
FULL_LOGITS_TOL = 0.08
FULL_COS = 0.997
FULL_PAGES_LAST_TOL = 0.07


def logits_ok(c, depth: int) -> bool:
    if not c["finite"]:
        return False
    if depth == 2:
        return (c["max_abs_diff"] <= 0.05 * c["max_abs_logit"]
                and (c["argmax_agree"] or c["near_tie"]))
    return (c["max_abs_diff"] <= FULL_LOGITS_TOL * c["max_abs_logit"]
            and c["cosine"] >= FULL_COS)


def pages_ok(c, depth: int) -> bool:
    return all(e["rel_diff"] <= (
        PAGES_LAYER0_TOL if e["layer"] == 0
        else PAGES_LAST_TOL if depth == 2 else FULL_PAGES_LAST_TOL)
        for e in c)


def worst_of(runs: list, depth: int) -> dict:
    """The worst logits and pages of ``runs`` (each a run's
    ``checks_<depth>l`` or ``noise_<depth>l``) against the single
    device's kernel run."""
    worst = {}
    for key in ("prefill_logits", "decode_logits"):
        cs = [c for r in runs for k, c in r.items() if k.startswith(key)]
        worst[f"{depth} layers {key}"] = dict(
            max_abs_diff=max(c["max_abs_diff"] for c in cs),
            max_abs_logit=max(c["max_abs_logit"] for c in cs),
            max_rel_diff=max(c["max_abs_diff"] / c["max_abs_logit"]
                             for c in cs),
            min_cosine=min(c["cosine"] for c in cs),
            argmax_agree=sum(c["argmax_agree"] for c in cs),
            rows=len(cs))
    for key in ("prefill_pages", "decode_pages"):
        by_layer: dict = {}
        for r in runs:
            for k, c in r.items():
                if k.startswith(key):
                    for e in c:
                        name = f"layer {e['layer']}"
                        by_layer[name] = max(by_layer.get(name, 0.0),
                                             e["rel_diff"])
        worst[f"{depth} layers {key}"] = by_layer
    return worst


def phase_parallel(rng, device="cuda:0", dims=None, card=None,
                   world=None) -> dict:
    """Phase 12 (see the module docstring): the single device, then each
    world of :data:`PARALLEL_WORLDS` on the same weights and prompts
    (Llama-3.1-8B at :data:`PARALLEL_LAYERS` layers unless ``dims``), on
    the ranks of ``world`` (4 ranks; a new one by default)."""
    from arcticinference_tpu_torch.config import ParallelConfig

    if dims is None:
        dims = dict(LLAMA_8B, num_hidden_layers=PARALLEL_LAYERS)
    prompts = [[int(x) for x in rng.integers(0, dims["vocab_size"], int(n))]
               for n in rng.integers(128, 1025, PARALLEL_PROMPTS)]
    card = card or smi()
    out = {}
    with tempfile.TemporaryDirectory() as ref_dir:
        t0 = time.perf_counter()
        single = parallel_run(None, prompts, ref_dir, device, dims)
        single["wall_s"] = time.perf_counter() - t0
        out["single"] = single
        log("  parallel single " + json.dumps(dict(
            {k: v for k, v in single.items() if k != "runs"},
            step_ms={n: r["step_ms"] for n, r in single["runs"].items()})))
        # One world of 4 ranks for every mesh: a smaller one runs on its
        # first ranks.
        t0 = time.perf_counter()
        with mesh_world(world) as world:
            out["world_start_s"] = time.perf_counter() - t0
            log(f"  parallel world of 4 ranks ready in "
                f"{out['world_start_s']:.1f} s")
            for name, par in PARALLEL_WORLDS:
                n = ParallelConfig(**par).world_size
                t0 = time.perf_counter()
                ranks = world.run(parallel_run, par, prompts, ref_dir,
                                  device, dims,
                                  members=list(range(n)) if n < 4 else None,
                                  fused=name in PARALLEL_FUSED_WORLDS,
                                  two_layers=name not in
                                  PARALLEL_FULL_DEPTH_ONLY,
                                  ranks=range(n))
                wall = time.perf_counter() - t0
                out[name] = check_world(name, par, ranks, single, wall, card)
    worlds = {k: w for k, w in out.items() if k in dict(PARALLEL_WORLDS)}
    if any(not w["ok"] for w in worlds.values()):
        raise AssertionError("phase 12: a world failed its checks: "
                             + json.dumps({k: w["failed"]
                                           for k, w in worlds.items()}))
    return out


def check_world(name, par, ranks, single, wall_s, card) -> dict:
    """A world's checks against the single device (see the bounds above
    :func:`logits_ok`); logs them."""
    keys = ("ragged_paged_attention_kernel",
            "grouped_decode_attention_kernel", "fp8_matmul_kernel")
    depths = sorted(int(k[7:-1]) for k in ranks[0]
                    if k.startswith("checks_"))
    depth = depths[-1]
    failed = []
    r0 = ranks[0]
    for run in r0["runs"]:
        if any(r["runs"][run]["tokens"] != r0["runs"][run]["tokens"]
               for r in ranks):
            failed.append(f"{run}: ranks returned different tokens")
    if any(r["digest"] != r0["digest"] for r in ranks):
        failed.append("ranks' output vectors differ: "
                      f"{[r['digest'] for r in ranks]}")
    prompts = r0["runs"]["pipelined"]["tokens"]
    agree = sum(a == b for a, b in zip(prompts,
                                       single["runs"]["pipelined"]["tokens"]))
    worst, noise = {}, {}
    for d in depths:
        runs = [(f"rank {r_i}", r[f"checks_{d}l"])
                for r_i, r in enumerate(ranks)]
        for who, run in runs + [("plain matmuls", single[f"noise_{d}l"])]:
            for key, c in run.items():
                if ("logits" in key and not logits_ok(c, d)) or (
                        "pages" in key and not pages_ok(c, d)):
                    failed.append(f"{d} layers, {who} {key}: {c}")
        worst.update(worst_of([r[f"checks_{d}l"] for r in ranks], d))
        noise.update(worst_of([single[f"noise_{d}l"]], d))
    for r_i, r in enumerate(ranks):
        if not all(r["launches"][k] > 0 for k in keys):
            failed.append(f"rank {r_i} launches {r['launches']}")
    modes = (("pp", "pp_shift") if par.get("pipeline_parallel_size", 1) > 1
             else ("sp", "shift"))
    if par.get("enable_shift_parallel") and not all(
            r0["mode_steps"].get(m, 0) > 0 for m in modes):
        failed.append(f"modes {r0['mode_steps']}")
    fused = r0["runs"].get("fused")
    if fused is not None and not (fused["width_stats"]["entries"] > 0
                                  and fused["width_stats"]["wide"] > 0):
        failed.append(f"the fused loop did not run: {fused}")
    res = dict(
        world=name, parallel=par, ranks=len(ranks), wall_s=wall_s,
        bound=f"2 layers: logits max|diff| <= 0.05 x max|logit| with the "
              f"argmax equal or a near tie, pages rel diff <= "
              f"{PAGES_LAYER0_TOL} (layer 0) / {PAGES_LAST_TOL} (last); "
              f"{depth} layers: logits max|diff| <= {FULL_LOGITS_TOL} x "
              f"max|logit| and cosine >= {FULL_COS}, pages rel diff <= "
              f"{PAGES_LAYER0_TOL} (layer 0) / {FULL_PAGES_LAST_TOL} (last)",
        worst=worst, noise_floor=noise, prompts_with_single_tokens=f"{agree}/{len(prompts)}",
        mode_steps=r0["mode_steps"],
        launches=[{k: r["launches"][k] for k in keys} for r in ranks],
        init_s=[r["init_s"] for r in ranks],
        peak_gib=[r["peak_gib"] for r in ranks],
        kv_shapes=[r["kv_shape"] for r in ranks],
        collective_ms=r0["collective_ms"],
        digests=[r["digest"] for r in ranks],
        step_ms={run: r0["runs"][run]["step_ms"] for run in r0["runs"]},
        fused={k: v for k, v in (fused or {}).items() if k != "tokens"},
        single_step_ms={run: single["runs"][run]["step_ms"]
                        for run in ("pipelined", "sync")},
        timing=f"gloo, host-staged, one card: {card}",
        failed=failed, ok=not failed)
    log("  parallel " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Phase 13: the OpenAI server on a mesh (parallel/multihost.py)
# ---------------------------------------------------------------------------

# The served worlds of phase 13, ranks sharing cuda:0 over gloo as phase
# 12's: (i) tp 2 on the pipelined step; (ii) sp 2 x tp 2 with shift and
# suffix speculation, on the fused loop.
SERVE_MESH_WORLDS = (
    ("tp2", dict(tensor_parallel_size=2), None),
    ("sp2 x tp2 shift suffix", PARALLEL_WORLDS[1][1],
     dict(method="suffix")),
)
SERVE_MESH_ALONE = (128, 1024)   # (a): prompt lengths, each sent alone
SERVE_MESH_BURST = 8             # (b): prompts of 128-1024 tokens at once
SERVE_MESH_NEW = 16


async def serve_mesh_burst(url: str, prompts) -> dict:
    """(b): every prompt streamed at once; each must finish with
    ``length`` after SERVE_MESH_NEW tokens.  TTFT / TPOT p50 and output
    tok/s on the client's clock."""
    results = await asyncio.gather(*[completion(url, dict(
        prompt_token_ids=p, max_tokens=SERVE_MESH_NEW, ignore_eos=True),
        stream=True) for p in prompts])
    bad = [r for r in results
           if r["status"] != 200 or r["finish"] != "length"
           or len(r["ids"]) != SERVE_MESH_NEW or not r["done"]]
    wall = max(r["t1"] for r in results) - min(r["t0"] for r in results)
    return dict(
        requests=len(results), failed=len(bad),
        ttft_p50_ms=float(np.median([r["ttft_s"] * 1e3 for r in results
                                     if r["ttft_s"] is not None])),
        tpot_p50_ms=float(np.median(
            [r["decode_s"] / (len(r["ids"]) - 1) * 1e3 for r in results
             if len(r["ids"]) > 1])),
        output_tokens_per_s=sum(len(r["ids"]) for r in results) / wall,
        wall_s=wall)


def serve_mesh_rank(par, spec, alone, burst_prompts, channel_port, device,
                    dims, members=None) -> dict:
    """One rank of a served world (phase 13).  Rank 0 builds the OpenAI
    server, waits for its followers, attaches the channel and sends over
    HTTP (a) each of ``alone`` by itself, (b) ``burst_prompts`` at once,
    (c) with speculation, ``alone[-1]`` again (its continuation still in
    the suffix cache); every other rank replays its steps
    (``follower_serve``).  Then every rank runs ``LLM.generate``'s step
    loop over each of ``alone`` by itself on the same engine, in
    lockstep, its steps timed by the engine as the served (a) steps
    were.  Before each (a) request and each offline prompt the
    engine's speculation state is made new on every rank (as a fresh
    engine's), so the two runs of a prompt start from the same state and
    run the same program.  ``members``: the world's ranks this served
    mesh runs on (all by default)."""
    import torch
    import torch.distributed as dist

    from arcticinference_tpu_torch.config import SpeculativeConfig
    from arcticinference_tpu_torch.engine.engine import LLMEngine
    from arcticinference_tpu_torch.engine.fused_decode import (
        FusedDecodeLoop)
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.parallel import multihost
    from arcticinference_tpu_torch.serving.openai_server import OpenAIServer
    from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache
    from arcticinference_tpu_torch.stats import StepTimeStats

    torch.backends.cuda.matmul.allow_tf32 = False
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))
    from arcticinference_tpu_torch.parallel.world import subgroup

    cfg = parallel_config(par, dims)
    if spec is not None:
        cfg.speculative = SpeculativeConfig(**spec)
    group = None if members is None else subgroup(members)
    leader = dist.get_rank(group) == 0
    t0 = time.perf_counter()
    server = (OpenAIServer(cfg, device=device, group=group) if leader
              else None)
    eng = (server.engine.engine if leader
           else LLMEngine(cfg, device=device, group=group))
    runner = eng.runner
    sync()
    res = dict(init_s=time.perf_counter() - t0)
    runner.digest = torch.zeros((), dtype=torch.int64, device=runner.device)

    def fresh_spec_state():
        if eng._suffix_cache is not None:
            eng._suffix_cache = SuffixCache(
                cfg.speculative.suffix_cache_max_depth)
            eng._fused = FusedDecodeLoop(eng)

    reset_counts()
    if leader:
        channel = multihost.LeaderChannel(
            dist.get_world_size(group) - 1, channel_port,
            bind_host="127.0.0.1", accept_timeout=600)
        channel.wait_connected()
        server.engine.attach_channel(channel)
        loop = asyncio.new_event_loop()
        try:
            url = "http://127.0.0.1:" + str(loop.run_until_complete(
                server.app.start("127.0.0.1", 0)))
            served = []
            for p in alone:
                fresh_spec_state()
                r = loop.run_until_complete(completion(url, dict(
                    prompt_token_ids=p, max_tokens=SERVE_MESH_NEW,
                    ignore_eos=True), stream=True))
                served.append(r)
            res["alone"] = [dict(ids=r["ids"], ttft_ms=r["ttft_s"] * 1e3,
                                 tpot_ms=r["decode_s"] / (len(r["ids"]) - 1)
                                 * 1e3) for r in served]
            res["alone_step_times"] = eng.step_times.summary()
            res["burst"] = loop.run_until_complete(
                serve_mesh_burst(url, burst_prompts))
            if spec is not None:
                fused = dict(eng.width_stats)
                drafts = eng.spec_stats.num_drafts
                r = loop.run_until_complete(completion(url, dict(
                    prompt_token_ids=alone[-1], max_tokens=SERVE_MESH_NEW,
                    ignore_eos=True)))
                res["warm"] = dict(
                    ids=r["ids"],
                    fused_steps=sum(eng.width_stats[k] - fused[k]
                                    for k in ("wide", "narrow")),
                    drafts=eng.spec_stats.num_drafts - drafts,
                    spec=eng.spec_stats.summary())
            res.update(sent=dict(channel.sent),
                       message_bytes=dict(channel.last_bytes),
                       dead=server.engine.dead)
            res["launches"] = launch_counts()
            # Stopping the app closes the engine and the channel: the
            # followers get ``stop``.
            loop.run_until_complete(server.app.stop())
        finally:
            server.engine.close()
            loop.close()
        runner.mh_channel = None
    else:
        channel = multihost.FollowerChannel("127.0.0.1", channel_port,
                                            connect_timeout=600)
        try:
            res["replayed"] = multihost.follower_serve(eng, channel)
        finally:
            channel.close()
        res["launches"] = launch_counts()
    sync()
    res.update(dispatches=runner.dispatches, digest=int(runner.digest),
               mode_steps=dict(runner.mode_steps))
    # The offline runs on the same engines, in lockstep: LLM.generate's
    # loop, its steps timed by the engine as the served ones were.
    eng.step_times = StepTimeStats()
    offline = []
    for i, p in enumerate(alone):
        fresh_spec_state()
        req = eng.add_request(f"offline-{i}", p, SamplingParams(
            max_tokens=SERVE_MESH_NEW, ignore_eos=True))
        while eng.has_unfinished:
            eng.step()
        offline.append(list(req.output_token_ids))
    res.update(offline=offline, offline_step_times=eng.step_times.summary())
    eng.close()
    # The rank lives on (one world for phases 12-14): its engine's memory
    # goes back to the card.
    del eng, runner, server
    if device.startswith("cuda"):
        free_cuda_memory()
    return res


def phase_serve_mesh(rng, device="cuda:0", dims=None, card=None,
                     world=None) -> dict:
    """Phase 13 (see the module docstring): each world of
    :data:`SERVE_MESH_WORLDS` served from its leader over HTTP, its
    checks (a)-(d), on the first ranks of ``world`` (4 ranks; a new one
    by default)."""
    if dims is None:
        dims = dict(LLAMA_8B, num_hidden_layers=PARALLEL_LAYERS)
    vocab = dims["vocab_size"]
    alone = [[int(x) for x in rng.integers(0, vocab, n)]
             for n in SERVE_MESH_ALONE]
    burst_prompts = [[int(x) for x in rng.integers(0, vocab, int(n))]
                     for n in rng.integers(128, 1025, SERVE_MESH_BURST)]
    card = card or smi()
    keys = ("ragged_paged_attention_kernel",
            "grouped_decode_attention_kernel", "fp8_matmul_kernel")
    out = {}
    with mesh_world(world) as world:
        ranks_of = {}
        for name, par, spec in SERVE_MESH_WORLDS:
            n = (par.get("tensor_parallel_size", 1)
                 * par.get("ulysses_sequence_parallel_size", 1))
            t0 = time.perf_counter()
            ranks_of[name] = (world.run(
                serve_mesh_rank, par, spec, alone, burst_prompts,
                free_port(), device, dims,
                members=list(range(n)) if n < 4 else None,
                ranks=range(n)), time.perf_counter() - t0)
    for name, par, spec in SERVE_MESH_WORLDS:
        n = (par.get("tensor_parallel_size", 1)
             * par.get("ulysses_sequence_parallel_size", 1))
        ranks, wall_s = ranks_of[name]
        lead, followers = ranks[0], ranks[1:]
        failed = []
        # (a) each prompt alone: the served tokens are LLM.generate's.
        for i, (a, want) in enumerate(zip(lead["alone"], lead["offline"])):
            if a["ids"] != want or len(want) != SERVE_MESH_NEW:
                failed.append(f"(a) prompt {i}: served {a['ids']} offline "
                              f"{want}")
        if any(r["offline"] != lead["offline"] for r in followers):
            failed.append("(a) ranks' offline tokens differ")
        # (b) the burst, the mirror's counts and every rank's digest.
        if lead["burst"]["failed"] or lead["dead"]:
            failed.append(f"(b) burst {lead['burst']}")
        fused = lead["sent"].get("fused", 0)
        for r_i, r in enumerate(followers, 1):
            if r["dispatches"] != lead["dispatches"] or \
                    r["replayed"].get("dispatch") != lead["dispatches"]:
                failed.append(f"(b) rank {r_i} replayed {r['replayed']}, "
                              f"leader dispatched {lead['dispatches']}")
            if r["digest"] != lead["digest"]:
                failed.append(f"(b) rank {r_i} digest {r['digest']} != "
                              f"{lead['digest']}")
            if r["replayed"].get("fused", 0) != fused:
                failed.append(f"(c) rank {r_i} replayed "
                              f"{r['replayed'].get('fused', 0)} fused "
                              f"steps of {fused}")
        # (c) suffix speculation through the served world.
        if spec is not None and not (lead["warm"]["fused_steps"] > 0
                                     and lead["warm"]["drafts"] > 0):
            failed.append(f"(c) warm request {lead['warm']}")
        # (d) kernels 1, 2 and 5 on every rank.
        for r_i, r in enumerate(ranks):
            if not all(r["launches"][k] > 0 for k in keys):
                failed.append(f"(d) rank {r_i} launches {r['launches']}")
        res = dict(
            world=name, parallel=par, speculative=spec, ranks=n,
            wall_s=wall_s,
            init_s=[r["init_s"] for r in ranks],
            alone=[dict(prompt_tokens=len(p), ttft_ms=a["ttft_ms"],
                        tpot_ms=a["tpot_ms"])
                   for p, a in zip(alone, lead["alone"])],
            served_step_times=lead["alone_step_times"],
            offline_step_times=lead["offline_step_times"],
            burst=lead["burst"], warm=lead.get("warm"),
            dispatches=[r["dispatches"] for r in ranks],
            replayed=[r["replayed"] for r in followers],
            digests=[r["digest"] for r in ranks],
            sent=lead["sent"], message_bytes=lead["message_bytes"],
            mode_steps=lead["mode_steps"],
            launches=[{k: r["launches"][k] for k in keys} for r in ranks],
            timing=f"gloo, host-staged, one card: {card}",
            failed=failed, ok=not failed)
        log("  serve_mesh " + json.dumps(res))
        b = res["burst"]
        log(f"  serve_mesh {name} burst of {b['requests']} (gloo, "
            f"host-staged, one card: {card}): TTFT p50 "
            f"{b['ttft_p50_ms']:.1f} ms, TPOT p50 {b['tpot_p50_ms']:.1f} "
            f"ms, {b['output_tokens_per_s']:.2f} tok/s")
        out[name] = res
    if any(not w["ok"] for w in out.values()):
        raise AssertionError("phase 13: a served world failed its checks: "
                             + json.dumps({k: w["failed"]
                                           for k, w in out.items()}))
    return out


# ---------------------------------------------------------------------------
# Phase 14: SwiftKV, Mixtral, token trees and guided decoding on meshes
# ---------------------------------------------------------------------------

# Phase 14 runs phase 12's worlds (ranks sharing cuda:0 over gloo) in one
# world of four ranks, whose first two make the tp 2 meshes.
MESH_TP2, MESH_SHIFT = PARALLEL_WORLDS[0][1], PARALLEL_WORLDS[1][1]
# Prompts whose logits and pages each world holds against the single
# device's (a prefill in the SP program, then a decode step in the shift
# one: sp_then_shift); two keep the whole script within its time (the
# SP prefills of up to 1024 tokens cost 1-3 s a prompt over gloo).
MESH_CHECK_PROMPTS = 2
# A mesh sums in a third order.  The one device's noise floor (its plain
# matmuls B against its kernels A) reads |A - B|; the mesh C lies within
# |A - C| <= |A - T| + |T - C| of A, each term of the floor's size
# around the exact T: twice the floor on the logits' and pages' relative
# differences, four times on the cosine's deficit (quadratic in them).
# A mesh also rounds each rank's share of a row-parallel sum before the
# sum adds them, which the one device never does.  A mixture of experts'
# A is the one device with that rounding (:func:`mesh_rounding`), whose
# own reading against the plain one device is reported beside (PERF.md,
# Findings).
MESH_FLOOR_FACTOR = 2.0
# The row-parallel sums whose rounding :func:`mesh_rounding` gives the
# one device, each alone and then all (the reference).
MESH_ROUNDINGS = (("experts",), ("wo",), ("experts", "wo"))
# Mixtral-8x7B's depth in the sp 2 x tp 2 world: its four ranks each hold
# half the experts (stored cut over tp), so 32 layers would need ~84 GiB
# of fp8 experts on the one card; 16 layers hold ~42 GiB.
MESH_MOE_SHIFT_LAYERS = 16
# Traffic: SwiftKV 8 prompts of 128-1024 tokens x 16 (phase 12's);
# Mixtral 4 x 16; token trees 4 x 16 (Llama-3.1-8B).
MESH_MOE_PROMPTS = 4
MESH_TREE_PROMPTS = 4
# The guided request of world (a) tp 2: a date over the synthetic
# 128256-token vocabulary (phase 7's grammar).
MESH_GUIDED = GUIDED_SPECS[1][1]
# Row R on a rank's Mixtral-8x7B expert stacks: (world, experts a rank
# holds), at a decode step's 128 rows (64 x top-2) and 512.
MESH_MOE_RANKS = (("tp2", 4), ("sp2tp2 shift", 2))
MESH_MOE_ROWS = (128, 512)
# Kernel 5 on Llama-3.1-SwiftKV-8B's fused K / V operand as a rank holds
# it: the 16 later layers' K and V parts of 1024 / (tp [* sp]) columns,
# per-column fp8 scales; a decode step's rows and a 2048-token step's.
MESH_SWIFT_KV_SHAPES = (("tp2 wkv_swift", 4096, 16384, (512,) * 32),
                        ("sp2tp2 shift wkv_swift", 4096, 8192, (256,) * 32))
MESH_SWIFT_KV_ROWS = (16, 2048)


def phase_mesh_model_kernels(rng, seed):
    """Row R, kernel 5 and kernel 1t against their plain versions at the
    shapes a rank of phase 14 runs them (timed, with the bound and the
    library call beside): row R (fp8) on a rank's Mixtral-8x7B expert
    stacks at :data:`MESH_MOE_ROWS` rows, every row of the step (the rows
    routed to other ranks' experts clamped into the last group, as
    ``_moe_mlp`` clamps them on rank 0); kernel 5 on SwiftKV-8B's fused
    K / V piece; kernel 1t on the 30-node tree verify step at a rank's
    heads.  Returns (grouped, fp8, tree) cases."""
    import torch

    from arcticinference_tpu_torch.models.mixtral import quantize_experts
    from arcticinference_tpu_torch.ops.attention import (
        ragged_paged_attention_reference)
    from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    grouped, fp8_cases, tree = [], [], []
    for tag, el in MESH_MOE_RANKS:
        for wname, k, n in MOE_SHAPES:
            q = quantize_experts(torch.randn(
                (el, k, n), generator=gen, device="cuda").to(torch.bfloat16),
                "fp8")
            for r in MESH_MOE_ROWS:
                c8 = moe_counts(rng, "uniform", r)
                counts = np.concatenate([c8[:el - 1], [c8[el - 1:].sum()]])
                offsets = torch.tensor(np.concatenate([[0], np.cumsum(
                    counts)]), dtype=torch.int32, device="cuda")
                xs = torch.randn((r, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                grouped.append(moe_kernel_case(
                    f"fp8 {tag} {wname} [{el},{k},{n}] R={r} uniform", xs,
                    q, offsets, counts, timed=True))
            del q
            torch.cuda.empty_cache()
    for name, k, n, parts in MESH_SWIFT_KV_SHAPES:
        q = quantized_weight("fp8", k, n, parts, gen)
        for m in MESH_SWIFT_KV_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            fp8_cases.append(run_matmul_case(
                f"fp8 {name} [{k},{n}] M={m}", q, x, torch.bfloat16,
                fm.fp8_matmul_kernel, fm.fp8_matmul_reference))
        del q
        torch.cuda.empty_cache()
    trees = [(int(c), 1, TREE_PARENTS) for c in rng.integers(896, 1153, 16)]
    for hq, hkv in SHARD_ATTN_HEADS:
        name = (f"rank Hq={hq} Hkv={hkv} tree verify 16x(1+{TREE_NODES})"
                "@ctx~1024 bf16")
        case = TreeCase(name, trees, torch.bfloat16, rng, 512, hq=hq,
                        hkv=hkv)
        sched = case.schedule(32)

        def kern(case=case, sched=sched):
            return ra.ragged_paged_attention_kernel(
                case.q, case.kv, case.positions, case.req_idx,
                case.block_tables, case.seq_lens, qb=32, schedule=sched,
                kv_scale=case.kv_scale, layer=case.layer)

        def plain(case=case):
            return ragged_paged_attention_reference(
                case.q, case.kv[case.layer], case.positions, case.req_idx,
                case.block_tables, case.seq_lens,
                kv_scale=case.kv_scale[case.layer],
                tree_start=case.tree_start, row_tree_mask=case.row_mask)

        case.name = f"{name} qb=32"
        tree.append(run_case(case, kern, plain))
        del case
        torch.cuda.empty_cache()
    failed = [c["case"] for c in grouped + fp8_cases + tree if not c["ok"]]
    if failed:
        raise AssertionError(f"kernel disagrees with plain version: {failed}")
    return grouped, fp8_cases, tree


def mesh_model_config(job, par=None):
    """Phase 14's engine of ``job`` (its ``model`` of :data:`MODELS` in
    fp8, its ``layers``, its ``spec``: SpeculativeConfig keywords) on
    ``par``'s mesh, sized as phase 12's (2048-token steps, 320 cache
    blocks a rank, prefix caching off); the pipelined step unless a
    speculator runs."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  ParallelConfig,
                                                  SchedulerConfig,
                                                  SpeculativeConfig)

    arch_name, dims = MODELS[job["model"]]
    dims = dict(dims)
    if job.get("layers"):
        dims["num_hidden_layers"] = job["layers"]
    spec = job.get("spec")
    return EngineConfig(
        model=ModelConfig(model=arch_name, dtype="bfloat16",
                          max_model_len=2048, quantization="fp8",
                          hf_overrides=dims),
        cache=CacheConfig(num_blocks=PARALLEL_BLOCKS,
                          enable_prefix_caching=False),
        scheduler=SchedulerConfig(max_num_seqs=PARALLEL_PROMPTS,
                                  max_num_batched_tokens=2048),
        parallel=ParallelConfig(**(par or {})),
        speculative=None if spec is None else SpeculativeConfig(**spec))


@contextlib.contextmanager
def mesh_rounding(par, parts, wo=None):
    """Mixtral on one device with the rounding of the row-parallel sums of
    a world ``par``: each sum that world splits over its ranks (tp of
    them in the SP program; tp x sp in the shift program, which runs the
    steps of at most its threshold's tokens) taken as that many shares,
    each rounded to the activations' dtype and the shares added in it, as
    each rank rounds its share before the sum adds them.  ``parts``:
    ``"experts"``, the expert block (its experts cut into shards; the
    router runs once a layer, the shards share its experts), and
    ``"wo"``, attention's output projection (the rows of ``wo``, the
    stacked projection, cut into the heads' shares)."""
    import types

    from arcticinference_tpu_torch.models import llama as llama_mod
    from arcticinference_tpu_torch.models import mixtral
    from arcticinference_tpu_torch.ops import moe
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    tp = par.get("tensor_parallel_size", 1)
    sp = par.get("ulysses_sequence_parallel_size", 1)
    shift = par.get("enable_shift_parallel", False) and sp > 1
    threshold = par.get("shift_parallel_threshold", 0)
    moe_mlp0, matmul0 = mixtral._moe_mlp, llama_mod.matmul

    def shares(rows):
        return tp * sp if shift and rows <= threshold else tp

    def cut(w, start, size, scale_too):
        """Rows ``start .. start + size`` of ``w`` (an expert stack's
        experts, with their scales; a product's input rows, whose scales
        are per layer or column)."""
        if isinstance(w, QuantizedLinear):
            scale = w.scale.narrow(0, start, size) if (
                scale_too and w.scale.dim() > 0) else w.scale
            return QuantizedLinear(w.weight.narrow(0, start, size), scale)
        return w.narrow(0, start, size)

    def total(ys):
        return sum(ys[1:], ys[0])

    def moe_mlp(x, lp, arch, pctx=None):
        el = arch.num_experts // shares(x.shape[0])
        route, routed = moe.route, []

        def once(*a):
            if not routed:
                routed.append(route(*a))
            return routed[0]

        moe.route = once
        try:
            return total([moe_mlp0(
                x, dict(lp, **{k: cut(lp[k], e0, el, True)
                               for k in ("w_gate", "w_up", "w_down")}),
                arch, types.SimpleNamespace(
                    moe_expert_range=lambda _, e0=e0: (e0, el)))
                for e0 in range(0, arch.num_experts, el)])
        finally:
            moe.route = route

    wo_ptrs = set()
    if "wo" in parts:
        w = wo.weight if isinstance(wo, QuantizedLinear) else wo
        wo_ptrs = {w[i].data_ptr() for i in range(w.shape[0])}

    def matmul(x, w, out_dtype=None):
        if (w.weight if isinstance(w, QuantizedLinear)
                else w).data_ptr() not in wo_ptrs:
            return matmul0(x, w, out_dtype)
        size = x.shape[-1] // shares(x.shape[0])
        return total([matmul0(x[:, k0:k0 + size].contiguous(),
                              cut(w, k0, size, False), out_dtype)
                      for k0 in range(0, x.shape[-1], size)])

    if "experts" in parts:
        mixtral._moe_mlp = moe_mlp
    llama_mod.matmul = matmul
    try:
        yield
    finally:
        mixtral._moe_mlp, llama_mod.matmul = moe_mlp0, matmul0


def mesh_model_run(job, par, prompts, ref_dir, device, members=None,
                   seed_tokens=None) -> dict:
    """One engine of phase 14 on ``device`` (``cuda:0``; every rank
    shares it): the single device (``par`` None; it writes the logits,
    pages and, with ``job["routes"]``, Mixtral's experts into ``ref_dir``
    and measures its own noise floor through the plain matmuls) or one
    rank of a world over ``members`` (it holds its own against them,
    Mixtral's routers forced onto the single device's experts).  Then
    the job's traffic, the kernels' launches counted over it: greedy
    tokens (with ``seed_tokens``, the suffix cache seeded from them as
    phase 5 seeds it; ``job["tree"]`` on the single device first runs
    once unseeded, which gives the seed); with ``job["guided"]`` one
    guided request (the single device on the synchronous step with its
    top-2 log-probabilities, a rank on the pipelined step and the grammar
    pool).  A mixture of experts (``job["routes"]``): the single device
    also runs the checks with the rounding of the row-parallel sums of
    the world ``job["world"]`` (:func:`mesh_rounding`; all of them:
    written as the ranks' reference)."""
    import torch

    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.parallel.world import subgroup
    from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device.startswith("cuda")
    ref = Path(ref_dir)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = mesh_model_config(job, par)
    llm = LLM(cfg, device=device,
              group=subgroup(members) if par and members else None)
    eng = llm.engine
    runner, arch = eng.runner, eng.arch
    if cuda:
        torch.cuda.synchronize()
    res = dict(init_s=time.perf_counter() - t0)
    write = eng.mesh is None
    check_prompts = prompts[:MESH_CHECK_PROMPTS]
    routed = bool(job.get("routes"))

    def routes(force):
        if not routed:
            return contextlib.nullcontext()
        return recorded_routing(
            ref / "routes" if force else None,
            sp_rank=eng.mesh.sp_rank if eng.mesh is not None else 0,
            save=None if force else ref / "routes")

    t0 = time.perf_counter()
    with routes(not write):
        # A mixture of experts on a mesh: held to the single device with
        # the mesh's rounding of its row-parallel sums (``ref / "mesh"``),
        # and read against the plain single device too.
        res["checks"] = engine_checks(
            eng, check_prompts, ref / "mesh" if routed and not write else ref,
            write=write, also=ref if routed and not write else None)
    if write:
        # The one device's own noise floor: its plain matmuls (another
        # summation order) against its kernels, on a fresh cache.
        runner.kv.zero_()
        with plain_matmuls(), routes(True):
            res["noise"] = engine_checks(eng, check_prompts, ref,
                                         write=False)
    if write and routed:
        # The one device with the rounding of the world's row-parallel
        # sums (:func:`mesh_rounding`), each part alone and all together
        # (the world's reference), read against the plain single device.
        res["rounding"] = {}
        for parts in MESH_ROUNDINGS:
            runner.kv.zero_()
            with mesh_rounding(job["world"], parts,
                               runner.params["layers"]["wo"]), routes(True):
                res["rounding"][" + ".join(parts)] = engine_checks(
                    eng, check_prompts, ref, write=False,
                    save=ref / "mesh" if parts == MESH_ROUNDINGS[-1]
                    else None)
    res["checks_s"] = time.perf_counter() - t0
    greedy = SamplingParams(max_tokens=job["new"], ignore_eos=True,
                            logprobs=2 if job.get("tree") else None)
    if job.get("tree") and write:
        res["seed_tokens"] = seed_tokens = timed_generate(
            eng, prompts, greedy)[0]
        eng._suffix_cache = SuffixCache(
            cfg.speculative.suffix_cache_max_depth)
    if seed_tokens is not None:
        seed_suffix_cache(eng._suffix_cache, prompts, seed_tokens,
                          arch.vocab_size)
    spec0 = (eng.spec_stats.num_drafts, eng.spec_stats.num_accepted_tokens)
    reset_counts()
    t0 = time.perf_counter()
    tokens, logprobs, step_ms = timed_generate(eng, prompts, greedy)
    res.update(tokens=tokens, logprobs=logprobs, step_ms=step_ms,
               generate_s=time.perf_counter() - t0,
               drafts=eng.spec_stats.num_drafts - spec0[0],
               accepted=eng.spec_stats.num_accepted_tokens - spec0[1],
               width_stats=dict(eng.width_stats or {}),
               step_kinds=sorted(eng.step_times.summary()))
    if job.get("guided"):
        from arcticinference_tpu_torch.serving.structured import (
            make_guided_decoder)

        tok = SyntheticTokenizer(arch.vocab_size)
        pipelined0 = eng.step_times.summary().get("pipelined", {}).get(
            "count", 0)
        dec = make_guided_decoder(tok, MESH_GUIDED,
                                  vocab_size=arch.vocab_size)
        t0 = time.perf_counter()
        g_tok, g_lp, _ = timed_generate(eng, prompts[:1], SamplingParams(
            max_tokens=job["new"], guided=dec,
            logprobs=2 if write else None))
        res["guided"] = dict(
            tokens=g_tok[0], logprobs=g_lp[0], text=tok.decode(g_tok[0]),
            pool=runner._guided_pool is not None,
            pipelined_steps=eng.step_times.summary().get(
                "pipelined", {}).get("count", 0) - pipelined0,
            seconds=time.perf_counter() - t0)
    res.update(launches=launch_counts(), mode_steps=dict(runner.mode_steps),
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else None),
               kv_shape=list(runner.kv.shape),
               experts_held=(int(runner.params["layers"]["w_gate"].shape[1])
                             if getattr(arch, "num_experts", 0) else None))
    llm.close()
    del llm, eng, runner
    if cuda:
        free_cuda_memory()
    return res


def clear_agreement(got, want, want_logprobs, threshold) -> dict:
    """``got`` against the single device's ``want``, prompt by prompt: a
    prompt may part from it only at a token whose top-2 log-probability
    margin on the single device is within ``threshold`` (a near tie that
    the summation order decides; past it the two runs continue from other
    tokens).  Returns the prompts equal, where and at which margin the
    others parted, and ``ok``."""
    parted = {}
    for i, (g, w, lp) in enumerate(zip(got, want, want_logprobs)):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                 None if len(g) == len(w) else min(len(g), len(w)))
        if j is None:
            continue
        top = sorted(lp[j].values(), reverse=True) if j < len(lp) else []
        parted[i] = dict(at=j, margin=(top[0] - top[1]) if len(top) > 1
                         else float("inf"))
    return dict(equal=len(got) - len(parted), of=len(got), parted=parted,
                threshold=threshold,
                ok=all(p["margin"] <= threshold for p in parted.values()))


def floor_bounds(noise: dict, depth: int) -> dict:
    """Phase 14's bounds against the single device: phase 12's full-depth
    bounds (:data:`FULL_LOGITS_TOL`, :data:`FULL_COS`,
    :data:`FULL_PAGES_LAST_TOL`), widened to :data:`MESH_FLOOR_FACTOR`
    times this model's own one-device noise floor (``noise``: its plain
    matmuls against its kernels; its square for the cosine's deficit)
    where that is larger; layer 0's pages within
    :data:`PAGES_LAYER0_TOL`."""
    w = worst_of([noise], depth)
    rel = max(w[f"{depth} layers {k}_logits"]["max_rel_diff"]
              for k in ("prefill", "decode"))
    cos = min(w[f"{depth} layers {k}_logits"]["min_cosine"]
              for k in ("prefill", "decode"))
    last = max(w[f"{depth} layers {k}_pages"][f"layer {depth - 1}"]
               for k in ("prefill", "decode"))
    f = MESH_FLOOR_FACTOR
    return dict(logits_rel=max(FULL_LOGITS_TOL, f * rel),
                cosine=min(FULL_COS, 1 - f * f * (1 - cos)),
                pages_last=max(FULL_PAGES_LAST_TOL, f * last),
                pages_layer0=PAGES_LAYER0_TOL, noise_floor=w)


def check_mesh_world(name, job, par, ranks, single, keys, wall_s,
                     card) -> dict:
    """A world of phase 14 against the single device by the bounds
    :func:`floor_bounds` sets from its noise floor (a mixture of experts:
    against the single device with the rounding of the world's
    row-parallel sums, :func:`mesh_rounding`, that run's reading against the
    plain single device and the world's reported beside), its tokens
    across ranks, its launches of ``keys`` on every rank; Mixtral: ``E /
    tp`` experts a rank; trees: drafts and accepted tokens on every rank,
    the tokens the single device's up to a near tie
    (:func:`clear_agreement`, the threshold twice the world's largest
    logits difference); the guided request alike, on the pipelined step
    with every rank's grammar pool.  Logs it."""
    import types

    depth = job.get("layers") or MODELS[job["model"]][1]["num_hidden_layers"]
    bounds = floor_bounds(single["noise"], depth)
    failed = []
    r0 = ranks[0]
    if any(r["tokens"] != r0["tokens"] for r in ranks):
        failed.append("ranks returned different tokens")
    diffs = []
    for r_i, r in enumerate(ranks):
        for key, c in r["checks"].items():
            if key.startswith("also/"):
                continue
            if "logits" in key:
                diffs.append(c["max_abs_diff"])
                if not (c["finite"] and c["max_abs_diff"]
                        <= bounds["logits_rel"] * c["max_abs_logit"]
                        and c["cosine"] >= bounds["cosine"]):
                    failed.append(f"rank {r_i} {key}: {c}")
            elif not (c[0]["rel_diff"] <= bounds["pages_layer0"]
                      and c[1]["rel_diff"] <= bounds["pages_last"]):
                failed.append(f"rank {r_i} {key}: {c}")
        missing = [k for k in keys if not r["launches"][k] > 0]
        if missing:
            failed.append(f"rank {r_i}: no launches of {missing}")
    if par.get("enable_shift_parallel") and not (
            r0["mode_steps"].get("sp", 0) > 0
            and r0["mode_steps"].get("shift", 0) > 0):
        failed.append(f"modes {r0['mode_steps']}")
    threshold = 2 * max(diffs)
    res = dict(
        world=name, model=job["model"], layers=depth, parallel=par,
        spec=job.get("spec"), ranks=len(ranks), wall_s=wall_s,
        bounds={k: v for k, v in bounds.items() if k != "noise_floor"},
        noise_floor=bounds["noise_floor"],
        worst=worst_of([r["checks"] for r in ranks], depth),
        single_agreement=token_agreement(
            [types.SimpleNamespace(token_ids=t) for t in r0["tokens"]],
            single["tokens"]),
        mode_steps=r0["mode_steps"], step_ms=r0["step_ms"],
        single_step_ms=single["step_ms"],
        generate_s=[r["generate_s"] for r in ranks],
        init_s=[r["init_s"] for r in ranks],
        checks_s=[r["checks_s"] for r in ranks],
        peak_gib=[r["peak_gib"] for r in ranks], kv_shape=r0["kv_shape"],
        launches=[{k: r["launches"][k] for k in keys} for r in ranks],
        all_launches=[{k: v for k, v in r["launches"].items() if v}
                      for r in ranks],
        drafts=[r["drafts"] for r in ranks],
        accepted=[r["accepted"] for r in ranks],
        width_stats=r0["width_stats"],
        timing=f"gloo, host-staged, one card: {card}")
    if "rounding" in single:
        # The witnesses: the single device with the rounding of the
        # world's row-parallel sums against the plain single device,
        # beside the world against both.
        res["reference"] = ("the single device with the rounding of the "
                            "world's row-parallel sums")
        res["rounding_vs_single"] = {
            parts: worst_of([c], depth)
            for parts, c in single["rounding"].items()}
        res["world_vs_single"] = worst_of(
            [{k[5:]: c for k, c in r["checks"].items()
              if k.startswith("also/")} for r in ranks], depth)
    if r0["experts_held"] is not None:
        res["experts_held"] = [r["experts_held"] for r in ranks]
        e = MODELS[job["model"]][1]["num_local_experts"]
        if any(h != e // par["tensor_parallel_size"]
               for h in res["experts_held"]):
            failed.append(f"experts held {res['experts_held']}")
    if job.get("tree"):
        if not all(r["drafts"] > 0 and r["accepted"] > 0 for r in ranks):
            failed.append("a rank verified no drafts or accepted none")
        res["tree_agreement"] = clear_agreement(
            r0["tokens"], single["tokens"], single["logprobs"], threshold)
        if not res["tree_agreement"]["ok"]:
            failed.append(f"tree tokens {res['tree_agreement']}")
    if job.get("guided"):
        g = [r["guided"] for r in ranks]
        res["guided"] = dict(
            text=g[0]["text"], single_text=single["guided"]["text"],
            pools=[x["pool"] for x in g],
            pipelined_steps=[x["pipelined_steps"] for x in g],
            seconds=[x["seconds"] for x in g],
            agreement=clear_agreement(
                [g[0]["tokens"]], [single["guided"]["tokens"]],
                [single["guided"]["logprobs"]], threshold))
        if any(x["tokens"] != g[0]["tokens"] for x in g):
            failed.append("guided: ranks returned different tokens")
        if not all(x["pool"] and x["pipelined_steps"] > 0 for x in g):
            failed.append(f"guided: pools / pipelined steps {res['guided']}")
        if not res["guided"]["agreement"]["ok"]:
            failed.append(f"guided tokens {res['guided']['agreement']}")
    res.update(failed=failed, ok=not failed)
    log("  mesh_models " + json.dumps(res))
    return res


# Phase 14's worlds: (name, job, mesh, kernels each rank must launch).
_MESH_KERNELS = ("ragged_paged_attention_kernel",
                 "grouped_decode_attention_kernel", "fp8_matmul_kernel")
SWIFT_JOB = dict(model="llama-3.1-swiftkv-8b", new=PARALLEL_NEW_TOKENS)
MOE_JOB = dict(model="mixtral-8x7b", routes=True, new=PARALLEL_NEW_TOKENS)
MESH_MODEL_WORLDS = (
    ("(a) swiftkv tp2, (d) guided", dict(SWIFT_JOB, guided=True), MESH_TP2,
     _MESH_KERNELS),
    ("(a) swiftkv sp2 x tp2 shift, suffix fused",
     dict(SWIFT_JOB, spec=dict(method="suffix", **SUFFIX_KNOBS)),
     MESH_SHIFT, _MESH_KERNELS),
    ("(b) mixtral tp2", MOE_JOB, MESH_TP2,
     _MESH_KERNELS + ("grouped_matmul_kernel",)),
    (f"(b) mixtral {MESH_MOE_SHIFT_LAYERS} layers sp2 x tp2 shift",
     dict(MOE_JOB, layers=MESH_MOE_SHIFT_LAYERS), MESH_SHIFT,
     _MESH_KERNELS + ("grouped_matmul_kernel",)),
    ("(c) llama trees sp2 x tp2 shift",
     dict(model="llama-3.1-8b", tree=True, new=PARALLEL_NEW_TOKENS,
          spec=dict(method="suffix", use_tree_spec=True,
                    enable_fused_decode=False, **SUFFIX_KNOBS)),
     MESH_SHIFT, ("ragged_paged_attention_kernel",
                  "ragged_paged_attention_kernel (tree mask)",
                  "fp8_matmul_kernel")),
)


def phase_mesh_models(rng, device="cuda:0", card=None, world=None) -> dict:
    """Phase 14 (see the module docstring): each world of
    :data:`MESH_MODEL_WORLDS` after the single device's run on the same
    weights and prompts (one run per model and depth, shared by the
    worlds that follow it; a suffix world seeds its cache from it), the
    ranks those of one four-rank world over gloo (``world``; a new one by
    default)."""
    card = card or smi()

    def prompts_of(model, n):
        vocab = MODELS[model][1]["vocab_size"]
        return [[int(x) for x in rng.integers(0, vocab, int(k))]
                for k in rng.integers(128, 1025, n)]

    prompts = {"llama-3.1-swiftkv-8b": prompts_of("llama-3.1-swiftkv-8b",
                                                  PARALLEL_PROMPTS),
               "mixtral-8x7b": prompts_of("mixtral-8x7b", MESH_MOE_PROMPTS),
               "llama-3.1-8b": prompts_of("llama-3.1-8b",
                                          MESH_TREE_PROMPTS)}
    out, singles = {}, {}
    with tempfile.TemporaryDirectory() as tmp, mesh_world(world) as world:
        for name, job, par, keys in MESH_MODEL_WORLDS:
            key = (job["model"], job.get("layers"))
            ref = Path(tmp) / f"{job['model']}-{job.get('layers')}"
            ps = prompts[job["model"]]
            if key not in singles:
                # A suffix world's single run is its model's plain run;
                # a tree world's runs trees itself.
                free_cuda_memory()
                ref.mkdir()
                t0 = time.perf_counter()
                single = mesh_model_run(
                    dict(job, world=par, spec=job.get("spec")
                         if job.get("tree") else None),
                    None, ps, str(ref), device)
                single["wall_s"] = time.perf_counter() - t0
                singles[key] = single
                free_cuda_memory()
                log(f"  mesh_models single {job['model']} "
                    f"({job.get('layers') or 'full depth'}): " + json.dumps(
                        {k: single[k] for k in (
                            "init_s", "checks_s", "wall_s", "generate_s",
                            "step_ms",
                            "peak_gib", "drafts", "accepted")}))
            single = singles[key]
            seed = single.get("seed_tokens") or (
                single["tokens"] if job.get("spec") else None)
            n = (par.get("tensor_parallel_size", 1)
                 * par.get("ulysses_sequence_parallel_size", 1))
            members = list(range(n)) if n < 4 else None
            t0 = time.perf_counter()
            ranks = world.run(mesh_model_run, job, par, ps, str(ref), device,
                              members=members, seed_tokens=seed,
                              ranks=range(n))
            out[name] = check_mesh_world(name, job, par, ranks, single, keys,
                                         time.perf_counter() - t0, card)
    if any(not w["ok"] for w in out.values()):
        raise AssertionError("phase 14: a world failed its checks: "
                             + json.dumps({k: w["failed"]
                                           for k, w in out.items()}))
    return out


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
    from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
    from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp
    from arcticinference_tpu_torch.ops.cuda import int4_matmul as im
    from arcticinference_tpu_torch.ops.cuda import ragged_attention as ra
    from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    # Each phase's seconds on the wall, printed before the kernels line.
    phase_s: dict = {}
    marks = [("device", time.perf_counter())]

    def mark(name: str) -> None:
        prev, t = marks[-1]
        now = time.perf_counter()
        phase_s[prev] = phase_s.get(prev, 0.0) + now - t
        marks.append((name, now))

    # Phases 12-14 run their meshes on one world of 4 ranks, started
    # now, beside the build (its ranks touch no card until phase 12), and
    # stopped at the end.
    mesh: dict = {}
    starter = None
    if any(p in phases for p in ("parallel", "serve_mesh", "mesh_models")):
        def start_world():
            from arcticinference_tpu_torch.parallel.world import World

            t = time.perf_counter()
            mesh["world"] = World(4, backend="gloo", timeout_s=600,
                                  threads=PARALLEL_THREADS)
            mesh["start_s"] = time.perf_counter() - t

        starter = threading.Thread(target=start_world, daemon=True)
        starter.start()

    def world4():
        if "logged" not in mesh:
            starter.join()
            if "world" not in mesh:
                raise RuntimeError("the world of phases 12-14 did not "
                                   "start")
            log(f"[mesh] one world of 4 ranks (gloo, cuda:0) for phases "
                f"12-14, started beside the earlier phases in "
                f"{mesh['start_s']:.1f} s")
            mesh["logged"] = True
        return mesh["world"]

    card = smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    sources = (ra.SOURCE, fm.SOURCE, im.SOURCE, hp.SOURCE, sm.SOURCE,
               gm.SOURCE)
    mark("build")
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
    read_sass([lib for src, lib in zip(sources, libs)
               if src in (ra.SOURCE, fm.SOURCE, im.SOURCE, sm.SOURCE,
                          gm.SOURCE)])
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
    # The grouped MoE matmul runs wgmma: its 20 instances (4 weight
    # formats x 5 plans) must hold HGMMA and no HMMA.
    grouped_sass = grouped_matmul_sass(libs[sources.index(gm.SOURCE)])
    log(f"[build] grouped matmul SASS per instance: "
        f"{json.dumps(grouped_sass)}")
    if len(grouped_sass) != 20 or min(
            c["HGMMA"] for c in grouped_sass.values()) == 0 or max(
            c["HMMA"] for c in grouped_sass.values()) > 0:
        raise AssertionError(f"grouped matmul instances missing, without "
                             f"HGMMA or with HMMA: {grouped_sass}")

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
        "grouped_matmul_kernel": dict(
            name="grouped_matmul_kernel", route="cuda",
            source=csrc + gm.SOURCE,
            replaces="arcticinference_tpu/models/mixtral.py:234 "
                     "(jax.lax.ragged_dot, an XLA op: no pallas_call)",
            sass=grouped_sass),
    }
    shard_cases = None
    mark("kernels")
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
        log("[kernels] kernels 1, 2 and 5 at a mesh rank's shapes "
            "(Llama-3.1-8B over tp 2 and sp 2 x tp 2)")
        shard_cases = phase_shard_kernels(rng, args.seed)
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
    mark("forward")
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
    mark("generate")
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
    mark("bench")
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
    mark("pipeline")
    if "pipeline" in phases:
        log("[pipeline] LLM.generate, Llama-3.1-8B shape, 32 layers, bf16 "
            "and fp8: the pipelined step against the synchronous one; "
            "guided decoding (device pool and host masks), fp8")
        pipe_runs = phase_pipeline(rng)
        # This slice's path: the pipelined runs' launches, each run's own
        # (the counts set to 0 before each run).
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            kernels[key]["launches_pipeline"] = {
                f"{name} {run}": dict(launches=r["launches"][key],
                                      dispatches=r["dispatches"])
                for name in ("bf16", "fp8")
                for run, r in pipe_runs[name]["runs"].items()
                if run.endswith("pipelined")}
            r = pipe_runs["guided"]["pipelined"]
            kernels[key]["launches_pipeline"]["fp8 guided pipelined"] = \
                dict(launches=r["launches"][key],
                     dispatches=r["dispatches"])
    mark("serve")
    if "serve" in phases:
        log("[serve] the OpenAI server (subprocess), the offline engine and "
            "an in-process server over the synthetic tokenizer; "
            "Llama-3.1-8B, 32 layers, fp8, serve_bench's baseline config")
        served = phase_serve(rng)
        # This slice's path: part (c)'s launches (the counts set to 0 just
        # before it).
        for key in SERVE_TRACE_KERNELS:
            kernels[key]["launches_serve"] = served["launches"][key]
    mark("embed")
    if "embed" in phases:
        log("[embed] LLM.encode on BERT (arctic-embed-m-v1.5 and -l widths) "
            "and on Llama-3.1-8B fp8; the embedding fleet (1 and 2 "
            "BERT-base replicas)")
        embedded = phase_embed(rng)
        # This slice's path: the causal encode's launches (the counts set
        # to 0 just before it).
        for key in ("ragged_paged_attention_kernel", "fp8_matmul_kernel"):
            kernels[key]["launches_embed"] = embedded["launches"][key]
    mark("quality")
    if "quality" in phases:
        log("[quality] the tiny trained checkpoint (2 layers, hidden 128, 2 "
            "q heads of 64 over 1): trained here, the quality gate, the "
            "accuracy matrix, the drafter transfer; kernels 1, 2, 5 and 6 "
            "at its shapes")
        quality = phase_quality(rng, args.seed)
        ragged_q, grouped_q, invariance_q, fp8_q, int4_q = quality["cases"]
        runs = dict(quality["gate"]["launches"])
        runs.update({f"matrix {k}": v
                     for k, v in quality["matrix"]["launches"].items()})
        runs["transfer"] = quality["transfer"]["launches"]
        for key, cases, rep_name in (
                ("ragged_paged_attention_kernel", ragged_q,
                 "tiny score 2x256 bf16 qb=32"),
                ("grouped_decode_attention_kernel", grouped_q,
                 "tiny decode B=16 qlen=1 bf16"),
                ("fp8_matmul_kernel", fp8_q,
                 "fp8 tiny w_gateup [128,512] M=16"),
                ("int4_matmul_kernel", int4_q,
                 "int4 tiny w_gateup [128,512] M=16")):
            entry = kernels[key]
            rep = next(c for c in cases if c["case"] == rep_name)
            # Without the kernels phase, this phase's case is the row's.
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms"):
                entry.setdefault(k, rep[k])
            entry["max_abs_err"] = max(
                [entry.get("max_abs_err", 0.0)]
                + [c["max_abs_err"] for c in cases])
            entry.setdefault("launches", sum(r[key] for r in runs.values()))
            entry["launches_quality"] = {run: n[key]
                                         for run, n in runs.items()}
            entry["cases_quality"] = [{k: c[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "rel_err", "host_us")
                if k in c} for c in cases]
        kernels["grouped_decode_attention_kernel"][
            "row_invariance_quality"] = invariance_q
    mark("moe")
    if "moe" in phases:
        log("[moe] Mixtral-8x7B: the grouped matmul at its expert shapes; "
            "LLM.generate in fp8 (32 layers) and bf16 "
            f"({MOE_BF16_LAYERS} layers)")
        moe_res = phase_moe(rng, args.seed)
        cases = moe_res["cases"]
        rep = next(c for c in cases
                   if c["case"] == "fp8 w_gate [8,4096,14336] R=128 uniform")
        entry = kernels["grouped_matmul_kernel"]
        entry.update(
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], library=rep["library"],
            case=rep["case"],
            tolerance=f"atol={ATOL} rtol={RTOL}, "
                      f"||out-plain||/||plain|| <= {REL_TOL}",
            # The main path's run: Mixtral-8x7B fp8, pipelined.
            launches=moe_res["fp8"]["pipelined"]["launches"][
                "grouped_matmul_kernel"],
            launches_per_dispatch=moe_res["fp8"]["launches_per_dispatch"],
            cases=[{k: c[k] for k in (
                "case", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err", "rel_err") if k in c}
                   for c in cases],
            cases_checked=len(cases), replay=moe_res["replays"])
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            kernels[key]["launches_moe"] = {
                f"{name} {run}": dict(
                    launches=moe_res[name][run]["launches"][key],
                    dispatches=moe_res[name][run]["dispatches"])
                for name in ("fp8", "bf16") for run in ("pipelined",
                                                        "sync")}
    mark("parallel")
    if "parallel" in phases:
        if shard_cases is None:
            log("[parallel] kernels 1, 2 and 5 at a mesh rank's shapes "
                "(Llama-3.1-8B over tp 2 and sp 2 x tp 2)")
            shard_cases = phase_shard_kernels(rng, args.seed)
        log(f"[parallel] LLM.generate, Llama-3.1-8B fp8, {PARALLEL_LAYERS} "
            "layers, on one device, then on worlds of ranks sharing cuda:0 "
            "over gloo: " + ", ".join(n for n, _ in PARALLEL_WORLDS))
        t0 = time.perf_counter()
        worlds = phase_parallel(rng, world=world4())
        log(f"[parallel] {time.perf_counter() - t0:.1f} s")
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            entry = kernels[key]
            entry["launches_parallel"] = {
                name: [r[key] for r in worlds[name]["launches"]]
                for name, _ in PARALLEL_WORLDS}
            entry.setdefault("launches", worlds[PARALLEL_WORLDS[-1][0]][
                "launches"][0][key])
    mark("serve_mesh")
    if "serve_mesh" in phases:
        log(f"[serve_mesh] the OpenAI server on a mesh: Llama-3.1-8B fp8, "
            f"{PARALLEL_LAYERS} layers, ranks sharing cuda:0 over gloo: "
            + ", ".join(n for n, _, _ in SERVE_MESH_WORLDS))
        t0 = time.perf_counter()
        served_worlds = phase_serve_mesh(rng, world=world4())
        log(f"[serve_mesh] {time.perf_counter() - t0:.1f} s")
        for key in ("ragged_paged_attention_kernel",
                    "grouped_decode_attention_kernel", "fp8_matmul_kernel"):
            entry = kernels[key]
            entry["launches_serve_mesh"] = {
                name: [r[key] for r in served_worlds[name]["launches"]]
                for name, _, _ in SERVE_MESH_WORLDS}
            entry.setdefault("launches", served_worlds[
                SERVE_MESH_WORLDS[0][0]]["launches"][0][key])
    mark("mesh_models")
    if "mesh_models" in phases:
        t0 = time.perf_counter()
        log("[mesh_models] row R, kernel 5 and kernel 1t at a mesh rank's "
            "shapes (Mixtral-8x7B's expert stacks, SwiftKV-8B's fused K / V "
            "piece, a tree verify step's heads)")
        mesh_cases = phase_mesh_model_kernels(rng, args.seed)
        log(f"[mesh_models] kernel cases {time.perf_counter() - t0:.1f} s")
        log("[mesh_models] LLM.generate on meshes of ranks sharing cuda:0 "
            "over gloo, each after the single device: "
            + ", ".join(n for n, _, _, _ in MESH_MODEL_WORLDS))
        # Its own seed: the same prompts whichever phases ran before.
        mesh_worlds = phase_mesh_models(np.random.default_rng(args.seed
                                                              + 14),
                                        world=world4())
        keys = sorted({k for _, _, _, ks in MESH_MODEL_WORLDS for k in ks})
        for key in keys:
            entry = kernels[key]
            entry["launches_mesh_models"] = {
                name: [r[key] for r in mesh_worlds[name]["all_launches"]
                       if key in r] or [0]
                for name, _, _, ks in MESH_MODEL_WORLDS if key in ks}
            entry.setdefault("launches", max(
                max(v) for v in entry["launches_mesh_models"].values()))
        for key, cases, rep_name in (
                ("grouped_matmul_kernel", mesh_cases[0],
                 "fp8 tp2 w_gate [4,4096,14336] R=128 uniform"),
                ("fp8_matmul_kernel", mesh_cases[1],
                 "fp8 tp2 wkv_swift [4096,16384] M=16"),
                ("ragged_paged_attention_kernel (tree mask)", mesh_cases[2],
                 f"rank Hq=8 Hkv=2 tree verify 16x(1+{TREE_NODES})@ctx~1024 "
                 "bf16 qb=32")):
            entry = kernels[key]
            rep = next(c for c in cases if c["case"] == rep_name)
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms"):
                entry.setdefault(k, rep[k])
            entry["max_abs_err"] = max(
                [entry.get("max_abs_err", 0.0)]
                + [c["max_abs_err"] for c in cases])
            entry["cases_mesh_models"] = [{k: c[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "rel_err") if k in c}
                for c in cases]
        log(f"[mesh_models] {time.perf_counter() - t0:.1f} s")
    if shard_cases is not None:
        # The cases at a mesh rank's shapes beside every earlier one; a
        # run without the kernels phase reports them as the row's.
        for key, cases, rep_name in (
                ("ragged_paged_attention_kernel", shard_cases[0],
                 "rank Hq=8 Hkv=2 prefill 2048@ctx2048 bf16 qb=32"),
                ("grouped_decode_attention_kernel", shard_cases[1],
                 "rank Hq=8 Hkv=2 decode B=64 qlen=1 bf16"),
                ("fp8_matmul_kernel", shard_cases[2],
                 "fp8 tp2 w_gateup [4096,14336] M=16")):
            entry = kernels[key]
            rep = next(c for c in cases if c["case"] == rep_name)
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms"):
                entry.setdefault(k, rep[k])
            entry["max_abs_err"] = max(
                [entry.get("max_abs_err", 0.0)]
                + [c["max_abs_err"] for c in cases])
            entry["cases_parallel"] = [{k: c[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "rel_err", "host_us")
                if k in c} for c in cases]
    mark("profile")
    if "embed" in phases:
        log("[profile] one BERT-base batch (64 x 512) under torch.profiler")
        log("  profile bert " + json.dumps(dict(profile_bert(),
                                                card=smi())))
    if "generate" in phases:
        log("[profile] shorter bf16 and fp8 runs and the drafter chains "
            "under torch.profiler")
        phase_profile(rng)
    if starter is not None:
        starter.join()
        if "world" in mesh:
            mesh["world"].close()
    mark("end")
    log(json.dumps({"phase_seconds": {k: round(v, 1)
                                      for k, v in phase_s.items()
                                      if k in phases or v >= 0.05}}))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
