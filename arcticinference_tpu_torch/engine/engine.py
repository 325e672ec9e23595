"""LLMEngine: the step loop tying scheduler and runner together.

Counterpart of ``arcticinference_tpu/engine/engine.py``:

  schedule -> prepare inputs -> device step -> host verify
  -> commit tokens / stops -> update suffix cache -> propose next drafts

Without speculation the engine pipelines its steps, as the JAX engine
does by default (``SchedulerConfig.async_scheduling``): step N+1 is
dispatched before step N's tokens reach the host, a token the host has
not seen yet rides the device from one step's output vector into the
next step's input (``passthrough``), placeholders (:data:`PENDING_TOKEN`)
stand in for it on the host, and each step's tokens are copied back
behind an event and committed ``pipeline_depth`` steps later
(:meth:`LLMEngine._sync_oldest`), where stop conditions trim what was
produced past them.  Penalties, guided grammars that the device pool
cannot hold (non-DFA decoders, more grammars than slots, grammars larger
than a slot) and the ``hidden_capture`` hook take the synchronous step
(``LLMEngine._step_sync`` in the JAX package) instead.

Speculation runs the synchronous step and, for suffix speculation or a
drafter, the device-resident fused decode loop
(``engine/fused_decode.py``; ``SpeculativeConfig.enable_fused_decode``,
the default): while it is active, decode steps verify and draft on the
device, and prefills and non-fusable requests ride interleaved
synchronous steps.  Speculation is suffix decoding
(``SpeculativeConfig(method="suffix")``), with linear drafts or token
trees (``use_tree_spec``, on the synchronous step), or the Arctic MLP /
LSTM draft models (``method="arctic"``, ``"mlp_speculator"``,
``"lstm_speculator"``; ``spec/proposer.py``), alone or with suffix
decoding (``enable_suffix_decoding``): the drafter chains on the hidden
row of each request's last accepted token, after a synchronous step or
inside the fused loop's step; a ``distilled_tied`` drafter
(``spec/distill.py``) uses the target's own embedding and LM head.  The
``hidden_capture`` hook hands committed tokens and their hidden rows to
distillation.  Requests with repetition / presence / frequency penalties
ride the synchronous step (also beside the fused loop, which does not
mirror them), as do requests with ``logprobs`` beside the fused loop;
each committed token gets a ``{token: logprob}`` dict of the step's
ranked candidates.  On a mesh (``ParallelConfig``, ``parallel/``) each
rank runs this same loop in lockstep, the pipelined step, the
synchronous step, the fused loop and the drafters alike; on a served
mesh the leader alone runs it and the followers replay its device steps
(``parallel/multihost.py``).  A SwiftKV model (``llama_swiftkv``) composes with
suffix decoding, the drafters (their hidden rows are its sample rows)
and hidden capture, on the synchronous step and the fused loop; token
trees with it raise, as in the JAX package.

Guided decoding (``SamplingParams.guided``, a decoder from
``serving/structured.py``): a DFA decoder's allowed-token mask is
applied to the logits on the device, from the host on the synchronous
step and from the device grammar pool on the pipelined one (the
automaton state advancing on the device; the host replays each committed
token when it drains the step); other decoders pick the first allowed
of the step's ranked candidates on the synchronous step.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.fused_decode import FusedDecodeLoop
from arcticinference_tpu_torch.engine.request import (Request, RequestStatus,
                                                      SamplingParams)
from arcticinference_tpu_torch.engine.runner import ModelRunner, check_mesh
from arcticinference_tpu_torch.engine.scheduler import (ScheduledRequest,
                                                        Scheduler,
                                                        SchedulerOutput)
from arcticinference_tpu_torch.models.loader import load_model, resolve_model
from arcticinference_tpu_torch.ops.cuda.ragged_attention import MAX_TREE_NODES
from arcticinference_tpu_torch.parallel.mesh import build_mesh
from arcticinference_tpu_torch.spec.proposer import ArcticProposer
from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache
from arcticinference_tpu_torch.stats import (EngineStats, SpecDecodingStats,
                                             StepTimeStats)
from arcticinference_tpu_torch.utils import resolve_device

logger = logging.getLogger("arcticinference_tpu_torch")

# Host-side placeholder for a token whose value is still on the device
# (the pipelined step); always patched before user-visible output.
PENDING_TOKEN = -7


class _InflightStep:
    """A dispatched step whose tokens have not been committed yet (the
    pipelined step): its output vector on the device (the next step's
    passthrough source), the vector's host copy (pinned on the card) and
    the event recorded after the copy (None on the CPU)."""

    __slots__ = ("step_inputs", "tokens_dev", "tokens_host", "event",
                 "commits", "gstate_base")

    def __init__(self, step_inputs, tokens_dev):
        self.step_inputs = step_inputs
        self.tokens_dev = tokens_dev
        if tokens_dev.is_cuda:
            self.tokens_host = torch.empty(tokens_dev.shape,
                                           dtype=tokens_dev.dtype,
                                           pin_memory=True)
            self.tokens_host.copy_(tokens_dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.tokens_host, self.event = tokens_dev, None
        # (request, output position, absolute row in the vector, sample
        # row of its logprobs or -1)
        self.commits: list = []
        # Offset of the grammar-state segment in the vector (0: none).
        self.gstate_base = 0

    def host_tokens(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.tokens_host.numpy()


class LLMEngine:

    def __init__(self, config: EngineConfig,
                 device: Union[str, torch.device, None] = None,
                 group=None):
        """``device``: ``cuda:<LOCAL_RANK>`` by default.  A parallel
        config of world size > 1 runs this engine as one rank of a mesh
        over ``group`` (default: the default process group, which the
        caller initializes); every rank builds the same engine and feeds
        it the same requests, in the same order."""
        spec = config.speculative
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None
        module, arch = resolve_model(config.model)
        if spec is not None and spec.use_tree_spec and \
                getattr(module, "NEEDS_SWIFT_SCHEDULE", False):
            raise NotImplementedError(
                "use_tree_spec does not compose with SwiftKV (the "
                "early-exit halves re-run draft rows with different masks)")
        if config.parallel.world_size > 1:
            check_mesh(config, module, arch)
            self.mesh = build_mesh(config.parallel, group)
        module, arch, params = load_model(config.model, self.device,
                                          mesh=self.mesh)
        self.arch = arch
        self.eos_token_id: Optional[int] = arch.eos_token_id
        # Detokenizer for string stop sequences (set by LLM).
        self.tokenizer = None
        self.runner = ModelRunner(config, module, arch, params, self.device,
                                  mesh=self.mesh)
        # In-engine dp: one block space a dp group.
        self.scheduler = Scheduler(config.scheduler, config.cache,
                                   self.runner.num_blocks_per_shard,
                                   num_shards=self.runner.dp)
        self.engine_stats = EngineStats()
        self.step_times = StepTimeStats()
        self.spec_stats = SpecDecodingStats()
        self._last_log = time.time()
        # The running torch.profiler trace (start_profile) and where
        # stop_profile writes its trace.
        self._profiler = None
        self._trace_dir: Optional[str] = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.model.seed)
        # Distillation hook (spec/distill.py HiddenCapture): called with
        # (hidden rows, [(req_id, row, emitted token)]) by the synchronous
        # step and at the fused loop's drain.
        self.hidden_capture = None
        # Pipelined steps need no host-side drafts: without speculation
        # only, as in the JAX engine.
        self._pipeline = config.scheduler.async_scheduling and spec is None
        self._pipeline_depth = config.scheduler.pipeline_depth
        self._inflight: list[_InflightStep] = []
        self._pending_ref: dict = {}
        # Device grammar pool: id(grammar index) -> (slot, index); slots
        # are shared by requests with the same compiled grammar and
        # reclaimed lazily once their requests finish.
        self._guided_slots: dict[int, tuple] = {}

        self.spec_config = spec
        self._suffix_cache: Optional[SuffixCache] = None
        self._prompt_tree_pool: Optional[ThreadPoolExecutor] = None
        self._prompt_tree_futs: dict = {}
        self._drafter: Optional[ArcticProposer] = None
        self._fused: Optional[FusedDecodeLoop] = None
        if spec is not None and spec.enable_suffix_decoding:
            self._suffix_cache = SuffixCache(spec.suffix_cache_max_depth)
            # Prompt trees are built here while the prompt prefills
            # (submitted at admission, installed at the first commit).
            self._prompt_tree_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="suffix-prompt")
            # A deep waiting queue must not hold finished trees in
            # futures: past the bound a request builds its tree
            # synchronously at its first commit.
            self._prompt_tree_bound = 2 * config.scheduler.max_num_seqs
        if spec is not None and spec.method in ("arctic", "mlp_speculator",
                                                "lstm_speculator"):
            # On a mesh every rank holds the drafter whole; a tied one
            # reads the target's tp-cut LM head and gathers its logits.
            self._drafter = ArcticProposer(
                spec, arch, self.device, target_params=self.runner.params,
                gather_logits=(self.runner.gather_logits
                               if self.runner._gather_logits else None))
        if spec is not None and spec.enable_fused_decode:
            fused = FusedDecodeLoop(self)
            # Installed only where it can engage; otherwise the sync path
            # keeps full drafting duties.
            if fused.eligible():
                self._fused = fused
            else:
                logger.info("enable_fused_decode=True without suffix "
                            "decoding or a drafter: nothing for the fused "
                            "loop to draft; running the synchronous step")

    # ------------------------------------------------------------------ #
    # Request management
    # ------------------------------------------------------------------ #

    def add_request(self, req_id: str, prompt_token_ids: list[int],
                    sampling: Optional[SamplingParams] = None) -> Request:
        if not prompt_token_ids:
            raise ValueError("prompt must not be empty")
        sampling = sampling or SamplingParams()
        if sampling.stop and self.tokenizer is None:
            raise ValueError(
                "string stop sequences need a tokenizer (none is "
                "configured for this engine)")
        if len(prompt_token_ids) >= self.config.model.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} >= max_model_len "
                f"{self.config.model.max_model_len}")
        req = Request(req_id=req_id,
                      prompt_token_ids=list(prompt_token_ids),
                      sampling=sampling, arrival_time=time.time())
        if self._prompt_tree_pool is not None and \
                req_id not in self._prompt_tree_futs and \
                len(self._prompt_tree_futs) < self._prompt_tree_bound and \
                not self._suffix_cache.has_cached_prompt(req_id):
            self._prompt_tree_futs[req_id] = self._prompt_tree_pool.submit(
                self._suffix_cache.build_prompt_tree, req.prompt_token_ids)
        self.scheduler.add_request(req)
        return req

    def abort_request(self, req_id: str) -> Optional[Request]:
        # The fused loop's steps in flight write into the request's
        # blocks: settle them before the scheduler releases anything.
        if self._fused is not None and self._fused.active:
            self._fused.exit()
        req = self.scheduler.abort_request(req_id)
        if req is not None:
            self._evict_spec_state(req)
            # Steps in flight skip it when they drain; its placeholders
            # never become output.
            self._pending_ref.pop(req_id, None)
            out = req.output_token_ids
            if PENDING_TOKEN in out:
                del out[out.index(PENDING_TOKEN):]
        return req

    @property
    def has_unfinished(self) -> bool:
        return self.scheduler.num_unfinished > 0 or bool(self._inflight)

    def close(self) -> None:
        """Release the prompt-tree worker pool and its pending futures
        (idempotent): its threads are not daemons."""
        pool = self._prompt_tree_pool
        if pool is not None:
            for fut in self._prompt_tree_futs.values():
                fut.cancel()
            self._prompt_tree_futs.clear()
            pool.shutdown(wait=False, cancel_futures=True)
            self._prompt_tree_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    # Profiling
    # ------------------------------------------------------------------ #

    def start_profile(self, trace_dir: str) -> None:
        """Begin a ``torch.profiler`` trace (host ops of this thread and,
        on the card, every kernel of the process); :meth:`stop_profile`
        writes it to ``trace_dir`` as a Chrome trace.  vLLM's
        /start_profile.  Start and stop on the same thread."""
        if self._profiler is not None:
            raise RuntimeError("a profiler trace is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._profiler, self._trace_dir = prof, trace_dir

    def stop_profile(self) -> Optional[str]:
        """End the trace begun by :meth:`start_profile` and write it;
        returns the trace's path (None when none was running)."""
        import os

        prof = self._profiler
        if prof is None:
            return None
        self._profiler = None
        prof.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path

    # ------------------------------------------------------------------ #
    # Scoring
    # ------------------------------------------------------------------ #

    def score(self, prompt_token_ids) -> list[np.ndarray]:
        """Teacher-forced per-token logprobs (OpenAI ``echo`` / lm_eval
        ``loglikelihood``; the JAX package's ``ScoringMixin``): for each
        sequence, the logprob of token i+1 given tokens [0..i], a float64
        array of length len(seq) - 1.
        Sequences are batched up to ``max_num_batched_tokens`` and
        ``max_num_seqs``; one longer than the token budget raises."""
        sched = self.config.scheduler
        budget = sched.max_num_batched_tokens
        out: list[np.ndarray] = []
        batch: list[list[int]] = []
        total = 0
        for ids in prompt_token_ids:
            if len(ids) > budget:
                raise ValueError(
                    f"sequence of {len(ids)} tokens exceeds "
                    f"max_num_batched_tokens={budget}")
            if total + len(ids) > budget or len(batch) >= sched.max_num_seqs:
                out.extend(self._score_batch(batch))
                batch, total = [], 0
            batch.append(list(ids))
            total += len(ids)
        if batch:
            out.extend(self._score_batch(batch))
        return out

    def _borrowed_prefill(self, batch: list[list[int]], run):
        """Lay ``batch`` out as one prefill step in cache blocks borrowed
        from the block manager, call ``run`` on its step inputs and free
        the blocks, also when ``run`` or the borrowing raises (nothing
        enters the scheduler); returns what ``run`` returns.  With dp the
        requests are dp group 0's, whose block space lends the blocks
        (so the step's rows lie where one device's would)."""
        bm = self.scheduler.block_manager
        reqs = []
        sched = SchedulerOutput()
        try:
            for i, ids in enumerate(batch):
                req = Request(req_id=f"prefill-{i}", prompt_token_ids=ids,
                              sampling=SamplingParams(max_tokens=1),
                              dp_shard=0)
                reqs.append(req)
                bm.grow_to(req.block_ids, len(ids))
                sched.scheduled.append(ScheduledRequest(req, len(ids), []))
            return run(self.runner.prepare_inputs(sched))
        finally:
            for req in reqs:
                bm.free(req.block_ids)

    def _score_batch(self, batch: list[list[int]]) -> list[np.ndarray]:
        """One prefill-shaped forward over ``batch``
        (:meth:`_borrowed_prefill`)."""
        spans = []
        t = 0
        for ids in batch:
            spans.append((t, len(ids) - 1))
            t += len(ids)

        def run(si):
            targets = np.full(si.t_pad, -1, np.int32)
            for (a, n), ids in zip(spans, batch):
                targets[a:a + n] = ids[1:]
            return self.runner.execute_score(si, targets)

        lp = self._borrowed_prefill(batch, run)
        return [np.asarray(lp[a:a + n], np.float64) for a, n in spans]

    def prompt_logits(self, ids) -> np.ndarray:
        """The LM head's logits at every position of one prefill of
        ``ids``, a host float32 array [len(ids), vocab] (the quality
        gate's KL).  Runs in borrowed blocks as :meth:`score`; ``ids``
        must fit ``max_num_batched_tokens``."""
        ids = [int(t) for t in ids]
        budget = self.config.scheduler.max_num_batched_tokens
        if len(ids) > budget:
            raise ValueError(f"prompt of {len(ids)} tokens exceeds "
                             f"max_num_batched_tokens={budget}")
        return self._borrowed_prefill(
            [ids], lambda si: self.runner.execute_logits(si, len(ids)))

    def encode(self, prompt_token_ids, pooling: str = "mean",
               normalize: bool = False) -> list[np.ndarray]:
        """Pooled embeddings of a causal LM (the JAX package's
        ``EmbeddingMixin`` for causal models): one prefill-shaped forward
        per batch of prompts, each request's rows pooled on the device
        (``mean`` or ``last``, :meth:`ModelRunner.pooled`), one float32
        array per prompt.  Prompts are batched up to
        ``max_num_batched_tokens`` and ``max_num_seqs``; one longer than
        the token budget raises.  The forward writes K/V into borrowed
        blocks of the live cache, so it must not run beside a step in
        flight: the offline ``LLM`` calls it between ``generate`` calls,
        a server under its engine lock."""
        sched = self.config.scheduler
        budget = sched.max_num_batched_tokens
        out: list[np.ndarray] = []
        batch: list[list[int]] = []
        total = 0
        for ids in prompt_token_ids:
            if len(ids) > budget:
                raise ValueError(
                    f"prompt of {len(ids)} tokens exceeds "
                    f"max_num_batched_tokens={budget}")
            if total + len(ids) > budget or len(batch) >= sched.max_num_seqs:
                out.extend(self._encode_batch(batch, pooling, normalize))
                batch, total = [], 0
            batch.append(list(ids))
            total += len(ids)
        if batch:
            out.extend(self._encode_batch(batch, pooling, normalize))
        return out

    def _encode_batch(self, batch: list[list[int]], pooling: str,
                      normalize: bool) -> list[np.ndarray]:
        pooled = self._borrowed_prefill(
            batch, lambda si: self.runner.execute_encode(
                si, pooling=pooling, normalize=normalize))
        return [pooled[i] for i in range(len(batch))]

    # ------------------------------------------------------------------ #
    # Step loop
    # ------------------------------------------------------------------ #

    @property
    def width_stats(self) -> Optional[dict]:
        """The fused loop's dispatched steps by program width and its
        entries; None without the loop."""
        return None if self._fused is None else dict(self._fused.width_stats)

    def step(self) -> list[Request]:
        """Run one engine iteration; returns requests finished this step."""
        t0 = time.perf_counter()
        kind, emitted, finished = self._step_inner()
        if kind is not None:
            self.step_times.observe(kind, time.perf_counter() - t0, emitted)
        return finished

    def _step_inner(self) -> tuple[Optional[str], int, list[Request]]:
        if self._pipeline and not self._needs_sync():
            return ("pipelined", *self._step_pipelined())
        flushed = self._flush_inflight()[1]
        # Device-resident fused decode while requests sit at their decode
        # frontier; prefills and admissions ride its interleaved sync
        # steps, or this iteration's sync step when it is not active.
        fused = self._fused
        if fused is not None:
            if not fused.active and fused.can_enter():
                fused.enter()
            if fused.active:
                before = fused.tokens_drained
                finished = fused.step()
                if fused.active or finished:
                    return "fused", fused.tokens_drained - before, finished
                # Exited with nothing to report (e.g. block pre-extension
                # failed before the first dispatch): the sync path makes
                # progress this iteration.
        kind, emitted, finished = self._step_sync()
        return kind, emitted, flushed + finished

    def _needs_sync(self) -> bool:
        """Whether some request (or the capture hook) forces the
        synchronous step.  Penalties need host-known token histories at
        dispatch time (a pipelined step would upload placeholders); the
        ``hidden_capture`` hook takes rows from synchronous steps only.
        Guided requests ride the pipeline when every grammar is
        DFA-compiled and the device pool holds them all (masks and
        state advance then run on the device); other decoders need the
        host's pick each step, and so does every guided request on a
        served mesh (no follower holds the pool).  Logprobs ride the
        pipeline (their ranked candidates are read when the step
        drains)."""
        if self.hidden_capture is not None:
            return True
        reqs = (*self.scheduler.running, *self.scheduler.waiting)
        if any(r.sampling.needs_penalties for r in reqs):
            return True
        indexes = set()
        for r in reqs:
            g = r.sampling.guided
            if g is None:
                continue
            if not self.runner.guided_device_ok:
                return True
            idx = getattr(g, "index", None)
            if idx is None or not self.runner.guided_fits_pool(idx):
                return True
            indexes.add(id(idx))
        return len(indexes) > self.runner.GUIDED_POOL_SLOTS

    def _guided_slot(self, decoder) -> int:
        """Pool slot of this decoder's grammar, its tables uploaded at
        first use; slots are keyed by compiled-grammar identity (the
        ``TokenDfaIndex`` cache makes same-pattern requests share one)."""
        key = id(decoder.index)
        entry = self._guided_slots.get(key)
        if entry is not None:
            return entry[0]
        if len(self._guided_slots) >= self.runner.GUIDED_POOL_SLOTS:
            live = {id(r.sampling.guided.index)
                    for r in (*self.scheduler.running,
                              *self.scheduler.waiting)
                    if getattr(r.sampling.guided, "index", None)
                    is not None}
            self._guided_slots = {k: v for k, v in
                                  self._guided_slots.items() if k in live}
        used = {slot for slot, _ in self._guided_slots.values()}
        slot = next(i for i in range(self.runner.GUIDED_POOL_SLOTS)
                    if i not in used)
        self.runner.upload_guided_tables(slot, decoder.index)
        # The strong reference keeps the index's id() from being reused
        # while the slot maps it.
        self._guided_slots[key] = (slot, decoder.index)
        return slot

    # ------------------------------------------------------------------ #
    # Pipelined step
    # ------------------------------------------------------------------ #

    def _step_pipelined(self) -> tuple[int, list[Request]]:
        """Dispatch this iteration's step with placeholders for its
        tokens, then commit the oldest steps in flight beyond
        ``pipeline_depth``; returns (tokens committed, finished
        requests)."""
        sched_out = self.scheduler.schedule()
        emitted, flushed = 0, []
        if sched_out.preempted:
            # A preempted request's placeholders must land before its
            # restart feeds its tokens again.
            emitted, flushed = self._flush_inflight()
            # The drain can finish requests of this schedule (a stop on
            # their last pending token): their entries are stale.
            sched_out.scheduled = [s for s in sched_out.scheduled
                                   if not s.request.status.is_finished]
        if not sched_out.scheduled:
            n, fin = self._sync_oldest()
            return emitted + n, flushed + fin
        self._maybe_observe(sched_out)

        # Passthrough: a request whose newest token is still on the
        # device reads it from the previous step's output vector.
        passthrough = {}
        prev = self._inflight[-1] if self._inflight else None
        for s in sched_out.scheduled:
            req = s.request
            if not req.output_token_ids or \
                    req.output_token_ids[-1] != PENDING_TOKEN:
                continue
            step_obj, row_abs = self._pending_ref[req.req_id]
            # Produced two or more steps back: drain the oldest steps
            # until the value lands or its step is the newest in flight.
            while step_obj is not prev and self._inflight and \
                    req.output_token_ids[-1] == PENDING_TOKEN and \
                    self._inflight[-1] is not step_obj:
                n, fin = self._sync_oldest()
                emitted += n
                flushed.extend(fin)
            if req.output_token_ids[-1] == PENDING_TOKEN:
                passthrough[req.req_id] = row_abs
        # That drain can finish scheduled requests (stop strings, grammar
        # completion): drop their entries.
        sched_out.scheduled = [s for s in sched_out.scheduled
                               if not s.request.status.is_finished]
        if not sched_out.scheduled:
            return emitted, flushed

        prev = self._inflight[-1] if self._inflight else None
        # Device-resident guided state: from the previous step's vector
        # when this request's state is in flight there, else the host
        # decoder's committed state.
        guided_dev = {}
        for s in sched_out.scheduled:
            g = s.request.sampling.guided
            if g is None:
                continue
            src = -1
            if prev is not None and prev.step_inputs.guided_index and \
                    s.request.req_id in prev.step_inputs.guided_index:
                src = (prev.gstate_base
                       + prev.step_inputs.guided_index[s.request.req_id])
            guided_dev[s.request.req_id] = (self._guided_slot(g), src,
                                            g.state)
        step_inputs = self.runner.prepare_inputs(sched_out, passthrough,
                                                 guided_dev or None)
        need_topk = any(s.request.sampling.logprobs
                        for s in sched_out.scheduled)
        tokens_dev, _ = self.runner.dispatch(
            step_inputs, self._generator, need_topk,
            prev_tokens=None if prev is None else prev.tokens_dev)
        inflight = _InflightStep(step_inputs, tokens_dev)
        s_pad = step_inputs.s_pad
        if step_inputs.gstate_count:
            inflight.gstate_base = 2 * s_pad + (
                2 * s_pad * self.runner.GUIDED_TOPK if need_topk else 0)
        # Optimistic commit: a placeholder for every produced token.
        for r, s in enumerate(sched_out.scheduled):
            req = s.request
            if req.num_computed_tokens + s.num_new_tokens < req.num_tokens:
                self.scheduler.update_after_step(s, [], 0)
                continue
            lo = step_inputs.sample_row_start[r]
            row_abs = lo + (s_pad if req.sampling.temperature > 0 else 0)
            inflight.commits.append(
                (req, len(req.output_token_ids), row_abs,
                 lo if need_topk and req.sampling.logprobs else -1))
            self.scheduler.update_after_step(s, [PENDING_TOKEN], 0)
            self._pending_ref[req.req_id] = (inflight, row_abs)
        self._inflight.append(inflight)

        finished = list(flushed)
        while len(self._inflight) > self._pipeline_depth:
            n, fin = self._sync_oldest()
            emitted += n
            finished.extend(fin)
        self.engine_stats.num_steps += 1
        self.engine_stats.num_finished += len(finished)
        return emitted, finished

    def _sync_oldest(self) -> tuple[int, list[Request]]:
        """Commit the oldest step in flight: patch its placeholders with
        the tokens (and logprobs), replay guided tokens on the host
        decoders and apply stop conditions; returns (tokens committed,
        finished requests)."""
        if not self._inflight:
            return 0, []
        step = self._inflight.pop(0)
        tokens = step.host_tokens()
        s_pad, kk = step.step_inputs.s_pad, self.runner.GUIDED_TOPK
        finished: list[Request] = []
        emitted = 0
        for req, out_pos, row_abs, lp_row in step.commits:
            if req.status.is_finished:
                continue   # stopped by an earlier commit: discarded
            assert req.output_token_ids[out_pos] == PENDING_TOKEN
            tok = int(tokens[row_abs])
            req.output_token_ids[out_pos] = tok
            emitted += 1
            if lp_row >= 0:
                # Ranked candidates ride the vector: [argmax, sampled,
                # top-K ids, bitcast log-probs].
                cand = tokens[2 * s_pad + lp_row * kk:
                              2 * s_pad + (lp_row + 1) * kk]
                logp = tokens[2 * s_pad + (s_pad + lp_row) * kk:
                              2 * s_pad + (s_pad + lp_row + 1) * kk] \
                    .view(np.float32)
                n = req.sampling.logprobs
                while len(req.output_logprobs) <= out_pos:
                    req.output_logprobs.append({})
                req.output_logprobs[out_pos] = {
                    int(t): float(p) for t, p in zip(cand[:n], logp[:n])}
            ref = self._pending_ref.get(req.req_id)
            if ref is not None and ref[0] is step:
                del self._pending_ref[req.req_id]
            if req.first_token_time is None:
                req.first_token_time = time.time()
            stop = None
            g = req.sampling.guided
            if g is not None:
                # The host decoder replays the committed token and stays
                # the authority on completion; tokens sampled past it
                # (the device's bit-0 sentinel) are trimmed, as length
                # overshoot is.
                g.advance_token(tok)
                if g.state == -1:
                    # Compile-time token_dead_ends() rules out grammars
                    # that could strand a request, so a dead state means
                    # the device let a forbidden token through: fail the
                    # request rather than return a trimmed output.
                    logger.warning(
                        "guided request %s reached a dead grammar state "
                        "at output position %d (token %d); aborting it",
                        req.req_id, out_pos, tok)
                    del req.output_token_ids[out_pos:]
                    stop = RequestStatus.FINISHED_ABORTED
                elif g.finished():
                    del req.output_token_ids[out_pos + 1:]
                    stop = RequestStatus.FINISHED_STOPPED
            if stop is None:
                stop = self._check_stop_prefix(req)
            if stop is not None:
                req.finish_time = time.time()
                self.scheduler.finish_request(req, stop)
                self._pending_ref.pop(req.req_id, None)
                finished.append(req)
        return emitted, finished

    def _check_stop_prefix(self, req: Request) -> Optional[RequestStatus]:
        """Stop conditions over the host-known prefix of the output (the
        tokens before the first placeholder)."""
        out = req.output_token_ids
        prefix = (out.index(PENDING_TOKEN) if PENDING_TOKEN in out
                  else len(out))
        sp = req.sampling
        for i in range(prefix):
            tok = out[i]
            if (not sp.ignore_eos and self.eos_token_id is not None
                    and tok == self.eos_token_id) or \
                    tok in sp.stop_token_ids:
                del out[i + 1:]
                return RequestStatus.FINISHED_STOPPED
        if self._check_stop_strings(req, prefix):
            del out[prefix:]
            return RequestStatus.FINISHED_STOPPED
        if prefix >= sp.max_tokens:
            del out[sp.max_tokens:]
            return RequestStatus.FINISHED_LENGTH
        if len(req.prompt_token_ids) + prefix >= \
                self.config.model.max_model_len:
            del out[prefix:]
            return RequestStatus.FINISHED_LENGTH
        return None

    def _flush_inflight(self) -> tuple[int, list[Request]]:
        emitted, out = 0, []
        while self._inflight:
            n, fin = self._sync_oldest()
            emitted += n
            out.extend(fin)
        return emitted, out

    # ------------------------------------------------------------------ #
    # Synchronous step
    # ------------------------------------------------------------------ #

    def _step_sync(self, sched_out: Optional[SchedulerOutput] = None
                   ) -> tuple[Optional[str], int, list[Request]]:
        """One synchronous step (of ``sched_out``, by default this
        iteration's schedule); returns (kind, tokens emitted, finished
        requests), None when nothing was scheduled.  Kind: ``decode`` for
        a pure-decode step, ``verify`` for a step that verifies drafts and
        feeds no prompt rows, ``mixed`` otherwise."""
        if sched_out is None:
            sched_out = self.scheduler.schedule()
        if not sched_out.scheduled:
            return None, 0, []
        self._maybe_observe(sched_out)
        for req in sched_out.preempted:
            self._evict_spec_state(req)
        step_inputs = self.runner.prepare_inputs(sched_out)
        if step_inputs.attn_qb == 1:
            kind = "decode"
        elif any(s.spec_token_ids for s in sched_out.scheduled) and \
                not any(s.request.is_prefilling for s in sched_out.scheduled):
            kind = "verify"
        else:
            kind = "mixed"
        # Logprobs need the step's ranked candidates, and so do guided
        # decoders without a mask (DFA decoders' masks ride the step).
        mask_capable = "guided_rows" in step_inputs.arrays
        need_topk = any(
            s.request.sampling.logprobs
            or (s.request.sampling.guided is not None
                and not (mask_capable and getattr(
                    s.request.sampling.guided, "mask_words", None)))
            for s in sched_out.scheduled)
        argmax, sampled, hidden_rows, *ranked = self.runner.execute(
            step_inputs, self._generator, need_topk)
        topk, topk_logp = ranked if need_topk else (None, None)
        finished: list[Request] = []
        # Sample row of each committed request's last accepted token (the
        # row a drafter chains from).
        accepted_row: dict[str, int] = {}
        capture_items: list = []
        emitted = 0
        for r, s in enumerate(sched_out.scheduled):
            req = s.request
            if req.num_computed_tokens + s.num_new_tokens < req.num_tokens:
                # Mid-prefill / recompute catch-up: no token produced.
                self.scheduler.update_after_step(s, [], 0)
                continue
            lo = step_inputs.sample_row_start[r]
            k = step_inputs.sample_row_count[r]
            if req.sampling.guided is not None:
                if self._commit_guided(req, s, lo + k - 1, argmax, sampled,
                                       topk, topk_logp, mask_capable):
                    finished.append(req)
                accepted_row[req.req_id] = lo
                emitted += 1
                continue
            # Greedy requests accept against the argmax chain; requests
            # with temperature > 0 sample every verify row from the target
            # distribution, and accepting draft == sample is unbiased.
            rows = (sampled if req.sampling.temperature > 0
                    else argmax)[lo:lo + k]
            new_tokens, n_acc, row = self._verify(req, s, rows)
            accepted_row[req.req_id] = lo + row
            if req.sampling.logprobs and topk is not None:
                # Row lo+i ranks the candidates of new_tokens[i] (as the
                # JAX engine reads them, trees included).
                n = req.sampling.logprobs
                req.output_logprobs.extend(
                    {int(t): float(p) for t, p in
                     zip(topk[lo + i][:n], topk_logp[lo + i][:n])}
                    for i in range(len(new_tokens)))
            self.scheduler.update_after_step(s, new_tokens, n_acc)
            self._update_suffix_cache(req, new_tokens)
            if self.hidden_capture is not None and s.spec_parents is None:
                # Row lo+i's hidden state produced new_tokens[i]; tree
                # drafts sit on rows that map otherwise: not captured.
                capture_items.extend((req.req_id, lo + i, t)
                                     for i, t in enumerate(new_tokens))
            emitted += len(new_tokens)
            if req.first_token_time is None:
                req.first_token_time = time.time()
            stop = req.check_stop(self.eos_token_id,
                                  self.config.model.max_model_len)
            if stop is None and self._check_stop_strings(req):
                stop = RequestStatus.FINISHED_STOPPED
            if stop is not None:
                req.finish_time = time.time()
                self.scheduler.finish_request(req, stop)
                self._evict_spec_state(req)
                finished.append(req)
        if capture_items:
            self.hidden_capture(hidden_rows, capture_items)
        self._propose_drafts(sched_out, hidden_rows, accepted_row)
        self.engine_stats.num_steps += 1
        self.engine_stats.num_finished += len(finished)
        return kind, emitted, finished

    def _commit_guided(self, req: Request, s, row: int, argmax, sampled,
                       topk, topk_logp, mask_capable: bool) -> bool:
        """Commit a guided request's token of this synchronous step (its
        sample row ``row``); returns whether the request finished.  A
        masked row's token is valid by construction; a decoder without a
        mask picks the first allowed of the ranked candidates, else the
        grammar's own fallback."""
        guided = req.sampling.guided
        if mask_capable and getattr(guided, "mask_words", None) is not None:
            tok = int((sampled if req.sampling.temperature > 0
                       else argmax)[row])
            if not guided.allows_token(tok):
                # All-zero mask (a wedged automaton): degrade.
                tok = guided.fallback_token()
                if tok is None:
                    tok = int(argmax[row])
        elif topk is not None:
            tok = guided.pick(topk[row])
            if tok is None:
                tok = guided.fallback_token()
            if tok is None:
                tok = int(argmax[row])
        else:
            tok = int(argmax[row])
        guided.advance_token(tok)
        if req.sampling.logprobs and topk_logp is not None:
            n = req.sampling.logprobs
            req.output_logprobs.append({
                int(t): float(p)
                for t, p in zip(topk[row][:n], topk_logp[row][:n])})
        self.scheduler.update_after_step(s, [int(tok)], 0)
        if req.first_token_time is None:
            req.first_token_time = time.time()
        stop = req.check_stop(self.eos_token_id,
                              self.config.model.max_model_len)
        if stop is None and self._check_stop_strings(req):
            stop = RequestStatus.FINISHED_STOPPED
        if stop is None and guided.finished():
            stop = RequestStatus.FINISHED_STOPPED
        if stop is None:
            return False
        req.finish_time = time.time()
        self.scheduler.finish_request(req, stop)
        self._evict_spec_state(req)
        return True

    def _verify(self, req: Request, s, rows) -> tuple[list[int], int, int]:
        """The tokens a request commits from its verify rows ``rows`` (the
        target's choice after the frontier and after each draft), the
        number of accepted drafts to commit with, and the verify row of
        its last accepted token."""
        drafts = s.spec_token_ids
        if s.spec_parents is not None and drafts:
            # Token tree: from the frontier, follow at each node the child
            # whose token is the target's choice at that node's row, then
            # add the target's choice after the last match.  The accepted
            # tokens' KV sits at scratch slots, so they commit with
            # num_accepted=0 and the scheduler feeds them again next step.
            childs: dict[int, list[int]] = {}
            for i, p in enumerate(s.spec_parents):
                childs.setdefault(p, []).append(i)
            cur = -1
            path: list[int] = []
            while True:
                want = int(rows[0 if cur < 0 else 1 + cur])
                nxt = next((c for c in childs.get(cur, ())
                            if drafts[c] == want), None)
                if nxt is None:
                    break
                path.append(nxt)
                cur = nxt
            self._observe_drafts(req, len(drafts), len(path))
            return ([int(drafts[c]) for c in path] + [want], 0,
                    0 if cur < 0 else 1 + cur)
        n_acc = 0
        for i, d in enumerate(drafts):
            if rows[i] != d:
                break
            n_acc += 1
        if drafts:
            self._observe_drafts(req, len(drafts), n_acc)
        return ([int(x) for x in drafts[:n_acc]] + [int(rows[n_acc])], n_acc,
                n_acc)

    def _observe_drafts(self, req: Request, n_drafts: int,
                        n_accepted: int) -> None:
        self.spec_stats.observe(n_drafts, n_accepted)
        req.num_draft_tokens += n_drafts
        req.num_accepted_draft_tokens += n_accepted

    def _check_stop_strings(self, req: Request,
                            known: Optional[int] = None) -> bool:
        """OpenAI ``stop`` string sequences: finish when one appears in
        the decoded output (its first ``known`` tokens, by default all);
        ``req.final_text`` records the user-visible text cut just before
        the stop."""
        sp = req.sampling
        if not sp.stop or self.tokenizer is None:
            return False
        out = req.output_token_ids
        if known is None:
            known = len(out)
        # Bounded re-decode window: stop sequences are short; the slack
        # covers multi-token renderings and BPE boundary effects.
        win = 16 + max(len(s) for s in sp.stop)
        text = self.tokenizer.decode(out[max(0, known - win):known])
        if not any(s in text for s in sp.stop):
            return False
        full = self.tokenizer.decode(out[:known])
        cut = min((idx for idx in (full.find(s) for s in sp.stop)
                   if idx != -1), default=-1)
        req.final_text = full[:cut] if cut >= 0 else full
        return True

    # ------------------------------------------------------------------ #
    # Speculation
    # ------------------------------------------------------------------ #

    def _spec_disabled_now(self) -> bool:
        sc = self.spec_config
        if sc is None:
            return True
        return bool(sc.disable_by_batch_size and len(self.scheduler.running)
                    > sc.disable_by_batch_size)

    def _propose_drafts(self, sched_out: SchedulerOutput,
                        hidden_rows: torch.Tensor,
                        accepted_row: dict[str, int]) -> None:
        """Drafts for the next step of every request this step left at
        its decode frontier (with trees, as soon as its prompt is
        computed: accepted tokens are fed again).  A suffix draft wins
        where its score reaches ``min_score`` (0 for ``method="suffix"``,
        else ``num_speculative_tokens``: what a drafter offers); the
        drafter drafts for the other frontier requests, from
        ``hidden_rows`` [s_pad, hidden] at ``accepted_row``.  None above
        ``disable_by_batch_size`` running requests, and none while the
        fused loop is installed: it drafts every decode step on the
        device, and the sync steps around it only prefill and admit."""
        sc = self.spec_config
        if self._spec_disabled_now() or self._fused is not None:
            return
        tree = bool(sc.use_tree_spec)

        def proposable(req):
            sp = req.sampling
            if req.status.is_finished or sp.guided is not None or \
                    sp.needs_penalties:
                return False
            if req.num_computed_tokens >= req.num_tokens - 1:
                return True
            return tree and \
                req.num_computed_tokens >= len(req.prompt_token_ids)

        results = {}
        if self._suffix_cache is not None:
            items = []
            for s in sched_out.scheduled:
                req = s.request
                if not proposable(req):
                    continue
                pattern = req.all_token_ids[-sc.suffix_cache_max_depth:]
                cap = min(sc.num_speculative_tokens,
                          self.config.model.max_model_len
                          - req.num_tokens - 1)
                if tree:
                    cap = min(cap, MAX_TREE_NODES)
                if cap <= 0:
                    continue
                items.append((req.req_id, dict(
                    req_id=req.req_id, pattern=pattern,
                    max_spec_tokens=cap,
                    max_spec_factor=sc.suffix_max_spec_factor,
                    max_spec_offset=sc.suffix_max_spec_offset,
                    min_token_prob=sc.suffix_min_token_prob,
                    use_tree_spec=tree,
                    use_cached_prompt=self._suffix_cache.has_cached_prompt(
                        req.req_id))))
            results = self._suffix_cache.speculate_batch(
                items, pool=self._prompt_tree_pool)
        min_score = 0 if sc.method == "suffix" else sc.num_speculative_tokens
        drafter_reqs = []
        for s in sched_out.scheduled:
            req = s.request
            if not proposable(req):
                continue
            res = results.get(req.req_id)
            if res is not None and res.score >= min_score and res.token_ids:
                req.spec_token_ids = [int(t) for t in res.token_ids]
                parents = list(res.parents)
                # A chain rides the linear path (its KV lands at the right
                # slots, nothing is fed again).
                is_chain = all(p == i - 1 for i, p in enumerate(parents))
                req.spec_parents = None if is_chain else parents
            elif self._drafter is not None and \
                    req.num_computed_tokens >= req.num_tokens - 1:
                drafter_reqs.append(s)
        if drafter_reqs:
            self._drafter.propose(drafter_reqs, hidden_rows, accepted_row,
                                  self.config.model.max_model_len,
                                  channel=self.runner.mh_channel)

    def _update_suffix_cache(self, req: Request,
                             new_tokens: list[int]) -> None:
        if self._suffix_cache is None:
            return
        if not self._suffix_cache.has_cached_prompt(req.req_id):
            fut = self._prompt_tree_futs.pop(req.req_id, None)
            if fut is not None:
                self._suffix_cache.install_prompt_tree(req.req_id,
                                                       fut.result())
            else:
                self._suffix_cache.cache_prompt(req.req_id,
                                                req.prompt_token_ids)
        self._suffix_cache.update_response(req.req_id, new_tokens)

    def _evict_spec_state(self, req: Request) -> None:
        if self._suffix_cache is None:
            return
        fut = self._prompt_tree_futs.pop(req.req_id, None)
        if fut is not None:
            fut.cancel()
        if self._suffix_cache.has_cached_prompt(req.req_id):
            self._suffix_cache.evict_prompt(req.req_id)

    def _maybe_observe(self, sched_out) -> None:
        for s in sched_out.scheduled:
            if s.request.is_prefilling:
                self.engine_stats.num_prompt_tokens += s.num_new_tokens
            else:
                self.engine_stats.num_generated_tokens += s.num_new_tokens
        now = time.time()
        if now - self._last_log >= self.config.observability.log_interval_s:
            self._last_log = now
            st = self.engine_stats
            msg = (f"steps={st.num_steps} running="
                   f"{len(self.scheduler.running)} waiting="
                   f"{len(self.scheduler.waiting)} gen_tok/s="
                   f"{st.tokens_per_second():.1f} free_blocks="
                   f"{self.scheduler.block_manager.num_free_blocks}")
            if self.spec_stats.num_drafts:
                msg += (f" spec_accept="
                        f"{self.spec_stats.acceptance_rate:.2f}")
            logger.info(msg)
