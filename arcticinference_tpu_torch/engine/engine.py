"""LLMEngine: the step loop tying scheduler and runner together.

Counterpart of ``arcticinference_tpu/engine/engine.py``:

  schedule -> prepare inputs -> device step -> host verify
  -> commit tokens / stops -> update suffix cache -> propose next drafts

This part of the port runs the synchronous step
(``LLMEngine._step_sync`` in the JAX package) and, for suffix
speculation, the device-resident fused decode loop
(``engine/fused_decode.py``; ``SpeculativeConfig.enable_fused_decode``,
the default for linear suffix drafts): while it is active, decode steps
verify and draft on the device, and prefills and non-fusable requests
ride interleaved synchronous steps.  ``async_scheduling`` (the JAX
package's pipelined step with device-side token passthrough) is not
ported yet: when it is requested, which is the default, the engine says
so once at start-up and runs the synchronous step, which gives the same
tokens.  Speculation is suffix decoding
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
or ``logprobs`` ride the synchronous step (also beside the fused loop,
which does not mirror them): penalties act on the step's logits, and
each committed token gets a ``{token: logprob}`` dict of the step's
ranked candidates.  A SwiftKV model (``llama_swiftkv``) composes with
suffix decoding, the drafters (their hidden rows are its sample rows)
and hidden capture, on the synchronous step and the fused loop; token
trees with it raise, as in the JAX package.  Guided decoding raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.fused_decode import FusedDecodeLoop
from arcticinference_tpu_torch.engine.request import (Request, RequestStatus,
                                                      SamplingParams)
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.engine.scheduler import (Scheduler,
                                                        SchedulerOutput)
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.ops.cuda.ragged_attention import MAX_TREE_NODES
from arcticinference_tpu_torch.spec.proposer import ArcticProposer
from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache
from arcticinference_tpu_torch.stats import (EngineStats, SpecDecodingStats,
                                             StepTimeStats)
from arcticinference_tpu_torch.utils import resolve_device

logger = logging.getLogger("arcticinference_tpu_torch")


class LLMEngine:

    def __init__(self, config: EngineConfig,
                 device: Union[str, torch.device, None] = None):
        spec = config.speculative
        self.config = config
        self.device = resolve_device(device)
        module, arch, params = load_model(config.model, self.device)
        self.arch = arch
        self.eos_token_id: Optional[int] = arch.eos_token_id
        # Detokenizer for string stop sequences (set by LLM).
        self.tokenizer = None
        self.runner = ModelRunner(config, module, arch, params, self.device)
        if spec is not None and spec.use_tree_spec and self.runner.swift:
            raise NotImplementedError(
                "use_tree_spec does not compose with SwiftKV (the "
                "early-exit halves re-run draft rows with different masks)")
        self.scheduler = Scheduler(config.scheduler, config.cache,
                                   self.runner.num_blocks)
        self.engine_stats = EngineStats()
        self.step_times = StepTimeStats()
        self.spec_stats = SpecDecodingStats()
        self._last_log = time.time()
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.model.seed)
        # Distillation hook (spec/distill.py HiddenCapture): called with
        # (hidden rows, [(req_id, row, emitted token)]) by the synchronous
        # step and at the fused loop's drain.
        self.hidden_capture = None
        # The JAX engine pipelines steps only without speculation.
        if config.scheduler.async_scheduling and spec is None:
            logger.info("async_scheduling=True: the pipelined step is not "
                        "ported yet; running the synchronous step")

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
            self._drafter = ArcticProposer(spec, arch, self.device,
                                           target_params=self.runner.params)
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
        if sampling.guided is not None:
            raise NotImplementedError("guided decoding is not ported yet")
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
        return req

    @property
    def has_unfinished(self) -> bool:
        return self.scheduler.num_unfinished > 0

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
        return self._step_sync()

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
        # Logprobs need the step's ranked candidates.
        need_topk = any(s.request.sampling.logprobs
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

    def _check_stop_strings(self, req: Request) -> bool:
        """OpenAI ``stop`` string sequences: finish when one appears in
        the decoded output; ``req.final_text`` records the user-visible
        text cut just before the stop."""
        sp = req.sampling
        if not sp.stop or self.tokenizer is None:
            return False
        out = req.output_token_ids
        # Bounded re-decode window: stop sequences are short; the slack
        # covers multi-token renderings and BPE boundary effects.
        win = 16 + max(len(s) for s in sp.stop)
        text = self.tokenizer.decode(out[max(0, len(out) - win):])
        if not any(s in text for s in sp.stop):
            return False
        full = self.tokenizer.decode(out)
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
                                  self.config.model.max_model_len)

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
