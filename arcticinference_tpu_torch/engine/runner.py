"""Model runner: lowers a SchedulerOutput to padded step arrays, runs the
forward on the device, returns per-request sample rows.

Counterpart of ``arcticinference_tpu/engine/runner.py`` for one device.
:meth:`ModelRunner.prepare_inputs` builds the same host arrays as the JAX
runner (same keys, same bucketed shapes ``t_pad`` / ``s_pad``, same
attention work-item schedule), so the two compare element for element.
Every array then goes to the device in one int32 and one float32 copy.
:meth:`ModelRunner.dispatch` enqueues a step and reads nothing back (a
timing loop or a CUDA graph can replay its device work,
:meth:`ModelRunner.launch`); it returns the step's packed int32 output
vector, in the JAX runner's layout ``[argmax s_pad | sampled s_pad |
top-K ids s_pad*K | bitcast log-probs s_pad*K | grammar states g_pad]``
(the last three parts only when asked for).  :meth:`ModelRunner.execute`
is dispatch plus the vector's copy to the host, unpacked.

The engine's pipelined step feeds tokens the host has not seen yet from
the previous step's vector (``passthrough``: the step's ``input_src``
rows), and, for guided requests, the automaton states too: the grammar
tables of up to :data:`ModelRunner.GUIDED_POOL_SLOTS` grammars live in a
device pool (:meth:`ModelRunner.upload_guided_tables`), whose mask rows
the step applies and whose transitions advance the states
(``ops/guided.py``).  The synchronous step ships a host-built vocab mask
per guided row instead (``guided_rows`` / ``guided_mask``).

Weights may be plain or weight-only quantized (``QuantizedLinear``
leaves: fp8, int8, int4).  Speculative drafts ride the step as extra
token rows: a linear chain as consecutive positions, a token tree with
depth-based positions and per-row ancestor bitmasks, lowered onto the
work items for the ragged kernel's tree-mask path.  A step also hands
back its sample rows' hidden states, on the device, for the MLP / LSTM
drafters.  Repetition / presence / frequency penalties act on the
float32 logits before the argmax and the sampler, from each request's
token history (``pen_out_tokens`` / ``pen_all_tokens``, built only on
steps where a request asks for them); with ``need_topk`` a step also
returns each sample row's top :data:`ModelRunner.GUIDED_TOPK` ids and
their log-softmax values (logprobs, and the candidates of guided
decoders without masks).  A SwiftKV model (``NEEDS_SWIFT_SCHEDULE``)
gets a second attention schedule over the sample rows (the ``swift_*``
arrays, :func:`swift_schedule`) and returns the sample rows' hidden
states itself (``RETURNS_SAMPLE_ROWS``).  Not ported yet (they raise
``NotImplementedError``): meshes (tp / sp / dp / pp, and with them the
dp-stacked swift schedules).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.scheduler import SchedulerOutput
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    build_work_items, tree_masks, tree_work_items)
from arcticinference_tpu_torch.ops.kv_cache import (KVCacheSpec,
                                                    allocate_kv_cache)
from arcticinference_tpu_torch.ops.guided import (guided_advance,
                                                 guided_mask_rows)
from arcticinference_tpu_torch.ops.sampling import (apply_penalties,
                                                    apply_vocab_mask, sample)
from arcticinference_tpu_torch.utils import (cdiv, default_token_buckets,
                                             device_memory_bytes,
                                             pad_to_bucket)

_F32_KEYS = ("temperature", "top_p", "min_p", "rep_pen", "pres_pen",
             "freq_pen")


def swift_schedule(row_count, last_pos: np.ndarray, s_pad: int,
                   block_size: int) -> dict[str, np.ndarray]:
    """The SwiftKV step's second ragged schedule: work items of at most 8
    rows over the sample rows (``row_count[r]`` of request ``r``, which
    end at position ``last_pos[r]``, contiguous per request in the
    ``s_pad`` layout), as ``swift_<key>`` arrays; the JAX runner's."""
    b = len(last_pos)
    srow = np.zeros(b, np.int64)
    srow[:len(row_count)] = row_count
    sched = build_work_items(srow, last_pos, 8, block_size, s_pad // 8 + b,
                             s_pad)
    return {f"swift_{k}": a for k, a in zip(
        ("item_req", "item_qstart", "item_qlen", "item_pages",
         "item_pos_base", "token_item", "token_off"), sched)}


def _nbytes(tree) -> int:
    """Bytes of a parameter tree's tensors (a quantized weight's values
    and scales), nested dicts included."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.nbytes


@dataclass
class StepInputs:
    """Host-side arrays for one engine step (already padded)."""

    arrays: dict[str, np.ndarray]
    t_pad: int
    s_pad: int
    attn_qb: int
    # Row ranges into the sample rows per scheduled request.
    sample_row_start: list[int]
    sample_row_count: list[int]
    total_tokens: int = 0
    # Device-resident guided decoding: req_id -> index into the step's
    # guided rows, and the padded guided-row count (the grammar-state
    # segment's length at the end of the output vector).
    guided_index: Optional[dict] = None
    gstate_count: int = 0


class ModelRunner:

    #: Ranked candidates a step returns with ``need_topk`` (logprobs,
    #: guided decoders without masks).
    GUIDED_TOPK = 16

    #: The device grammar pool of the pipelined guided path: grammars
    #: (slots), DFA states and transition intervals per grammar.
    GUIDED_POOL_SLOTS = 8
    GUIDED_POOL_STATES = 1024
    GUIDED_POOL_TRANS = 16384

    def __init__(self, config: EngineConfig, module, arch, params: dict,
                 device: torch.device):
        pcfg = config.parallel
        if pcfg.world_size > 1:
            raise NotImplementedError(
                "tensor / sequence / data / pipeline parallelism is not "
                "ported; the port runs on one device")
        self.config = config
        self.module = module
        self.arch = arch
        self.device = device
        # Per-layer [k_scale, v_scale] fp8-KV dequant pairs ride the
        # checkpoint's parameters; they are runner state, not weights.
        loaded_kv_scales = params.pop("kv_scales", None)
        # As the JAX runner: a module without fuse_params (Mixtral) runs
        # its weights as they are.
        fuse = getattr(module, "fuse_params", None)
        self.params = fuse(params) if fuse is not None else params
        # SwiftKV: the second schedule over the sample rows, and forward
        # hands back those rows itself.
        self.swift = bool(getattr(module, "NEEDS_SWIFT_SCHEDULE", False))
        self.returns_rows = bool(getattr(module, "RETURNS_SAMPLE_ROWS",
                                         False))

        cache_cfg = config.cache
        self.block_size = cache_cfg.block_size
        self.max_blocks_per_req = cdiv(config.model.max_model_len,
                                       self.block_size)
        kv_dtype = (torch.float8_e4m3fn
                    if cache_cfg.kv_cache_dtype == "fp8" else torch.bfloat16)
        self.num_blocks = cache_cfg.num_blocks or self._auto_num_blocks(
            kv_dtype)
        self.kv_spec = KVCacheSpec(
            num_layers=arch.num_layers, num_blocks=self.num_blocks,
            num_kv_heads=arch.num_kv_heads, block_size=self.block_size,
            head_dim=arch.head_dim, dtype=kv_dtype)
        self.kv = allocate_kv_cache(self.kv_spec, device)
        if loaded_kv_scales is not None and kv_dtype == torch.float8_e4m3fn:
            kv_scale = torch.as_tensor(loaded_kv_scales, dtype=torch.float32)
        else:
            kv_scale = torch.ones((arch.num_layers, 2), dtype=torch.float32)
        self.kv_scale = kv_scale.to(device)

        self.b_max = config.scheduler.max_num_seqs
        self.token_buckets = default_token_buckets(
            config.scheduler.max_num_batched_tokens)
        self.sample_buckets = default_token_buckets(
            max(16, config.scheduler.max_num_batched_tokens))
        # Allocated at the first guided request on the pipelined step
        # (131 MB of masks at a 128k vocabulary).
        self._guided_pool: Optional[dict] = None

    def _auto_num_blocks(self, kv_dtype: torch.dtype) -> int:
        """Size the cache from the device's memory, less the weights (a
        quantized weight's values and scales) and a 1 GiB reserve for
        activations."""
        param_bytes = _nbytes(self.params)
        budget = (int(device_memory_bytes(self.device)
                      * self.config.cache.hbm_utilization)
                  - param_bytes - (1 << 30))
        spec = KVCacheSpec(
            num_layers=self.arch.num_layers, num_blocks=1,
            num_kv_heads=self.arch.num_kv_heads,
            block_size=self.block_size, head_dim=self.arch.head_dim,
            dtype=kv_dtype)
        n = max(budget // spec.bytes_per_block, 16)
        return int(min(n, 1 << 17))

    # ------------------------------------------------------------------ #
    # Input preparation (host)
    # ------------------------------------------------------------------ #

    def prepare_inputs(self, sched_out: SchedulerOutput,
                       passthrough: Optional[dict] = None,
                       guided_dev: Optional[dict] = None) -> StepInputs:
        """``passthrough`` maps req_id -> absolute index into the
        PREVIOUS step's output vector of a token whose value has not
        reached the host yet (the pipelined step).  ``guided_dev`` maps
        req_id -> (pool slot, src, init state) for the device-resident
        guided path: src indexes the previous step's output vector (its
        grammar-state segment), or is -1 to seed from the init state."""
        scheduled = sched_out.scheduled
        total = sum(s.num_new_tokens for s in scheduled)
        t_pad = pad_to_bucket(max(total, 1), self.token_buckets)
        b = self.b_max

        input_ids = np.zeros(t_pad, np.int32)
        input_src = np.full(t_pad, -1, np.int32)
        positions = np.zeros(t_pad, np.int32)
        req_idx = np.full(t_pad, -1, np.int32)
        slot_mapping = np.full(t_pad, -1, np.int32)
        block_tables = np.zeros((b, self.max_blocks_per_req), np.int32)
        seq_lens = np.zeros(b, np.int32)
        query_lens = np.zeros(b, np.int64)
        last_pos = np.zeros(b, np.int64)

        sample_rows: list[int] = []
        row_start: list[int] = []
        row_count: list[int] = []
        row_tree_mask = None          # [t_pad] ancestor bitmasks
        tree_start = None             # [B] frontier slot per request

        t = 0
        for r, s in enumerate(scheduled):
            req = s.request
            n = s.num_new_tokens
            ctx = req.num_computed_tokens
            toks = (req.all_token_ids + s.spec_token_ids)[ctx:ctx + n]
            assert len(toks) == n, (len(toks), n, ctx)
            if passthrough and req.req_id in passthrough:
                # The first fed token is the previous step's output,
                # still on the device; its host value is a placeholder.
                input_src[t] = passthrough[req.req_id]
                toks = [0] + list(toks[1:])
            input_ids[t:t + n] = toks
            positions[t:t + n] = np.arange(ctx, ctx + n)
            if s.spec_parents is not None and s.spec_token_ids:
                # Token-tree drafts: positions are depth-based (siblings
                # share one), cache slots stay linear (slot_mapping below),
                # and attention sees a node's ancestors only through its
                # row's bitmask.
                depth, mask = tree_masks(s.spec_parents)
                chunk = n - len(s.spec_token_ids)
                frontier = ctx + chunk - 1   # slot == position (real)
                if row_tree_mask is None:
                    row_tree_mask = np.zeros(t_pad, np.int32)
                    tree_start = np.full(b, -1, np.int32)
                tree_start[r] = frontier
                positions[t + chunk:t + n] = frontier + 1 + depth
                row_tree_mask[t + chunk:t + n] = mask
            req_idx[t:t + n] = r
            bt = req.block_ids
            block_tables[r, :len(bt)] = bt
            for i in range(n):
                pos = ctx + i
                slot_mapping[t + i] = (bt[pos // self.block_size]
                                       * self.block_size
                                       + pos % self.block_size)
            seq_lens[r] = ctx + n
            query_lens[r] = n
            last_pos[r] = ctx + n - 1
            # Sample rows: the last (#drafts + 1) token rows.
            k = len(s.spec_token_ids) + 1
            row_start.append(len(sample_rows))
            row_count.append(k)
            sample_rows.extend(range(t + n - k, t + n))
            t += n

        s_pad = pad_to_bucket(max(len(sample_rows), 1), self.sample_buckets)
        logits_indices = np.zeros(s_pad, np.int32)
        logits_indices[:len(sample_rows)] = sample_rows

        # Sampling params per row (every verify row of a request).
        temperature = np.zeros(s_pad, np.float32)
        top_k = np.zeros(s_pad, np.int32)
        top_p = np.ones(s_pad, np.float32)
        min_p = np.zeros(s_pad, np.float32)
        seeds = np.full(s_pad, -1, np.int32)
        counters = np.zeros(s_pad, np.int32)
        rep_pen = np.ones(s_pad, np.float32)
        pres_pen = np.zeros(s_pad, np.float32)
        freq_pen = np.zeros(s_pad, np.float32)
        any_penalties = False
        for r, s in enumerate(scheduled):
            req = s.request
            sp = req.sampling
            lo, k = row_start[r], row_count[r]
            temperature[lo:lo + k] = sp.temperature
            top_k[lo:lo + k] = sp.top_k
            top_p[lo:lo + k] = sp.top_p
            min_p[lo:lo + k] = sp.min_p
            if sp.seed is not None:
                seeds[lo:lo + k] = sp.seed
                # Counter = absolute position of the token being sampled,
                # so a seeded request's stream is schedule-invariant.
                end = req.num_computed_tokens + s.num_new_tokens
                counters[lo:lo + k] = np.arange(end - k + 1, end + 1)
            if sp.needs_penalties:
                rep_pen[lo:lo + k] = sp.repetition_penalty
                pres_pen[lo:lo + k] = sp.presence_penalty
                freq_pen[lo:lo + k] = sp.frequency_penalty
                any_penalties = True

        # Grammar-guided vocab bitmasks (DFA-backed decoders) for the
        # row that commits a token: the host's mask of the automaton's
        # state, or (pipelined) the device pool's row of a state that
        # rides the output vector.
        guided_entries: list[tuple[int, np.ndarray]] = []
        dev_entries: list[tuple[int, int, int, int, str]] = []
        for r, s in enumerate(scheduled):
            req = s.request
            g = req.sampling.guided
            if g is None or getattr(g, "mask_words", None) is None:
                continue
            if req.num_computed_tokens + s.num_new_tokens < \
                    req.num_tokens:
                continue   # mid-prefill: no token committed this step
            row = row_start[r] + row_count[r] - 1
            if guided_dev is not None and req.req_id in guided_dev:
                slot, src, init = guided_dev[req.req_id]
                dev_entries.append((row, slot, src, init, req.req_id))
            else:
                guided_entries.append((row, g.mask_words()))
        assert not (guided_entries and dev_entries), \
            "host-mask and device-pool guided rows cannot mix in a step"

        # attn_qb == 1 marks a pure-decode step (one frontier row per
        # request, token order == request order): the model routes it to
        # the grouped decode kernel.  The work-item schedule is still
        # built (at qb=8), as in the JAX runner.  A step with tree rows
        # never is one: the ancestor masks ride the work items.
        max_qlen = int(query_lens.max(initial=1))
        pure_decode = (max_qlen == 1 and bool(scheduled)
                       and row_tree_mask is None)
        attn_qb = 1 if pure_decode else (8 if max_qlen <= 8 else 32)
        sched_qb = 8 if attn_qb == 1 else attn_qb
        (item_req, item_qstart, item_qlen, item_pages, item_pos_base,
         token_item, token_off) = build_work_items(
            query_lens, last_pos, sched_qb, self.block_size,
            t_pad // sched_qb + b, t_pad)

        tree_arrays = {}
        if row_tree_mask is not None:
            it_ts, it_mask = tree_work_items(row_tree_mask, tree_start,
                                             item_req, token_item,
                                             token_off, attn_qb)
            tree_arrays = dict(
                attn_tree_start=tree_start,
                attn_row_tree_mask=row_tree_mask,
                attn_item_tree_start=it_ts,
                attn_item_tree_mask=it_mask)

        arrays = dict(
            input_ids=input_ids, input_src=input_src,
            positions=positions, req_idx=req_idx,
            slot_mapping=slot_mapping, block_tables=block_tables,
            seq_lens=seq_lens, logits_indices=logits_indices,
            temperature=temperature, top_k=top_k, top_p=top_p,
            min_p=min_p, seeds=seeds, counters=counters,
            rep_pen=rep_pen, pres_pen=pres_pen, freq_pen=freq_pen,
            attn_item_req=item_req, attn_item_qstart=item_qstart,
            attn_item_qlen=item_qlen, attn_item_pages=item_pages,
            attn_item_pos_base=item_pos_base, attn_token_item=token_item,
            attn_token_off=token_off,
            **tree_arrays,
        )
        g_buckets = [g for g in (1, 2, 4, 8, 16, 32, 64, 128)
                     if g <= max(b, 1)] + [b]
        guided_index = None
        gstate_count = 0
        if guided_entries:
            w = (self.arch.vocab_size + 31) // 32
            g_pad = pad_to_bucket(len(guided_entries), g_buckets)
            grows = np.full(g_pad, -1, np.int32)
            gmask = np.zeros((g_pad, w), np.uint32)
            for i, (row, mask) in enumerate(guided_entries):
                grows[i] = row
                gmask[i, :len(mask)] = mask   # short mask: tail stays 0
            arrays["guided_rows"] = grows
            arrays["guided_mask"] = gmask.view(np.int32)
        elif dev_entries:
            g_pad = pad_to_bucket(len(dev_entries), g_buckets)
            grows, gslot, gsrc, ginit = (np.full(g_pad, -1, np.int32)
                                         for _ in range(4))
            guided_index = {}
            for i, (row, slot, src, init, rid) in enumerate(dev_entries):
                grows[i], gslot[i] = row, slot
                gsrc[i], ginit[i] = src, init
                guided_index[rid] = i
            arrays.update(guided_rows=grows, gd_slot=gslot, gd_src=gsrc,
                          gd_init=ginit)
            gstate_count = g_pad
        if any_penalties:
            # Token histories of the requests asking for penalties, -1
            # padded to a bucketed length; every verify row of a request
            # carries its history before this step (as in the JAX runner).
            la = pad_to_bucket(
                max(max(s.request.num_tokens for s in scheduled), 1),
                self.token_buckets + [self.config.model.max_model_len])
            pen_out = np.full((s_pad, la), -1, np.int32)
            pen_all = np.full((s_pad, la), -1, np.int32)
            for r, s in enumerate(scheduled):
                req = s.request
                if not req.sampling.needs_penalties:
                    continue
                lo, k = row_start[r], row_count[r]
                pen_out[lo:lo + k, :len(req.output_token_ids)] = \
                    req.output_token_ids
                pen_all[lo:lo + k, :req.num_tokens] = req.all_token_ids
            arrays["pen_out_tokens"] = pen_out
            arrays["pen_all_tokens"] = pen_all
        if self.swift:
            arrays.update(swift_schedule(row_count, last_pos, s_pad,
                                         self.block_size))
        return StepInputs(arrays=arrays, t_pad=t_pad, s_pad=s_pad,
                          attn_qb=attn_qb, sample_row_start=row_start,
                          sample_row_count=row_count, total_tokens=total,
                          guided_index=guided_index,
                          gstate_count=gstate_count)

    # ------------------------------------------------------------------ #
    # Device grammar pool (pipelined guided decoding)
    # ------------------------------------------------------------------ #

    def guided_fits_pool(self, index) -> bool:
        return (index.dfa.n_states <= self.GUIDED_POOL_STATES
                and len(index.dfa.trans_lo) <= self.GUIDED_POOL_TRANS)

    def upload_array(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device without a host sync: through pinned
        memory and a non-blocking copy on the card (the pinned block is
        not reused before the copy ends), a private copy on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _ensure_guided_pool(self) -> dict:
        if self._guided_pool is None:
            w = (self.arch.vocab_size + 31) // 32
            p, s, i = (self.GUIDED_POOL_SLOTS, self.GUIDED_POOL_STATES,
                       self.GUIDED_POOL_TRANS)
            dev, i32 = self.device, torch.int32
            self._guided_pool = dict(
                masks=torch.zeros((p, s, w), dtype=i32, device=dev),
                keys=torch.full((p, i), np.iinfo(np.int32).max, dtype=i32,
                                device=dev),
                hi=torch.full((p, i), -1, dtype=i32, device=dev),
                nxt=torch.full((p, i), -1, dtype=i32, device=dev),
                cps=None)
        return self._guided_pool

    def upload_guided_tables(self, slot: int, index) -> None:
        """Load grammar ``index`` (a ``TokenDfaIndex``) into pool slot
        ``slot``; the copies are enqueued, nothing waits for the
        device."""
        if not self.guided_fits_pool(index):
            raise ValueError("grammar exceeds the device pool")
        pool = self._ensure_guided_pool()
        masks, keys, hi, nxt = index.device_tables()
        w = pool["masks"].shape[-1]
        mrow = np.zeros((self.GUIDED_POOL_STATES, w), np.int32)
        mrow[:masks.shape[0], :masks.shape[1]] = masks.view(np.int32)
        i_pad = self.GUIDED_POOL_TRANS
        krow = np.full(i_pad, np.iinfo(np.int32).max, np.int32)
        krow[:len(keys)] = keys
        hrow = np.full(i_pad, -1, np.int32)
        hrow[:len(hi)] = hi
        nrow = np.full(i_pad, -1, np.int32)
        nrow[:len(nxt)] = nxt
        for name, host in (("masks", mrow), ("keys", krow), ("hi", hrow),
                           ("nxt", nrow)):
            pool[name][slot].copy_(self.upload_array(host))
        if pool["cps"] is None:
            pool["cps"] = self.upload_array(
                index.vocab.cps_matrix().view(np.int32))

    # ------------------------------------------------------------------ #
    # Device step
    # ------------------------------------------------------------------ #

    def upload(self, arrays: dict[str, np.ndarray]) -> dict:
        """All step arrays on the device, in one int32 and one float32
        host-to-device copy (views into the two buffers).  On the card
        the copies go through pinned memory and do not wait for the
        device."""
        out = {}
        for dtype, keys in (
                (np.float32, [k for k in arrays if k in _F32_KEYS]),
                (np.int32, [k for k in arrays if k not in _F32_KEYS])):
            flat = np.concatenate([arrays[k].ravel() for k in keys])
            buf = torch.from_numpy(flat.astype(dtype, copy=False))
            if self.device.type == "cuda":
                buf = buf.pin_memory().to(self.device, non_blocking=True)
            else:
                buf = buf.to(self.device)
            off = 0
            for k in keys:
                n = arrays[k].size
                out[k] = buf[off:off + n].view(arrays[k].shape)
                off += n
        return out

    @torch.inference_mode()
    def launch(self, inputs: dict, attn_qb: int, need_sampling: bool,
               generator: torch.Generator, need_topk: bool = False,
               prev_tokens: Optional[torch.Tensor] = None, seeds=None,
               counters=None):
        """The step's device work on uploaded ``inputs`` (see
        :meth:`upload`): passthrough tokens (and grammar states) from
        ``prev_tokens``, the previous step's output vector; forward,
        logits of the sample rows, penalties (when the step carries token
        histories), guided masks, argmax and, with ``need_sampling``,
        sampling (``seeds`` / ``counters``: the host's arrays, by default
        the uploaded ones, which only a CPU step can read).  Returns the
        packed int32 output vector (module docstring) and the sample
        rows' hidden states [s_pad, hidden]; nothing here reads the
        device back, so a timing loop or a CUDA graph can replay it."""
        inputs = dict(inputs, kv_scale=self.kv_scale)
        if prev_tokens is not None:
            src = inputs["input_src"]
            inputs["input_ids"] = torch.where(
                src >= 0,
                prev_tokens[src.clamp(0, prev_tokens.shape[0] - 1).long()],
                inputs["input_ids"])
        attn = self.module.make_attn_impl(attn_qb)
        self.kv, h = self.module.forward(self.params, self.arch, self.kv,
                                         inputs, attn_impl=attn)
        rows = (h if self.returns_rows
                else h[inputs["logits_indices"].long()])
        logits = self.module.compute_logits(self.params, rows)
        if "pen_out_tokens" in inputs:
            logits = apply_penalties(
                logits, inputs["pen_out_tokens"], inputs["pen_all_tokens"],
                inputs["rep_pen"], inputs["pres_pen"], inputs["freq_pen"])
        gstates = None
        if "gd_slot" in inputs:
            # Pipelined guided rows: the automaton state comes from the
            # previous step's vector (or the host), its mask row from the
            # grammar pool.
            g_src = inputs["gd_src"]
            gstates = inputs["gd_init"]
            if prev_tokens is not None:
                gstates = torch.where(
                    g_src >= 0,
                    prev_tokens[g_src.clamp(0, prev_tokens.shape[0] - 1)
                                .long()], gstates)
            logits = apply_vocab_mask(
                logits, inputs["guided_rows"],
                guided_mask_rows(gstates, inputs["gd_slot"],
                                 self._guided_pool["masks"]))
        elif "guided_rows" in inputs:
            logits = apply_vocab_mask(logits, inputs["guided_rows"],
                                      inputs["guided_mask"])
        argmax = torch.argmax(logits, dim=-1).to(torch.int32)
        if need_sampling:
            sampled = sample(
                logits, inputs["temperature"], inputs["top_k"],
                inputs["top_p"], generator, min_p=inputs["min_p"],
                seeds=inputs["seeds"] if seeds is None else seeds,
                counters=inputs["counters"] if counters is None
                else counters)
        else:
            sampled = argmax
        parts = [argmax, sampled]
        if need_topk:
            # Ranked candidates: log-softmax values of the top ids, over
            # the logits the tokens are chosen from, bitcast to int32.
            vals, cand = torch.topk(logits, self.GUIDED_TOPK, dim=-1)
            logp = (vals - torch.logsumexp(logits, dim=-1, keepdim=True))
            parts += [cand.to(torch.int32).reshape(-1),
                      logp.float().contiguous().view(torch.int32)
                      .reshape(-1)]
        if gstates is not None:
            # Advance each grammar state by the token the engine commits
            # (sampled or greedy by the row's temperature); the next step
            # reads it from this vector.
            pool = self._guided_pool
            s_rows = inputs["guided_rows"].clamp(0, logits.shape[0] - 1) \
                .long()
            tok = torch.where(inputs["temperature"][s_rows] > 0,
                              sampled[s_rows], argmax[s_rows])
            parts.append(guided_advance(
                gstates, inputs["gd_slot"], tok, pool["cps"], pool["keys"],
                pool["hi"], pool["nxt"]))
        return torch.cat(parts), rows

    def dispatch(self, step_inputs: StepInputs,
                 generator: torch.Generator, need_topk: bool = False,
                 prev_tokens: Optional[torch.Tensor] = None):
        """Enqueue one step (upload and :meth:`launch`) without reading
        anything back; returns (the packed output vector, the sample
        rows' hidden states), both on the device.  ``prev_tokens`` is the
        previous step's vector when the step passes tokens through.
        Counterpart of the JAX runner's ``dispatch``."""
        arrays = step_inputs.arrays
        return self.launch(
            self.upload(arrays), step_inputs.attn_qb,
            bool(arrays["temperature"].max() > 0), generator, need_topk,
            prev_tokens, arrays["seeds"], arrays["counters"])

    def execute(self, step_inputs: StepInputs,
                generator: torch.Generator, need_topk: bool = False):
        """One synchronous step; returns (argmax, sampled, rows): the
        sample rows' argmax and sampled tokens as host int32 arrays
        [s_pad], and their hidden states (after the final norm, the rows
        that feed ``compute_logits``) [s_pad, hidden], left on the device
        for a drafter; with ``need_topk`` also the top-K ids [s_pad, K]
        and their log-probabilities [s_pad, K] as host arrays."""
        tokens, rows = self.dispatch(step_inputs, generator, need_topk)
        tokens = tokens.cpu().numpy()
        s = step_inputs.s_pad
        if not need_topk:
            return tokens[:s], tokens[s:2 * s], rows
        k = self.GUIDED_TOPK
        topk = tokens[2 * s:2 * s + s * k].reshape(s, k)
        logp = tokens[2 * s + s * k:2 * s + 2 * s * k].reshape(s, k) \
            .view(np.float32)
        return tokens[:s], tokens[s:2 * s], rows, topk, logp

    def prefill_hidden(self, inputs: dict, attn_qb: int) -> torch.Tensor:
        """The forward over uploaded prefill ``inputs`` (:meth:`upload`):
        writes the prompts' K/V into the live cache, in the blocks the
        caller lent them, and returns the hidden rows (after the final
        norm) on the device."""
        inputs = dict(inputs, kv_scale=self.kv_scale)
        attn = self.module.make_attn_impl(attn_qb)
        self.kv, h = self.module.forward(self.params, self.arch, self.kv,
                                         inputs, attn_impl=attn)
        return h

    def _every_row(self, what: str) -> None:
        if self.returns_rows:
            raise NotImplementedError(
                f"{what} needs every row's hidden state; a SwiftKV model's "
                "forward returns only the sample rows")

    @torch.inference_mode()
    def pooled(self, inputs: dict, attn_qb: int, pooling: str = "mean",
               normalize: bool = False) -> torch.Tensor:
        """The pooled embeddings of a prefill over uploaded ``inputs``
        (:meth:`upload`), float32 [rows, hidden] on the device; nothing
        is read back.  ``mean`` sums each request's rows by ``req_idx``
        (padding rows, ``req_idx < 0``, into one extra segment that is
        dropped), ``last`` takes each request's sample row.  The
        forward is :meth:`prefill_hidden`."""
        h = self.prefill_hidden(inputs, attn_qb)
        if pooling not in ("mean", "last"):
            raise ValueError(f"unknown pooling {pooling!r}")
        hf = h.float()
        if self.returns_rows:
            # SwiftKV's forward returns only the sample rows (each
            # request's last prompt token): mean pooling needs every row.
            if pooling == "mean":
                raise NotImplementedError(
                    "mean pooling needs every row's hidden state; a "
                    "SwiftKV model's forward returns only the sample rows "
                    "(use pooling='last')")
            pooled = hf[:self.b_max]
        elif pooling == "mean":
            b = self.b_max
            req_idx = inputs["req_idx"].long()
            seg = torch.where(req_idx < 0, b, req_idx)
            sums = torch.zeros(b + 1, hf.shape[1], dtype=torch.float32,
                               device=hf.device).index_add_(0, seg, hf)
            counts = torch.zeros(b + 1, dtype=torch.float32,
                                 device=hf.device).index_add_(
                0, seg, torch.ones_like(seg, dtype=torch.float32))
            pooled = sums[:b] / counts[:b].clamp_min(1.0)[:, None]
        else:
            pooled = hf[inputs["logits_indices"][:self.b_max].long()]
        if normalize:
            pooled = pooled / torch.linalg.vector_norm(
                pooled, dim=-1, keepdim=True).clamp_min(1e-12)
        return pooled

    def execute_encode(self, step_inputs: StepInputs, pooling: str = "mean",
                       normalize: bool = False) -> np.ndarray:
        """:meth:`pooled` over a prefill step's arrays, as a host float32
        array; row i is the step's i-th request.  Counterpart of the JAX
        runner's ``execute_encode``."""
        return self.pooled(self.upload(step_inputs.arrays),
                           step_inputs.attn_qb, pooling,
                           normalize).cpu().numpy()

    #: Rows of the LM head per chunk of :meth:`execute_score`: float32
    #: logits of a whole prompt at a 128k vocabulary are GBs; 256-row
    #: chunks keep the peak flat.
    SCORE_CHUNK = 256

    @torch.inference_mode()
    def execute_score(self, step_inputs: StepInputs,
                      targets: np.ndarray) -> np.ndarray:
        """Per-row logprob of ``targets`` [t_pad] (the next token at each
        fed row) after a forward over the step's prompt rows, as a host
        float32 array [t_pad]; rows with target < 0 hold values the
        caller ignores.  Counterpart of the JAX runner's
        ``execute_score``."""
        self._every_row("scoring")
        h = self.prefill_hidden(self.upload(step_inputs.arrays),
                                step_inputs.attn_qb)
        tgt = torch.from_numpy(np.asarray(targets, np.int64)).to(h.device)
        out = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
        for a in range(0, h.shape[0], self.SCORE_CHUNK):
            b = min(a + self.SCORE_CHUNK, h.shape[0])
            logits = self.module.compute_logits(self.params, h[a:b])
            t = tgt[a:b].clamp(0, logits.shape[-1] - 1)
            out[a:b] = (logits.gather(1, t[:, None])[:, 0]
                        - torch.logsumexp(logits, dim=-1))
        return out.cpu().numpy()

    @torch.inference_mode()
    def execute_logits(self, step_inputs: StepInputs,
                       rows: int) -> np.ndarray:
        """The LM head's logits of a prefill step's first ``rows`` rows,
        as a host float32 array [rows, vocab]."""
        self._every_row("full logits")
        h = self.prefill_hidden(self.upload(step_inputs.arrays),
                                step_inputs.attn_qb)
        return self.module.compute_logits(
            self.params, h[:rows]).float().cpu().numpy()
