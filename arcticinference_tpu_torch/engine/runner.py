"""Model runner: lowers a SchedulerOutput to padded step arrays, runs the
forward on the device, returns per-request sample rows.

Counterpart of ``arcticinference_tpu/engine/runner.py`` for one device.
:meth:`ModelRunner.prepare_inputs` builds the same host arrays as the JAX
runner (same keys, same bucketed shapes ``t_pad`` / ``s_pad``, same
attention work-item schedule), so the two compare element for element.
Every array then goes to the device in one int32 and one float32 copy.

Weights may be plain or weight-only quantized (``QuantizedLinear``
leaves: fp8, int8, int4).  Not ported yet (they raise
``NotImplementedError``): meshes (tp / sp / dp / pp), token-tree drafts,
guided decoding and penalties.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.scheduler import SchedulerOutput
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    build_work_items)
from arcticinference_tpu_torch.ops.kv_cache import (KVCacheSpec,
                                                    allocate_kv_cache)
from arcticinference_tpu_torch.ops.sampling import sample
from arcticinference_tpu_torch.utils import (cdiv, default_token_buckets,
                                             device_memory_bytes,
                                             pad_to_bucket)

_F32_KEYS = ("temperature", "top_p", "min_p", "rep_pen", "pres_pen",
             "freq_pen")


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


class ModelRunner:

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
        self.params = module.fuse_params(params)

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

    def _auto_num_blocks(self, kv_dtype: torch.dtype) -> int:
        """Size the cache from the device's memory, less the weights (a
        quantized weight's values and scales) and a 1 GiB reserve for
        activations."""
        param_bytes = sum(
            x.nbytes
            for x in (*self.params["layers"].values(),
                      *(v for k, v in self.params.items() if k != "layers")))
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

    def prepare_inputs(self, sched_out: SchedulerOutput) -> StepInputs:
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

        t = 0
        for r, s in enumerate(scheduled):
            req = s.request
            if s.spec_parents is not None:
                raise NotImplementedError("token-tree drafts are not ported")
            n = s.num_new_tokens
            ctx = req.num_computed_tokens
            toks = (req.all_token_ids + s.spec_token_ids)[ctx:ctx + n]
            assert len(toks) == n, (len(toks), n, ctx)
            input_ids[t:t + n] = toks
            positions[t:t + n] = np.arange(ctx, ctx + n)
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

        # Sampling params per row.  The penalty rows stay neutral: a
        # request asking for penalties is refused by the engine.
        temperature = np.zeros(s_pad, np.float32)
        top_k = np.zeros(s_pad, np.int32)
        top_p = np.ones(s_pad, np.float32)
        min_p = np.zeros(s_pad, np.float32)
        seeds = np.full(s_pad, -1, np.int32)
        counters = np.zeros(s_pad, np.int32)
        for r, s in enumerate(scheduled):
            req = s.request
            sp = req.sampling
            if sp.guided is not None or sp.needs_penalties:
                raise NotImplementedError(
                    "guided decoding and penalties are not ported")
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

        # attn_qb == 1 marks a pure-decode step (one frontier row per
        # request, token order == request order): the model routes it to
        # the grouped decode kernel.  The work-item schedule is still
        # built (at qb=8), as in the JAX runner.
        max_qlen = int(query_lens.max(initial=1))
        pure_decode = max_qlen == 1 and bool(scheduled)
        attn_qb = 1 if pure_decode else (8 if max_qlen <= 8 else 32)
        sched_qb = 8 if attn_qb == 1 else attn_qb
        (item_req, item_qstart, item_qlen, item_pages, item_pos_base,
         token_item, token_off) = build_work_items(
            query_lens, last_pos, sched_qb, self.block_size,
            t_pad // sched_qb + b, t_pad)

        arrays = dict(
            input_ids=input_ids, input_src=input_src,
            positions=positions, req_idx=req_idx,
            slot_mapping=slot_mapping, block_tables=block_tables,
            seq_lens=seq_lens, logits_indices=logits_indices,
            temperature=temperature, top_k=top_k, top_p=top_p,
            min_p=min_p, seeds=seeds, counters=counters,
            rep_pen=np.ones(s_pad, np.float32),
            pres_pen=np.zeros(s_pad, np.float32),
            freq_pen=np.zeros(s_pad, np.float32),
            attn_item_req=item_req, attn_item_qstart=item_qstart,
            attn_item_qlen=item_qlen, attn_item_pages=item_pages,
            attn_item_pos_base=item_pos_base, attn_token_item=token_item,
            attn_token_off=token_off,
        )
        return StepInputs(arrays=arrays, t_pad=t_pad, s_pad=s_pad,
                          attn_qb=attn_qb, sample_row_start=row_start,
                          sample_row_count=row_count, total_tokens=total)

    # ------------------------------------------------------------------ #
    # Device step
    # ------------------------------------------------------------------ #

    def upload(self, arrays: dict[str, np.ndarray]) -> dict:
        """All step arrays on the device, in one int32 and one float32
        host-to-device copy (views into the two buffers)."""
        out = {}
        for dtype, keys in (
                (np.float32, [k for k in arrays if k in _F32_KEYS]),
                (np.int32, [k for k in arrays if k not in _F32_KEYS])):
            flat = np.concatenate([arrays[k].ravel() for k in keys])
            buf = torch.from_numpy(flat.astype(dtype, copy=False)).to(
                self.device)
            off = 0
            for k in keys:
                n = arrays[k].size
                out[k] = buf[off:off + n].view(arrays[k].shape)
                off += n
        return out

    @torch.inference_mode()
    def execute(self, step_inputs: StepInputs,
                generator: torch.Generator):
        """One synchronous step; returns (argmax, sampled) as host int32
        arrays [s_pad]."""
        inputs = self.upload(step_inputs.arrays)
        inputs["kv_scale"] = self.kv_scale
        attn = self.module.make_attn_impl(step_inputs.attn_qb)
        self.kv, h = self.module.forward(self.params, self.arch, self.kv,
                                         inputs, attn_impl=attn)
        rows = h[inputs["logits_indices"].long()]
        logits = self.module.compute_logits(self.params, rows)
        argmax = torch.argmax(logits, dim=-1).to(torch.int32)
        if step_inputs.arrays["temperature"].max() > 0:
            sampled = sample(logits, inputs["temperature"], inputs["top_k"],
                             inputs["top_p"], generator,
                             min_p=inputs["min_p"], seeds=inputs["seeds"],
                             counters=inputs["counters"])
        else:
            sampled = argmax
        return argmax.cpu().numpy(), sampled.cpu().numpy()
