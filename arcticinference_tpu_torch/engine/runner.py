"""Model runner: lowers a SchedulerOutput to padded step arrays, runs the
forward on the device, returns per-request sample rows.

Counterpart of ``arcticinference_tpu/engine/runner.py``.
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
states itself (``RETURNS_SAMPLE_ROWS``).

On a mesh (``tensor_parallel_size`` / ``ulysses_sequence_parallel_size``
> 1; ``parallel/``) every rank builds the same step arrays and runs its
part of the forward: :meth:`ModelRunner._choose_mode` picks the Ulysses
program (``"sp"``) or, at or under ``shift_parallel_threshold`` tokens
with ``enable_shift_parallel``, the full-TP shift program (``"shift"``)
for each step; both read and write the same cache pages.  The rank holds
its tp piece of the weights (fused with the interleave the shift re-slice
needs), its ``Hkv/(sp*tp)`` cache heads and its column piece of the LM
head, whose logits are gathered over tp, so every rank samples the same
tokens from the same logits.  SwiftKV (its later layers in the shift
layout), Mixtral (expert parallelism) and token trees run there too.

In-engine data parallelism (``data_parallel_size`` > 1): the scheduler
keeps one block space a dp group, and :meth:`ModelRunner.prepare_inputs`
lays the step out dp-major as the JAX runner's ``_prepare_inputs_dp``
does (each group's tokens in its own ``T / dp`` window, per-group block
tables, lengths and schedules stacked ``[dp, ...]``); every rank builds
those arrays, uploads its own group's slice (:meth:`ModelRunner.upload`)
and runs it on its group's cache, whose ``num_blocks / dp`` blocks the
group's shard-local block ids address; the group's hidden rows are then
gathered over dp, so the LM head, sampling, penalties and guided masks
run on the whole batch on every rank, as the JAX step runs them on the
global array.  Pipeline parallelism (``pipeline_parallel_size`` > 1,
``parallel/pp.py``): a stage holds its ``L / pp`` layers and their
pages; every step goes through the ragged kernel over per-microbatch
schedules (the ``pp``-prefixed keys), in the ``"pp"`` program or, at or
under the shift threshold, the ``"pp_shift"`` one.  Refused as in JAX
(:func:`check_mesh`): token trees with dp, a model without
``scan_layers`` under pp (SwiftKV), layers or token buckets that do not
divide by the pipeline; also int4, and experts that do not divide by
the expert-parallel degree.

A served mesh (``parallel/multihost.py``) runs the engine on the leader
alone: with ``mh_channel`` attached, :meth:`ModelRunner.dispatch`
broadcasts each step's host inputs before it uploads them, and each
follower replays it (``_mirror=True``).  The grammar pool is per-process
device state that no follower uploads, so guided rows take the host-mask
route there (:attr:`ModelRunner.guided_device_ok`), and the entries no
follower mirrors (scoring, full logits, causal encode) refuse
(:meth:`ModelRunner.check_unmirrored`).
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
from arcticinference_tpu_torch.parallel import mesh as mesh_lib
from arcticinference_tpu_torch.parallel import pp as pp_lib
from arcticinference_tpu_torch.parallel.ulysses import (all_gather_cat,
                                                        check_supported,
                                                        make_dp_forward,
                                                        make_sharded_forward)
from arcticinference_tpu_torch.utils import (cdiv, default_token_buckets,
                                             device_memory_bytes,
                                             pad_to_bucket)

_F32_KEYS = ("temperature", "top_p", "min_p", "rep_pen", "pres_pen",
             "freq_pen")

#: The work-item schedule's seven arrays (the JAX ``_ATTN_SCHED_KEYS``).
_ATTN_SCHED_KEYS = pp_lib.SCHEDULE_KEYS[:7]
_SWIFT_KEYS = ("item_req", "item_qstart", "item_qlen", "item_pages",
               "item_pos_base", "token_item", "token_off")

#: Arrays that the dp layout stacks per dp group (``[dp, ...]``; the JAX
#: ``DP_KEYS`` and, under pp, the ``pp``-prefixed schedules): a rank
#: keeps its group's row of each.
DP_KEYS = (("positions", "req_idx", "slot_mapping", "seq_lens",
            "block_tables") + _ATTN_SCHED_KEYS + ("logits_indices_dp",)
           + tuple(f"swift_{k}" for k in _SWIFT_KEYS)
           + tuple("pp" + k for k in pp_lib.SCHEDULE_KEYS))


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


def check_mesh(config: EngineConfig, module, arch) -> None:
    """Refuse what does not run on a mesh, before any weight is loaded,
    as the JAX package refuses it; each refusal names its cause."""
    pcfg = config.parallel
    spec = config.speculative
    if spec is not None and spec.use_tree_spec and \
            pcfg.data_parallel_size > 1:
        raise NotImplementedError(
            "token-tree speculation does not run with data parallelism "
            "(data_parallel_size > 1): the dp-major row layout does not "
            "carry tree schedules, as in the JAX package")
    if pcfg.pipeline_parallel_size > 1:
        pp_lib.check_supported(module, arch, pcfg, default_token_buckets(
            config.scheduler.max_num_batched_tokens))
    if config.model.quantization == "int4":
        # Split-half packing couples row u with row u + K/2 in one byte,
        # so the packed in axis cannot be cut or re-sliced (as in JAX).
        raise NotImplementedError(
            "int4 weight quantization is single-chip; use fp8/int8 on "
            "meshes")
    check_supported(arch, pcfg)


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
                 device: torch.device, mesh=None):
        """A parallel config of world size > 1 needs ``mesh``
        (``parallel.mesh.build_mesh``; :class:`LLMEngine` makes it after
        :func:`check_mesh`) and this rank's cut of the params
        (``load_model(..., mesh=)``)."""
        pcfg = config.parallel
        if pcfg.world_size > 1 and mesh is None:
            raise ValueError(
                f"a parallel config of world size {pcfg.world_size} needs "
                "its mesh (parallel.mesh.build_mesh) and this rank's params")
        self.config = config
        self.module = module
        self.arch = arch
        self.device = device
        # Per-layer [k_scale, v_scale] fp8-KV dequant pairs ride the
        # checkpoint's parameters; they are runner state, not weights.
        loaded_kv_scales = params.pop("kv_scales", None)
        self.mesh = mesh
        # Fused q|k|v and gate|up, as the JAX runner: on a mesh the
        # segments interleave per fused piece (tp * sp when shift is on),
        # so the tp cut and the shift re-slice each hold whole
        # [q_f|k_f|v_f] groups; a rank fuses its tp piece with the
        # interleave left over.  Gated to whole heads and columns per
        # piece, which keeps the kv-replication case unfused (interleave
        # None).  A module without fuse_params (Mixtral) runs its weights
        # as they are.  SwiftKV's later layers take the shift layout
        # first, in every mode (``llama_swiftkv.mesh_layout``), and its
        # fuse_params fuses them whatever the gate says.
        layout = getattr(module, "mesh_layout", None)
        if mesh is not None and layout is not None:
            params = layout(params, arch, mesh)
        fuse = getattr(module, "fuse_params", None)
        if fuse is not None:
            tp = pcfg.tensor_parallel_size
            fuse_w = tp * (pcfg.ulysses_sequence_parallel_size
                           if pcfg.enable_shift_parallel else 1)
            whole = (arch.num_heads % fuse_w == 0
                     and arch.num_kv_heads % fuse_w == 0
                     and arch.intermediate_size % fuse_w == 0)
            params = fuse(params, interleave=fuse_w // tp if whole else None)
        self.params = params
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
        # A rank's cache holds its heads of the fused (tp, sp) cut, its
        # stage's layers and its dp group's blocks.
        self.dp = pcfg.data_parallel_size
        self.pp = pcfg.pipeline_parallel_size
        self.cache_kv_heads = arch.num_kv_heads
        self.stage_layers = range(arch.num_layers)
        if self.mesh is not None:
            self.cache_kv_heads = mesh_lib.kv_cache_heads(
                arch.num_kv_heads, self.mesh)[0]
            self.stage_layers = self.mesh.stage_layers(arch.num_layers)
        num_blocks = cache_cfg.num_blocks or self._auto_num_blocks(kv_dtype)
        # In-engine dp: the block axis is cut over dp, and block ids are
        # shard-local (each group owns a private block space).
        self.num_blocks = num_blocks - num_blocks % self.dp
        self.num_blocks_per_shard = self.num_blocks // self.dp
        self.kv_spec = KVCacheSpec(
            num_layers=len(self.stage_layers),
            num_blocks=self.num_blocks_per_shard,
            num_kv_heads=self.cache_kv_heads, block_size=self.block_size,
            head_dim=arch.head_dim, dtype=kv_dtype)
        self.kv = allocate_kv_cache(self.kv_spec, device)
        if loaded_kv_scales is not None and kv_dtype == torch.float8_e4m3fn:
            kv_scale = torch.as_tensor(loaded_kv_scales, dtype=torch.float32)
        else:
            kv_scale = torch.ones((arch.num_layers, 2), dtype=torch.float32)
        lo, hi = self.stage_layers.start, self.stage_layers.stop
        self.kv_scale = kv_scale[lo:hi].contiguous().to(device)

        self.b_max = config.scheduler.max_num_seqs
        self.token_buckets = default_token_buckets(
            config.scheduler.max_num_batched_tokens)
        self.sample_buckets = default_token_buckets(
            max(16, config.scheduler.max_num_batched_tokens))
        sp = pcfg.ulysses_sequence_parallel_size
        if self.mesh is not None and any(b % sp for b in self.token_buckets):
            raise ValueError(
                f"token buckets {self.token_buckets} must divide by sp={sp} "
                "(SP mode cuts a step's tokens into sp chunks); use a "
                "power-of-two max_num_batched_tokens")
        # Allocated at the first guided request on the pipelined step
        # (131 MB of masks at a 128k vocabulary).
        self._guided_pool: Optional[dict] = None
        # The forward of each (attn_qb, decode_qlen, allow_deferral,
        # mode), and the forwards run by mode.
        self._step_fns: dict = {}
        self.mode_steps: dict[str, int] = {}
        # The shift program's re-sliced layer weights, one copy shared by
        # its forwards.
        self._resliced: dict = {}
        # The LM head is cut over tp (its column piece) unless its vocab
        # does not divide, or it is the tied, whole embedding.
        head = self.params.get("lm_head")
        self._gather_logits = (
            self.mesh is not None and head is not None
            and head.shape[-1] != arch.vocab_size)
        # A served mesh's leader broadcasts each step over this channel
        # (parallel/multihost.py LeaderChannel) before it runs it.
        self.mh_channel = None
        #: steps dispatched (the leader's and a follower's replays alike).
        self.dispatches = 0
        #: a running digest of every output vector and fused telemetry
        #: block, on the device (None: off; set a zero int64 tensor to
        #: start one); ranks that ran the same steps hold the same value.
        self.digest: Optional[torch.Tensor] = None

    @property
    def is_multihost(self) -> bool:
        """Whether followers mirror this runner's steps (a served mesh's
        leader, its channel attached)."""
        return self.mh_channel is not None

    @property
    def guided_device_ok(self) -> bool:
        """Whether guided rows may use the device grammar pool: not on a
        served mesh, whose followers hold no pool (the host-mask route's
        masks ride the broadcast arrays), as the JAX runner keeps it."""
        return not self.is_multihost

    def check_unmirrored(self, what: str) -> None:
        """Refuse device work that no follower mirrors on a served mesh
        (its collectives would wait for ranks that never join them)."""
        if self.is_multihost:
            raise NotImplementedError(
                f"{what} on a served mesh: the followers mirror only the "
                "engine's steps (dispatch, the fused loop, the drafter), "
                "so this device work would wait on them for ever; run it "
                "through LLM on every rank of the mesh")

    def fold_digest(self, x: torch.Tensor) -> None:
        """Fold the int32 tensor ``x`` into :attr:`digest` (when on),
        on the device: a polynomial hash mod 2^31 - 1, no host read."""
        if self.digest is None:
            return
        v = x.reshape(-1).long() % 65521
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64,
                         device=v.device)
        self.digest = (self.digest * 1000003 + (v * w).sum()) % 2147483647

    def _auto_num_blocks(self, kv_dtype: torch.dtype) -> int:
        """Size the cache from the device's memory, less the weights (a
        quantized weight's values and scales) and a 1 GiB reserve for
        activations.  On a mesh this is one rank a device (ranks sharing
        a card set ``num_blocks``), and every rank takes the smallest
        count of the mesh, so the block managers stay in lockstep; a
        rank holds its stage's layers and ``1 / dp`` of the blocks."""
        param_bytes = _nbytes(self.params)
        budget = (int(device_memory_bytes(self.device)
                      * self.config.cache.hbm_utilization)
                  - param_bytes - (1 << 30))
        spec = KVCacheSpec(
            num_layers=len(self.stage_layers), num_blocks=1,
            num_kv_heads=self.cache_kv_heads,
            block_size=self.block_size, head_dim=self.arch.head_dim,
            dtype=kv_dtype)
        n = int(min(max(budget // spec.bytes_per_block, 16) * self.dp,
                    1 << 17))
        if self.mesh is not None:
            t = torch.tensor([n], dtype=torch.int64, device=self.device)
            torch.distributed.all_reduce(
                t, op=torch.distributed.ReduceOp.MIN, group=self.mesh.group)
            n = int(t.item())
        return n

    # ------------------------------------------------------------------ #
    # The forward on one device or one rank of a mesh
    # ------------------------------------------------------------------ #

    def _choose_mode(self, total_tokens: int) -> str:
        """Shift parallelism: the full-TP program for steps of at most
        ``shift_parallel_threshold`` tokens, the Ulysses program for
        larger ones (the JAX runner's rule); ``"single"`` off a mesh, and
        a mesh without sp runs the SP program, which with sp = 1 is plain
        TP.  Under pp the pipelined programs: ``"pp"`` (SP mode in each
        stage) or ``"pp_shift"``."""
        if self.mesh is None:
            return "single"
        pcfg = self.config.parallel
        if pcfg.pipeline_parallel_size > 1:
            if (pcfg.ulysses_sequence_parallel_size > 1
                    and pcfg.enable_shift_parallel
                    and total_tokens <= pcfg.shift_parallel_threshold):
                return "pp_shift"
            return "pp"
        if pcfg.ulysses_sequence_parallel_size <= 1:
            return "sp"
        if pcfg.enable_shift_parallel and \
                total_tokens <= pcfg.shift_parallel_threshold:
            return "shift"
        return "sp"

    def _forward_fn(self, attn_qb: int, mode: str, decode_qlen: int = 1,
                    allow_deferral: bool = True):
        attn = self.module.make_attn_impl(attn_qb, decode_qlen=decode_qlen)
        if mode == "single":
            module, arch = self.module, self.arch

            def fwd(params, kv, inputs):
                return module.forward(params, arch, kv, inputs,
                                      attn_impl=attn,
                                      allow_deferral=allow_deferral)
            return fwd
        if mode in ("pp", "pp_shift"):
            fwd = pp_lib.make_pp_forward(
                self.module, self.arch, self.mesh,
                "shift" if mode == "pp_shift" else "sp", attn_impl=attn,
                reslice_cache=self._resliced)
        else:
            fwd = make_sharded_forward(self.module, self.arch, self.mesh,
                                       mode, attn_impl=attn,
                                       reslice_cache=self._resliced)
        return make_dp_forward(fwd, self.mesh) if self.dp > 1 else fwd

    def forward(self, inputs: dict, attn_qb: int, decode_qlen: int = 1,
                total_tokens: Optional[int] = None,
                allow_deferral: bool = True) -> torch.Tensor:
        """The model over uploaded ``inputs``, in place on the cache;
        returns the hidden rows [T, hidden] (after the final norm), the
        same on every rank of a mesh.  ``total_tokens`` (default: the
        rows) picks the mesh's mode."""
        if total_tokens is None:
            total_tokens = int(inputs["input_ids"].shape[0])
        mode = self._choose_mode(total_tokens)
        key = (attn_qb, decode_qlen, allow_deferral, mode)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = self._step_fns[key] = self._forward_fn(
                attn_qb, mode, decode_qlen, allow_deferral)
        self.mode_steps[mode] = self.mode_steps.get(mode, 0) + 1
        self.kv, h = fn(self.params, self.kv, inputs)
        return h

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary's logits from this rank's column piece of
        the tp-cut LM head (gathered over tp)."""
        return all_gather_cat(logits, self.mesh.tp_group, dim=-1)

    def logits(self, rows: torch.Tensor) -> torch.Tensor:
        """float32 logits of hidden ``rows``; on a mesh the LM head's
        column pieces are gathered over tp, so every rank holds the whole
        vocabulary, bit for bit the same."""
        logits = self.module.compute_logits(self.params, rows)
        if self._gather_logits:
            logits = self.gather_logits(logits)
        return logits

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
        grammar-state segment), or is -1 to seed from the init state.
        With dp the step takes the dp layout (:meth:`_prepare_inputs_dp`);
        under pp it also carries one work-item schedule per microbatch
        (:meth:`_pp_schedules`)."""
        if self.dp > 1:
            return self._prepare_inputs_dp(sched_out, passthrough,
                                           guided_dev)
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

        arrays = dict(
            input_ids=input_ids, input_src=input_src,
            positions=positions, req_idx=req_idx,
            slot_mapping=slot_mapping, block_tables=block_tables,
            seq_lens=seq_lens, logits_indices=logits_indices)
        any_penalties = self._sampling_arrays(arrays, scheduled, s_pad,
                                              row_start, row_count)
        guided_entries, dev_entries = self._guided_entries(
            scheduled, row_start, row_count, guided_dev)

        # attn_qb == 1 marks a pure-decode step (one frontier row per
        # request, token order == request order): the model routes it to
        # the grouped decode kernel.  The work-item schedule is still
        # built (at qb=8), as in the JAX runner.  A step with tree rows
        # never is one: the ancestor masks ride the work items; nor is a
        # pipelined step (its microbatches' schedules).
        max_qlen = int(query_lens.max(initial=1))
        pure_decode = (max_qlen == 1 and bool(scheduled)
                       and row_tree_mask is None and self.pp == 1)
        attn_qb = 1 if pure_decode else (8 if max_qlen <= 8 else 32)
        sched_qb = 8 if attn_qb == 1 else attn_qb
        sched = build_work_items(query_lens, last_pos, sched_qb,
                                 self.block_size, t_pad // sched_qb + b,
                                 t_pad)
        arrays.update(zip(_ATTN_SCHED_KEYS, sched))
        if row_tree_mask is not None:
            it_ts, it_mask = tree_work_items(row_tree_mask, tree_start,
                                             sched[0], sched[5], sched[6],
                                             attn_qb)
            arrays.update(
                attn_tree_start=tree_start,
                attn_row_tree_mask=row_tree_mask,
                attn_item_tree_start=it_ts,
                attn_item_tree_mask=it_mask)
        guided_index, gstate_count = self._guided_arrays(
            arrays, guided_entries, dev_entries)
        if any_penalties:
            self._penalty_arrays(arrays, scheduled, s_pad, row_start,
                                 row_count)
        if self.swift:
            arrays.update(swift_schedule(row_count, last_pos, s_pad,
                                         self.block_size))
        if self.pp > 1:
            arrays.update(self._pp_schedules(
                query_lens, last_pos, len(scheduled), t_pad, attn_qb,
                row_tree_mask, tree_start))
        return StepInputs(arrays=arrays, t_pad=t_pad, s_pad=s_pad,
                          attn_qb=attn_qb, sample_row_start=row_start,
                          sample_row_count=row_count, total_tokens=total,
                          guided_index=guided_index,
                          gstate_count=gstate_count)

    def _sampling_arrays(self, arrays: dict, scheduled, s_pad: int,
                         row_start, row_count) -> bool:
        """The per-sample-row sampling parameters (every verify row of a
        request carries its request's) into ``arrays``; returns whether
        a request asks for penalties."""
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
        arrays.update(temperature=temperature, top_k=top_k, top_p=top_p,
                      min_p=min_p, seeds=seeds, counters=counters,
                      rep_pen=rep_pen, pres_pen=pres_pen,
                      freq_pen=freq_pen)
        return any_penalties

    @staticmethod
    def _guided_entries(scheduled, row_start, row_count, guided_dev):
        """Grammar-guided vocab bitmasks (DFA-backed decoders) for the
        row that commits a token: (host-mask entries ``(row, mask)``,
        device-pool entries ``(row, slot, src, init, req_id)``), the
        host's mask of the automaton's state or (pipelined) the device
        pool's row of a state that rides the output vector."""
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
        return guided_entries, dev_entries

    def _guided_arrays(self, arrays: dict, guided_entries, dev_entries):
        """The guided rows' arrays into ``arrays``, padded to a bucket;
        returns (req_id -> device-pool entry index or None, the grammar
        state segment's length)."""
        b = self.b_max
        g_buckets = [g for g in (1, 2, 4, 8, 16, 32, 64, 128)
                     if g <= max(b, 1)] + [b]
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
            return None, 0
        if not dev_entries:
            return None, 0
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
        return guided_index, g_pad

    def _penalty_arrays(self, arrays: dict, scheduled, s_pad: int,
                        row_start, row_count) -> None:
        """Token histories of the requests asking for penalties, -1
        padded to a bucketed length; every verify row of a request
        carries its history before this step (as in the JAX runner)."""
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

    def _pp_schedules(self, query_lens, last_pos, n_reqs: int, t_pad: int,
                      attn_qb: int, row_tree_mask=None,
                      tree_start=None) -> dict[str, np.ndarray]:
        """The per-microbatch work items of a pipelined step (the JAX
        runner's ``pp``-prefixed arrays, stacked ``[pp, ...]``): the
        flat batch split into pp contiguous windows of ``t_pad / pp``
        rows, each request's query clipped to each window.  A step with
        token trees also gets each microbatch's item tree arrays, so the
        ragged kernel masks its tree rows as on one device."""
        pp = self.pp
        b = self.b_max
        tm = t_pad // pp
        n_items = tm // attn_qb + b
        starts = np.zeros(b, np.int64)
        if n_reqs:   # an empty group has no lengths to sum
            starts[1:n_reqs] = np.cumsum(query_lens[:n_reqs - 1])
        parts, trees = [], []
        for mi in range(pp):
            lo, hi = mi * tm, (mi + 1) * tm
            ql = np.zeros(b, np.int64)
            lpos = np.zeros(b, np.int64)
            for r in range(n_reqs):
                a = max(int(starts[r]), lo)
                z = min(int(starts[r] + query_lens[r]), hi)
                if z > a:
                    ql[r] = z - a
                    lpos[r] = last_pos[r] - (starts[r] + query_lens[r] - z)
            part = build_work_items(ql, lpos, attn_qb, self.block_size,
                                    n_items, tm)
            parts.append(part)
            if row_tree_mask is not None:
                trees.append(tree_work_items(
                    row_tree_mask[lo:hi], tree_start, part[0], part[5],
                    part[6], attn_qb))
        out = {"pp" + key: np.stack([p[i] for p in parts])
               for i, key in enumerate(_ATTN_SCHED_KEYS)}
        if trees:
            out["ppattn_item_tree_start"] = np.stack([t[0] for t in trees])
            out["ppattn_item_tree_mask"] = np.stack([t[1] for t in trees])
        return out

    def _prepare_inputs_dp(self, sched_out: SchedulerOutput,
                           passthrough: Optional[dict] = None,
                           guided_dev: Optional[dict] = None
                           ) -> StepInputs:
        """The in-engine dp layout, array for array the JAX runner's
        ``_prepare_inputs_dp``: the token axis is dp-major (each group's
        requests packed into its own ``t_shard`` window), and the
        per-token and per-request arrays (positions, block tables, seq
        lens, the attention schedule; SwiftKV's local sample-row indices
        and second schedule; under pp the per-microbatch schedules) are
        stacked with a leading ``[dp]`` axis (:data:`DP_KEYS`).  Sample
        rows, sampling parameters, penalties and guided rows index the
        dp-major rows of the whole step (with SwiftKV: its per-group
        sample rows, dp-major), which every rank holds after the
        forward's gather over dp."""
        scheduled = sched_out.scheduled
        dp = self.dp
        b = self.b_max
        groups: list[list] = [[] for _ in range(dp)]
        for s in scheduled:
            groups[s.request.dp_shard].append(s)
        shard_tok = [sum(s.num_new_tokens for s in g) for g in groups]
        t_shard = pad_to_bucket(max(max(shard_tok), 1), self.token_buckets)
        t_pad = t_shard * dp

        input_ids = np.zeros(t_pad, np.int32)
        input_src = np.full(t_pad, -1, np.int32)
        positions_flat = np.zeros(t_pad, np.int32)
        positions = np.zeros((dp, t_shard), np.int32)
        req_idx = np.full((dp, t_shard), -1, np.int32)
        slot_mapping = np.full((dp, t_shard), -1, np.int32)
        block_tables = np.zeros((dp, b, self.max_blocks_per_req), np.int32)
        seq_lens = np.zeros((dp, b), np.int32)
        query_lens = np.zeros((dp, b), np.int64)
        last_pos = np.zeros((dp, b), np.int64)

        sample_rows: list[int] = []
        row_start: list[int] = []
        row_count: list[int] = []
        t_cur = [0] * dp
        r_cur = [0] * dp
        s_cnt = [0] * dp          # SwiftKV: sample rows per group so far
        recs: list[tuple] = []    # SwiftKV: (group, ts, n, k, local off)
        for s in scheduled:
            req = s.request
            sh = req.dp_shard
            n = s.num_new_tokens
            ctx = req.num_computed_tokens
            r = r_cur[sh]
            r_cur[sh] += 1
            ts = t_cur[sh]
            t0 = sh * t_shard + ts
            toks = (req.all_token_ids + s.spec_token_ids)[ctx:ctx + n]
            assert len(toks) == n, (len(toks), n, ctx)
            if passthrough and req.req_id in passthrough:
                input_src[t0] = passthrough[req.req_id]
                toks = [0] + list(toks[1:])
            input_ids[t0:t0 + n] = toks
            positions_flat[t0:t0 + n] = np.arange(ctx, ctx + n)
            positions[sh, ts:ts + n] = np.arange(ctx, ctx + n)
            req_idx[sh, ts:ts + n] = r
            bt = req.block_ids
            block_tables[sh, r, :len(bt)] = bt
            for i in range(n):
                pos = ctx + i
                slot_mapping[sh, ts + i] = (bt[pos // self.block_size]
                                            * self.block_size
                                            + pos % self.block_size)
            seq_lens[sh, r] = ctx + n
            query_lens[sh, r] = n
            last_pos[sh, r] = ctx + n - 1
            k = len(s.spec_token_ids) + 1
            if self.swift:
                recs.append((sh, ts, n, k, s_cnt[sh]))
                s_cnt[sh] += k
            else:
                row_start.append(len(sample_rows))
                row_count.append(k)
                sample_rows.extend(range(t0 + n - k, t0 + n))
            t_cur[sh] += n

        if self.swift:
            # The sample rows are gathered inside each group's forward, so
            # the rows come out dp-major with per-group padding.
            s_sh = pad_to_bucket(max(max(s_cnt), 1), self.sample_buckets)
            s_pad = s_sh * dp
            li_dp = np.zeros((dp, s_sh), np.int32)
            logits_indices = np.zeros(s_pad, np.int32)
            for (sh, ts, n, k, off) in recs:
                row_start.append(sh * s_sh + off)
                row_count.append(k)
                loc = np.arange(ts + n - k, ts + n, dtype=np.int32)
                li_dp[sh, off:off + k] = loc
                logits_indices[sh * s_sh + off:sh * s_sh + off + k] = \
                    sh * t_shard + loc
        else:
            s_pad = pad_to_bucket(max(len(sample_rows), 1),
                                  self.sample_buckets)
            logits_indices = np.zeros(s_pad, np.int32)
            logits_indices[:len(sample_rows)] = sample_rows

        arrays = dict(input_ids=input_ids, input_src=input_src,
                      positions_flat=positions_flat, positions=positions,
                      req_idx=req_idx, slot_mapping=slot_mapping,
                      block_tables=block_tables, seq_lens=seq_lens,
                      logits_indices=logits_indices)
        any_penalties = self._sampling_arrays(arrays, scheduled, s_pad,
                                              row_start, row_count)
        guided_entries, dev_entries = self._guided_entries(
            scheduled, row_start, row_count, guided_dev)

        # The same grouped-decode rule as one device's, per group.
        max_qlen = int(query_lens.max(initial=1))
        pure_decode = max_qlen == 1 and bool(scheduled) and self.pp == 1
        attn_qb = 1 if pure_decode else (8 if max_qlen <= 8 else 32)
        sched_qb = 8 if attn_qb == 1 else attn_qb
        n_items = t_shard // sched_qb + b
        parts = [build_work_items(query_lens[sh], last_pos[sh], sched_qb,
                                  self.block_size, n_items, t_shard)
                 for sh in range(dp)]
        for i, key in enumerate(_ATTN_SCHED_KEYS):
            arrays[key] = np.stack([p[i] for p in parts])
        guided_index, gstate_count = self._guided_arrays(
            arrays, guided_entries, dev_entries)
        if self.swift:
            arrays["logits_indices_dp"] = li_dp
            sw = []
            for sh in range(dp):
                srow = [len(s.spec_token_ids) + 1 for s in groups[sh]]
                sw.append(swift_schedule(srow, last_pos[sh], s_sh,
                                         self.block_size))
            for key in sw[0]:
                arrays[key] = np.stack([p[key] for p in sw])
        if any_penalties:
            self._penalty_arrays(arrays, scheduled, s_pad, row_start,
                                 row_count)
        if self.pp > 1:
            # dp x pp: each group's window is split into pp microbatches.
            pp_parts = [self._pp_schedules(query_lens[sh], last_pos[sh],
                                           len(groups[sh]), t_shard,
                                           attn_qb)
                        for sh in range(dp)]
            for key in pp_parts[0]:
                arrays[key] = np.stack([p[key] for p in pp_parts])
        return StepInputs(arrays=arrays, t_pad=t_pad, s_pad=s_pad,
                          attn_qb=attn_qb, sample_row_start=row_start,
                          sample_row_count=row_count,
                          total_tokens=sum(shard_tok),
                          guided_index=guided_index,
                          gstate_count=gstate_count)

    def dp_local(self, arrays: dict) -> dict:
        """This rank's dp group's slice of a dp-layout step (its row of
        each :data:`DP_KEYS` array, its window of the token rows; with
        SwiftKV its local sample-row indices as ``logits_indices``); the
        sample-row arrays stay whole.  Other steps as they are."""
        if "positions_flat" not in arrays:
            return arrays
        g = self.mesh.dp_rank
        t_shard = arrays["positions"].shape[1]
        out = {k: v for k, v in arrays.items() if k != "positions_flat"}
        for k in DP_KEYS:
            if k in arrays:
                out[k] = arrays[k][g]
        for k in ("input_ids", "input_src"):
            out[k] = arrays[k][g * t_shard:(g + 1) * t_shard]
        if "logits_indices_dp" in out:
            out["logits_indices"] = out.pop("logits_indices_dp")
        return out

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
        device.  A dp-layout step uploads this rank's group's slice
        (:meth:`dp_local`)."""
        if self.dp > 1:
            arrays = self.dp_local(arrays)
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
               counters=None, total_tokens: Optional[int] = None):
        """The step's device work on uploaded ``inputs`` (see
        :meth:`upload`): passthrough tokens (and grammar states) from
        ``prev_tokens``, the previous step's output vector; forward,
        logits of the sample rows, penalties (when the step carries token
        histories), guided masks, argmax and, with ``need_sampling``,
        sampling (``seeds`` / ``counters``: the host's arrays, by default
        the uploaded ones, which only a CPU step can read;
        ``total_tokens``: the step's real tokens, which pick a mesh's
        mode).  Returns the packed int32 output vector (module docstring)
        and the sample rows' hidden states [s_pad, hidden]; nothing here
        reads the device back, so a timing loop or a CUDA graph can
        replay it."""
        inputs = dict(inputs, kv_scale=self.kv_scale)
        if prev_tokens is not None:
            src = inputs["input_src"]
            inputs["input_ids"] = torch.where(
                src >= 0,
                prev_tokens[src.clamp(0, prev_tokens.shape[0] - 1).long()],
                inputs["input_ids"])
        h = self.forward(inputs, attn_qb, total_tokens=total_tokens)
        rows = (h if self.returns_rows
                else h[inputs["logits_indices"].long()])
        logits = self.logits(rows)
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
                 prev_tokens: Optional[torch.Tensor] = None,
                 _mirror: bool = False):
        """Enqueue one step (upload and :meth:`launch`) without reading
        anything back; returns (the packed output vector, the sample
        rows' hidden states), both on the device.  ``prev_tokens`` is the
        previous step's vector when the step passes tokens through.
        Counterpart of the JAX runner's ``dispatch``.

        On a served mesh the leader broadcasts the step first, so every
        rank issues the same collectives; a sampled step carries the
        generator's state, which the follower loads before its launch.
        ``_mirror`` marks a follower's replay (no broadcast)."""
        arrays = step_inputs.arrays
        need_sampling = bool(arrays["temperature"].max() > 0)
        if self.mh_channel is not None and not _mirror:
            self.mh_channel.broadcast({
                "kind": "dispatch", "arrays": arrays,
                "t_pad": step_inputs.t_pad, "s_pad": step_inputs.s_pad,
                "attn_qb": step_inputs.attn_qb,
                "total_tokens": step_inputs.total_tokens,
                "use_prev": prev_tokens is not None,
                "need_topk": need_topk,
                "gen_state": (generator.get_state().numpy()
                              if need_sampling else None)})
        tokens, rows = self.launch(
            self.upload(arrays), step_inputs.attn_qb, need_sampling,
            generator, need_topk, prev_tokens, arrays["seeds"],
            arrays["counters"], step_inputs.total_tokens)
        self.dispatches += 1
        self.fold_digest(tokens)
        return tokens, rows

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
        return self.forward(dict(inputs, kv_scale=self.kv_scale), attn_qb)

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
        self.check_unmirrored("causal encode")
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
            req_idx = inputs["req_idx"]
            if self.dp > 1:
                # The group's rows of the gathered hidden rows.
                req_idx = all_gather_cat(req_idx, self.mesh.dp_group)
            req_idx = req_idx.long()
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
        self.check_unmirrored("scoring (echo)")
        h = self.prefill_hidden(self.upload(step_inputs.arrays),
                                step_inputs.attn_qb)
        tgt = torch.from_numpy(np.asarray(targets, np.int64)).to(h.device)
        out = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
        for a in range(0, h.shape[0], self.SCORE_CHUNK):
            b = min(a + self.SCORE_CHUNK, h.shape[0])
            logits = self.logits(h[a:b])
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
        self.check_unmirrored("full prompt logits")
        h = self.prefill_hidden(self.upload(step_inputs.arrays),
                                step_inputs.attn_qb)
        return self.logits(h[:rows]).float().cpu().numpy()
