"""Ulysses sequence parallelism and shift parallelism on
``torch.distributed``.

Counterpart of ``arcticinference_tpu/parallel/ulysses.py``.  Both modes
run the same stored weights (cut over tp, :mod:`.mesh`) and the same
paged cache:

- **SP (Ulysses) mode**: each rank takes its 1/sp chunk of the step's
  tokens; around attention an all-to-all over the sp group trades tokens
  for heads (``[T/sp, H/tp, D] -> [T, H/(sp*tp), D]`` and back), so each
  rank attends over the whole token batch with ``H/(sp*tp)`` heads; the
  row-parallel products are summed over tp.
- **Shift (full-TP) mode**: every rank takes every token, and each
  weight's tp piece is re-sliced to the fused ``(tp, sp)`` piece without
  communication; the products are summed over the fused group.

In both modes a rank's cache holds the same ``H/(sp*tp)`` kv heads, so
the two programs read and write the same pages, and a step may run
either one.

Expert parallelism (Mixtral) is the expert axis of the stacked expert
weights cut over tp (SP mode) or the fused ``(tp, sp)`` axis (shift
mode): a rank runs its experts' share of each token's sum, which the
row-parallel sum completes (:meth:`ParallelContext.moe_expert_range`).
SwiftKV's later layers run in the shift layout in both modes (see
``models/llama_swiftkv.py``).

In-engine data parallelism wraps a rank's forward (:func:`make_dp_forward`):
the rank runs its dp group's slice of the step and the groups' hidden
rows are gathered over dp; the pipeline's forward is ``parallel/pp.py``.

The ranks run in lockstep: every rank calls the forward with the same
inputs, and the collectives are ``dist.all_to_all_single``,
``dist.all_reduce`` and ``dist.all_gather`` on the caller's backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear
from arcticinference_tpu_torch.parallel.mesh import Mesh


def _local_slice(w, axis: int, idx: int, n: int):
    """This rank's 1/n slice of ``w`` along ``axis`` (a view)."""
    size = w.shape[axis] // n
    return w.narrow(axis, idx * size, size)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group``, in group-rank order, concatenated
    along ``dim``; ``x`` itself without a group."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class ParallelContext:
    """Per-rank hooks of the model forward for one mode.

    GQA with ``num_kv_heads < sp*tp``: kv heads are replicated
    ``r = sp*tp / num_kv_heads``-fold.  In SP mode each tp piece repeats
    its kv heads so that the sp all-to-all hands every rank the head its
    q chunk uses; in shift mode wk / wv are sliced at head granularity.
    The shift program's layer weights are re-sliced once per parameter
    set (:meth:`reslice_layers`, JAX's per-layer ``layer_params``), before
    the forward.
    """

    #: Shift-mode re-slice axes of the per-layer ``[in, out]`` weights
    #: (the JAX ``DEFAULT_SLICE_AXES``): out for the column-cut weights,
    #: in for the row-cut ones; the fused layout's tp piece is sp
    #: consecutive ``[q_f|k_f|v_f]`` groups, so its contiguous sub-slice
    #: is the fused piece.  A module's ``SHIFT_SLICE_AXES`` replaces it
    #: (Mixtral's experts re-slice their expert axis).
    SLICE_AXES = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1,
                          "w_up": 1, "wo": 0, "w_down": 0,
                          "bq": 0, "bk": 0, "bv": 0,
                          "wqkv": 1, "w_gateup": 1, "bqkv": 0}

    def __init__(self, mesh: Mesh, mode: str, num_kv_heads: int = 0,
                 head_dim: int = 0, slice_axes: Optional[dict] = None):
        assert mode in ("sp", "shift")
        self.mesh = mesh
        self.cfg = mesh.cfg
        self.mode = mode
        self.sp = mesh.sp
        self.tp = mesh.tp
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.slice_axes = dict(self.SLICE_AXES if slice_axes is None
                               else slice_axes)
        self.kv_rep = (max(self.sp * self.tp // num_kv_heads, 1)
                       if num_kv_heads else 1)

    # -- weights ---------------------------------------------------------

    @property
    def reslices(self) -> bool:
        """Whether shift mode cuts the tp pieces further (sp > 1)."""
        return self.mode == "shift" and self.sp > 1

    def reslice_layers(self, layers: dict) -> dict:
        """In shift mode, the stacked (``[L, ...]``) layers' tp pieces
        re-sliced to the fused ``(tp, sp)`` piece (the sp-th sub-slice):
        local slicing only.  A piece cut on its out axis is copied
        contiguous for the matmul kernels; one cut on its in axis (wo,
        w_down), on the expert axis of an ``[E, in, out]`` stack, or a
        bias is contiguous per layer as a view."""
        if not self.reslices:
            return layers
        s = self.mesh.sp_rank
        out = dict(layers)
        for key, axis in self.slice_axes.items():
            if key not in layers:
                continue
            w = layers[key]
            copy = axis == 1
            axis += 1
            if key in ("wk", "wv", "bk", "bv") and self.kv_rep > 1:
                # Head-granular: rank (t, s) needs local kv head
                # floor(s * g / sp) of its tp piece (g heads a piece).
                g = self.num_kv_heads // self.tp
                d = self.head_dim
                start = (s * g) // self.sp * d

                def cut(x, ax):
                    return x.narrow(ax, start, d)
            else:
                def cut(x, ax):
                    return _local_slice(x, ax, s, self.sp)

            if isinstance(w, QuantizedLinear):
                w = QuantizedLinear(cut(w.weight, axis),
                                    self._slice_scale(w, axis, cut))
                if copy:
                    w = QuantizedLinear(w.weight.contiguous(),
                                        w.scale.contiguous())
            else:
                w = cut(w, axis)
                if copy:
                    w = w.contiguous()
            out[key] = w
        return out

    @staticmethod
    def _slice_scale(w: QuantizedLinear, axis: int, slice_fn):
        """The scale's slice matching the weight's: group scales keep
        every axis, per-out-channel scales drop the weight's in axis
        (``w.dim() - 2``; slicing it leaves the scale as it is), scalar
        and per-layer scales are untouched."""
        sc, wn = w.scale, w.weight.dim()
        if sc.dim() == wn:
            return slice_fn(sc, axis)
        if sc.dim() == wn - 1:
            if axis == wn - 2:
                return sc
            return slice_fn(sc, axis if axis < wn - 2 else axis - 1)
        return sc

    # -- expert parallelism ----------------------------------------------

    def moe_expert_range(self, num_experts: int) -> tuple[int, int]:
        """(first, count) of the experts this rank holds: the expert axis
        cut over tp in SP mode, over the fused ``(tp, sp)`` axis,
        tp-major (the shift re-slice's order), in shift mode."""
        div = self.tp if self.mode == "sp" else self.tp * self.sp
        el = num_experts // div
        idx = (self.mesh.tp_rank if self.mode == "sp"
               else self.mesh.fused_rank)
        return idx * el, el

    # -- head counts at qkv time ----------------------------------------

    def arch_view(self, arch):
        """The architecture as one rank sees it: its heads, and
        ``fused_seg`` interleaved groups in its fused weights (the runner
        fuses with interleave ``tp * (sp if shift is on else 1)``, so an
        SP-mode tp piece holds sp groups when shift is on; the shift
        re-slice leaves one)."""
        div = self.tp if self.mode == "sp" else self.tp * self.sp
        shift_on = self.cfg.enable_shift_parallel
        seg = self.sp if (self.mode == "sp" and shift_on
                          and self.sp > 1) else 1
        return dataclasses.replace(
            arch, num_heads=arch.num_heads // div,
            num_kv_heads=max(arch.num_kv_heads // div, 1), fused_seg=seg)

    def _rep_kv(self, k):
        """[T, g, D] -> [T, g*r, D]: each head repeated r times in a row,
        so the sp all-to-all hands each rank the head its q chunk uses."""
        return torch.repeat_interleave(k, self.kv_rep, dim=1)

    # -- collectives -----------------------------------------------------

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [sp, ...]: chunk j goes to sp rank j; returns the chunks
        received, [sp (source), ...]."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.mesh.sp_group)
        return out

    def dispatch(self, q, k, v):
        """SP all-to-all: ``[T/sp, H/tp, D] -> [T, H/(sp*tp), D]``."""
        if self.mode != "sp" or self.sp == 1:
            return q, k, v
        if self.kv_rep > 1:
            k = self._rep_kv(k)
            v = self._rep_kv(v)

        def a2a(x):
            t, h, d = x.shape
            hc = h // self.sp
            x = x.reshape(t, self.sp, hc, d).transpose(0, 1)
            return self._all_to_all(x).reshape(t * self.sp, hc, d)

        return a2a(q), a2a(k), a2a(v)

    def combine(self, o):
        """Reverse all-to-all: ``[T, H/(sp*tp), D] -> [T/sp, H/tp, D]``."""
        if self.mode != "sp" or self.sp == 1:
            return o
        t, hc, d = o.shape
        tl = t // self.sp
        got = self._all_to_all(o.reshape(self.sp, tl, hc, d))
        return got.transpose(0, 1).reshape(tl, self.sp * hc, d)

    def psum(self, x):
        """Row-parallel reduction: over tp in SP mode, over the fused
        ``(tp, sp)`` group in shift mode."""
        group = (self.mesh.tp_group if self.mode == "sp"
                 else self.mesh.sp_tp_group)
        if group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x


def check_supported(arch, cfg) -> None:
    """The JAX ``make_sharded_forward`` refusals: kv heads that do not
    divide by sp*tp replicate only in whole heads per tp piece and an
    integer factor; experts must divide by the expert-parallel degree of
    each mode the config runs (tp in SP mode, sp*tp in shift mode)."""
    tp, sp = cfg.tensor_parallel_size, cfg.ulysses_sequence_parallel_size
    num_experts = getattr(arch, "num_experts", 0)
    if num_experts:
        modes = [("sp", tp)]
        if cfg.enable_shift_parallel and sp > 1:
            modes.append(("shift", tp * sp))
        for mode, div in modes:
            if num_experts % div:
                raise NotImplementedError(
                    f"num_experts={num_experts} must divide the expert-"
                    f"parallel degree {div} ({mode} mode)")
    if arch.num_kv_heads % (sp * tp) != 0:
        if arch.num_kv_heads % tp != 0:
            raise NotImplementedError(
                f"num_kv_heads={arch.num_kv_heads} must divide by tp={tp}")
        g = arch.num_kv_heads // tp
        if sp % g != 0:
            raise NotImplementedError(
                f"sp={sp} must be a multiple of kv-heads-per-shard {g}")


def make_sharded_forward(module, arch, mesh: Mesh, mode: str,
                         attn_impl=None, reslice_cache: Optional[dict] = None):
    """The forward of one mode on this rank: ``fn(params, kv, inputs) ->
    (kv, hidden)`` over the step's global inputs and this rank's
    parameters and cache.  In SP mode the rank runs its 1/sp chunk of the
    tokens (T must divide by sp) and the hidden rows are gathered over sp
    at the end; a module that returns the sample rows
    (``RETURNS_SAMPLE_ROWS``, SwiftKV) returns them on every rank
    already.  In shift mode the stacked layer weights (``layers``, or
    SwiftKV's first half ``layers_a``) are re-sliced once per parameter
    set, into
    ``reslice_cache`` (share one dict between the forwards of one
    parameter set, so they share one copy).  Every rank returns the same
    hidden rows."""
    check_supported(arch, mesh.cfg)
    pctx = ParallelContext(mesh, mode, num_kv_heads=arch.num_kv_heads,
                           head_dim=arch.head_dim,
                           slice_axes=getattr(module, "SHIFT_SLICE_AXES",
                                              None))
    split = mode == "sp" and mesh.sp > 1
    rows_out = bool(getattr(module, "RETURNS_SAMPLE_ROWS", False))
    resliced = {} if reslice_cache is None else reslice_cache

    def fn(params, kv, inputs):
        local = inputs
        if split:
            t = inputs["input_ids"].shape[0]
            if t % mesh.sp:
                raise ValueError(f"{t} token rows do not divide by "
                                 f"sp={mesh.sp}")
            c = t // mesh.sp
            s = mesh.sp_rank
            local = dict(inputs)
            local["input_ids"] = inputs["input_ids"][s * c:(s + 1) * c]
            local["positions_local"] = inputs["positions"][s * c:(s + 1) * c]
        kv, h = module.forward(mode_params(pctx, params, resliced), arch,
                               kv, local, attn_impl=attn_impl, pctx=pctx)
        if split and not rows_out:
            h = all_gather_cat(h, mesh.sp_group)
        return kv, h

    return fn


def mode_params(pctx: ParallelContext, params: dict, resliced: dict) -> dict:
    """``params`` as the mode of ``pctx`` runs them: in shift mode the
    stacked layers re-sliced to the fused piece, once per parameter set
    (kept in ``resliced``); as they are otherwise.  SwiftKV's later
    layers are in the shift layout already (``llama_swiftkv.
    mesh_layout``)."""
    if not pctx.reslices:
        return params
    if resliced.get("src") is not params:
        resliced["src"] = params
        resliced["out"] = dict(params, **{
            key: pctx.reslice_layers(params[key])
            for key in ("layers", "layers_a") if key in params})
    return resliced["out"]


def make_dp_forward(inner, mesh: Mesh):
    """In-engine data parallelism around a rank's forward ``inner``
    (sharded or pipelined): the inputs are this rank's dp
    group's slice of the step (``ModelRunner.upload``: its requests, its
    ``T / dp`` token window, its shard-local block ids), and the group's
    hidden rows are gathered over dp in dp-major order, so every rank
    returns the step's whole ``[T, hidden]`` rows, the JAX dp forward's
    global array (a SwiftKV model's per-group sample rows alike)."""

    def fn(params, kv, inputs):
        kv, h = inner(params, kv, inputs)
        return kv, all_gather_cat(h, mesh.dp_group)

    return fn
