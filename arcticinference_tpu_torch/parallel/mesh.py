"""The device mesh on ``torch.distributed``: coordinates, process groups
and the cuts of the parameters and the KV cache.

Counterpart of ``arcticinference_tpu/parallel/mesh.py``.  The JAX package
drives every device of a ``Mesh(dp, pp, sp, tp)`` from one process; here
each rank is a process of its own, and all ranks run the same host code
in lockstep.  A rank's coordinates follow the JAX ``build_mesh`` reshape
(``dp, pp, sp, tp``, tp fastest), and the JAX mesh axes become process
groups built with ``dist.new_group`` on the caller's backend:

- ``tp``: the ranks that differ only in their tp coordinate;
- ``sp``: the ranks that differ only in their sp coordinate;
- ``sp_tp``: the fused shift-mode axis ``("tp", "sp")``, tp-major, so a
  weight stored cut over tp re-slices to the fused shard without moving
  a byte (:class:`~arcticinference_tpu_torch.parallel.ulysses.
  ParallelContext`), and the cache's head axis is cut over it in both
  modes (the KV-layout invariance);
- ``dp``: the ranks that differ only in their dp coordinate (in-engine
  data parallelism gathers a step's hidden rows over it);
- ``pp``: the ranks that differ only in their pipeline stage, and the
  two-rank groups of a stage and its neighbours, over which a stage
  hands its activations on (``parallel/pp.py``).

A process group orders its ranks by global rank, which is sp-major for
the fused axis: only reductions run over it, whose result does not depend
on the order of the ranks.

Parameters are cut by rule (:func:`param_specs`, the JAX
``PartitionSpec``s as tuples; a model module with a ``param_specs`` hook
gives its own, :func:`specs_of`): each rank keeps its piece of the
global parameters (:func:`shard_params`).  A dimension that does not
divide by its axis is kept whole (replicated), as the JAX ``put`` does.
Under pipeline parallelism the stacked layer axis is cut over ``pp``
(the JAX ``param_specs(pp=True)``): a stage keeps its own layers, and a
stacked leaf's per-layer scale follows that cut.  The KV cache follows
the JAX ``kv_cache_spec(pp, dp)``: its layer axis is cut over ``pp`` and
its block axis over ``dp`` (a dp group owns ``num_blocks / dp``
shard-local blocks).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from arcticinference_tpu_torch.config import ParallelConfig
from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

SP_TP = ("tp", "sp")  # the fused tensor-parallel axis of shift mode

#: Seconds a collective or a group's creation may wait for its peers.
DEFAULT_TIMEOUT_S = 600


_GROUPS: dict = {}


def group_of(ranks, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The process group of global ``ranks``, made by its members only
    (``use_local_synchronization``) the first time and kept for the
    process's life: every later mesh over the same ranks reuses it (a
    second group over the same ranks would rendezvous under the same
    name)."""
    ranks = tuple(sorted(ranks))
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(
            list(ranks), timeout=datetime.timedelta(seconds=timeout_s),
            use_local_synchronization=True)
    return _GROUPS[ranks]


def mesh_coords(rank: int, cfg: ParallelConfig) -> dict[str, int]:
    """The coordinates of mesh rank ``rank`` in the JAX ``build_mesh``
    layout ``reshape(dp, pp, sp, tp)``."""
    tp, sp = cfg.tensor_parallel_size, cfg.ulysses_sequence_parallel_size
    pp = cfg.pipeline_parallel_size
    return {"tp": rank % tp, "sp": (rank // tp) % sp,
            "pp": (rank // (tp * sp)) % pp, "dp": rank // (tp * sp * pp)}


@dataclass
class Mesh:
    """One rank's view of the mesh: its coordinates and the process
    groups it belongs to (None for an axis of size 1)."""

    cfg: ParallelConfig
    group: Any                  # the process group the mesh spans
    rank: int                   # rank within ``group``
    coords: dict
    tp_group: Any = None
    sp_group: Any = None
    sp_tp_group: Any = None
    dp_group: Any = None
    pp_group: Any = None
    #: the global rank of the previous stage at this rank's (dp, sp,
    #: tp), and the two-rank groups shared with the previous and the next
    #: stage (None at the ends of the pipeline).
    prev_rank: Optional[int] = None
    prev_group: Any = None
    next_group: Any = None
    #: this rank's global rank and the last stage's at its (dp, sp, tp).
    global_rank: int = 0
    last_rank: int = 0

    @property
    def tp(self) -> int:
        return self.cfg.tensor_parallel_size

    @property
    def sp(self) -> int:
        return self.cfg.ulysses_sequence_parallel_size

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def sp_rank(self) -> int:
        return self.coords["sp"]

    @property
    def fused_rank(self) -> int:
        """The rank's index on the fused ``("tp", "sp")`` axis."""
        return self.tp_rank * self.sp + self.sp_rank

    @property
    def dp_rank(self) -> int:
        return self.coords["dp"]

    @property
    def stages(self) -> int:
        return self.cfg.pipeline_parallel_size

    @property
    def stage(self) -> int:
        return self.coords["pp"]

    def stage_layers(self, num_layers: int) -> range:
        """The layers this rank's stage holds: its ``num_layers / pp``
        consecutive ones."""
        per = num_layers // self.stages
        return range(self.stage * per, (self.stage + 1) * per)


def build_mesh(cfg: ParallelConfig, group=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's :class:`Mesh` over ``group`` (default: the default
    process group), which must hold ``cfg.world_size`` ranks.  The caller
    initializes ``torch.distributed``; the subgroups are made with
    ``dist.new_group`` on its backend, each by its members only, so a
    mesh can live on a subgroup of a larger world.  Every rank of the
    mesh must call this, in the same order as its other group
    creations."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a parallel config of world size {cfg.world_size} needs "
            "torch.distributed initialized by the caller "
            "(dist.init_process_group, as torchrun or "
            "parallel.world.spawn do)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if size != cfg.world_size:
        raise ValueError(
            f"the parallel config needs {cfg.world_size} ranks "
            f"(dp x pp x sp x tp), the process group has {size}")
    global_ranks = dist.get_process_group_ranks(group)
    rank = dist.get_rank(group)
    coords = mesh_coords(rank, cfg)

    def group_over(members):
        members = sorted(members)
        if len(members) == 1:
            return None
        if len(members) == size:
            return group
        return group_of(members, timeout_s)

    def axis_group(axes: tuple[str, ...]):
        """The ranks that share every coordinate outside ``axes``."""
        return group_over(
            global_ranks[r] for r in range(size)
            if all(mesh_coords(r, cfg)[a] == coords[a]
                   for a in ("dp", "pp", "sp", "tp") if a not in axes))

    def at_stage(stage: int) -> int:
        """The global rank of ``stage`` at this rank's (dp, sp, tp)."""
        return global_ranks[rank + (stage - coords["pp"])
                            * cfg.tensor_parallel_size
                            * cfg.ulysses_sequence_parallel_size]

    tp_group = axis_group(("tp",))
    sp_group = axis_group(("sp",))
    if cfg.ulysses_sequence_parallel_size == 1:
        sp_tp_group = tp_group
    elif cfg.tensor_parallel_size == 1:
        sp_tp_group = sp_group
    else:
        sp_tp_group = axis_group(SP_TP)
    dp_group = axis_group(("dp",))
    pp_group = axis_group(("pp",))
    me, pp = global_ranks[rank], cfg.pipeline_parallel_size
    stage = coords["pp"]
    # The neighbours' two-rank groups, the previous one first: each pair
    # is made by its two members alone, and along the pipeline the
    # creations form a chain from stage 0, so none waits on a cycle.
    prev_rank = at_stage(stage - 1) if stage > 0 else None
    next_rank = at_stage(stage + 1) if stage < pp - 1 else None
    prev_group = (None if prev_rank is None
                  else group_over((prev_rank, me)))
    next_group = (None if next_rank is None
                  else group_over((me, next_rank)))
    return Mesh(cfg=cfg, group=group, rank=rank, coords=coords,
                tp_group=tp_group, sp_group=sp_group,
                sp_tp_group=sp_tp_group, dp_group=dp_group,
                pp_group=pp_group, prev_rank=prev_rank,
                prev_group=prev_group, next_group=next_group,
                global_rank=me,
                last_rank=at_stage(pp - 1))


# --------------------------------------------------------------------- #
# Parameter cuts
# --------------------------------------------------------------------- #

def param_specs() -> dict:
    """Which axis of each Llama-family leaf is cut over ``tp`` (the JAX
    ``param_specs`` as tuples; None = not cut).  Weights are stored cut
    over tp and whole over sp: the SP-mode layout."""
    col = (None, None, "tp")     # [L, in, out] -> cut out
    row = (None, "tp", None)     # [L, in, out] -> cut in
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "lm_head": (None, "tp"),
        "layers": {
            "input_norm": (None, None), "post_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "w_gate": col, "w_up": col, "w_down": row,
            "wqkv": col, "w_gateup": col, "bqkv": (None, "tp"),
            "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
            "q_norm": (None, None), "k_norm": (None, None),
        },
    }


#: The stacked layer dicts of the model modules (``[L, ...]`` leaves).
LAYER_KEYS = ("layers", "layers_a", "layers_b")


def specs_of(module) -> dict:
    """The cut rules of ``module``'s parameters: its ``param_specs`` hook
    (SwiftKV, Mixtral), else the Llama family's (:func:`param_specs`), as
    the JAX ``make_sharded_forward`` reads them."""
    hook = getattr(module, "param_specs", None)
    return hook() if hook is not None else param_specs()


def pp_specs(specs: dict) -> dict:
    """``specs`` with the layer axis of every stacked leaf cut over
    ``pp`` (the JAX ``param_specs(pp=True)``)."""
    return {k: ({n: ("pp",) + s[1:] for n, s in v.items()}
                if k in LAYER_KEYS else v) for k, v in specs.items()}


def quantized_leaf_spec(spec: tuple, w_ndim: Optional[int] = None,
                        s_ndim: Optional[int] = None) -> tuple:
    """(weight spec, scale spec) of a quantized leaf: group scales
    (``s_ndim == w_ndim``) follow the weight; per-out-channel scales
    (``s_ndim == w_ndim - 1``) take the weight's spec without its in
    axis; per-layer / per-tensor scales are whole, except that a stacked
    leaf's layer axis follows the weight's pp cut (Mixtral's fp8 expert
    scale ``[L]``)."""
    if w_ndim is not None and s_ndim is not None and len(spec) == w_ndim:
        if s_ndim == w_ndim:
            return spec, spec
        if s_ndim == w_ndim - 1:
            return spec, spec[:-2] + (spec[-1],)
    if spec and spec[0] == "pp":
        return spec, ("pp",)
    return spec, ()


def cut(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of ``x`` under ``spec`` (a contiguous copy when
    cut); ``x`` itself when nothing is cut or a cut dimension does not
    divide by its axis (the JAX ``put`` replicates such a leaf)."""
    sizes = {"tp": mesh.tp, "sp": mesh.sp, "pp": mesh.stages}
    idx = {"tp": mesh.tp_rank, "sp": mesh.sp_rank, "pp": mesh.stage}
    out = x
    for axis, name in enumerate(spec):
        if name is None or sizes[name] == 1:
            continue
        n = sizes[name]
        if x.shape[axis] % n:
            return x
        w = x.shape[axis] // n
        out = out.narrow(axis, idx[name] * w, w)
    return out if out is x else out.contiguous()


def shard_leaf(leaf, spec: tuple, mesh: Mesh):
    if isinstance(leaf, QuantizedLinear):
        wspec, sspec = quantized_leaf_spec(spec, leaf.weight.dim(),
                                           leaf.scale.dim())
        return QuantizedLinear(cut(leaf.weight, wspec, mesh),
                               cut(leaf.scale, sspec, mesh))
    return cut(leaf, spec, mesh)


def shard_params(params: dict, mesh: Mesh,
                 specs: Optional[dict] = None) -> dict:
    """This rank's piece of a global parameter dict, under the SP-mode
    layout (its stage's layers under pp).  A leaf without a rule
    raises."""
    specs = param_specs() if specs is None else specs
    if mesh.stages > 1:
        specs = pp_specs(specs)

    def place(p, s, path):
        if isinstance(p, dict):
            if not isinstance(s, dict):
                raise ValueError(f"no cut rule for {path}")
            missing = set(p) - set(s)
            if missing:
                raise ValueError(f"no cut rule for params {sorted(missing)}")
            return {k: place(v, s[k], path + (k,)) for k, v in p.items()}
        return shard_leaf(p, s, mesh)

    return place(params, specs, ())


def leaf_spec(path: tuple[str, ...], specs: Optional[dict] = None) -> tuple:
    """The rule of the leaf at ``path`` (``("layers", "wq")``)."""
    s = param_specs() if specs is None else specs
    for key in path:
        s = s[key]
    return s


def layer_leaf_spec(path: tuple[str, ...],
                    specs: Optional[dict] = None) -> tuple:
    """The rule of one layer of a stacked leaf (``path`` under one of
    :data:`LAYER_KEYS`: the rule without its layer axis), or of a whole
    leaf elsewhere: the cut of a leaf ``init_params(keep=)`` hands over
    as it is drawn."""
    spec = leaf_spec(path, specs)
    return spec[1:] if path[0] in LAYER_KEYS else spec


# --------------------------------------------------------------------- #
# KV cache
# --------------------------------------------------------------------- #

def kv_cache_heads(num_kv_heads: int, mesh: Mesh) -> tuple[int, int]:
    """(heads held, first head of the model's ``num_kv_heads``) of this
    rank's cache, the counterpart of the JAX ``kv_cache_spec``: the cache
    ``[L, N, 2, Bs, Hkv*D]`` is cut on its head-feature axis over the
    fused ``("tp", "sp")`` axis, in both modes.  The mesh's cache holds
    ``max(Hkv, sp*tp)`` heads, so when there are fewer kv heads than
    fused shards each head is stored ``sp*tp / Hkv`` times, consecutively
    (the JAX runner's ``eff_kv_heads``): a rank then holds one copy of
    one head."""
    fused = mesh.sp * mesh.tp
    eff = max(num_kv_heads, fused)
    per = eff // fused
    first = mesh.fused_rank * per
    rep = eff // num_kv_heads
    return per, first // rep
