"""Pipeline parallelism (GPipe) across stage processes.

Counterpart of ``arcticinference_tpu/parallel/pp.py``.  The JAX package
runs the pipeline as one SPMD program that rotates activations with
``lax.ppermute`` in a fixed loop of ``M + pp - 1`` ticks, bubble ticks
writing to the sink block.  Here every stage is a process of its own:
the stacked layers and the KV cache's layer axis are cut over ``pp``
(``parallel/mesh.py``), and each stage runs the step's ``M = pp``
microbatches (contiguous windows of ``T / pp`` rows) in order:

1. stage 0 embeds the microbatch; every other stage receives its
   activation from the previous stage;
2. the stage runs its layers (``scan_layers``) under the mode's
   :class:`~arcticinference_tpu_torch.parallel.ulysses.ParallelContext`
   (the sp all-to-all and the tp or fused sums inside the stage);
3. it hands the result to the next stage;
4. the last stage applies the final norm.

No bubble computes anything.  Causality holds as in JAX: the host orders
tokens by (request, position), so microbatch m+1 reads only pages that
microbatch m or earlier wrote, on this stage, before it.

Each microbatch attends through the kernel of the step: the ragged
kernel over the host's per-microbatch work items (the ``pp``-prefixed
schedule keys the runner builds, stacked ``[pp, ...]``), or, on the
fused loop's uniform decode rows, the grouped decode kernel over the
microbatch's slots (``B / pp`` whole slots, their block tables and
sequence lengths), where JAX runs its plain attention.

**Point-to-point on gloo.** A stage hands its activation on with
``dist.broadcast`` over the two-rank group it shares with its neighbour
(``Mesh.prev_group`` / ``next_group``, made once through ``group_of``),
never ``dist.send`` / ``dist.recv``: gloo's point-to-point reads the
tensor's pointer as host memory, so ``dist.send`` of a ``cuda:0`` tensor
aborts the sending process (``gloo::IoException``: ``writev``, "Bad
address"; ``scripts/gloo_p2p_probe.py``), while gloo's broadcast stages
a CUDA tensor through the host like its other collectives.  The same
call runs on NCCL.

**The hidden rows on every rank.** The last stage's rows (gathered over
sp in SP mode) go to every stage with one broadcast over ``pp``, so
every rank of the mesh returns the same ``[T, hidden]`` rows, as the
runner's forward promises, and the LM head, sampling and the drafters
run unchanged on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from arcticinference_tpu_torch.parallel.mesh import Mesh
from arcticinference_tpu_torch.parallel.ulysses import (ParallelContext,
                                                        all_gather_cat,
                                                        mode_params)

#: Row-indexed arrays, sliced per microbatch.
ROW_KEYS = ("input_ids", "positions", "req_idx", "slot_mapping",
            "attn_row_tree_mask")
#: The work-item schedule (and its tree arrays); under pp the runner
#: builds one per microbatch under these keys prefixed with ``pp``.
SCHEDULE_KEYS = ("attn_item_req", "attn_item_qstart", "attn_item_qlen",
                 "attn_item_pages", "attn_item_pos_base",
                 "attn_token_item", "attn_token_off",
                 "attn_item_tree_start", "attn_item_tree_mask")


def check_supported(module, arch, cfg, token_buckets) -> None:
    """The JAX runner's refusals of a pipeline (``runner.py:112-125``):
    a module without ``scan_layers`` (SwiftKV), layers that do not divide
    by the stages, and token buckets that do not divide by ``pp * sp``
    (a stage's microbatch is cut over sp in SP mode)."""
    pp = cfg.pipeline_parallel_size
    if getattr(module, "scan_layers", None) is None:
        raise NotImplementedError(
            f"{module.__name__} does not support pipeline parallelism "
            "(pipeline_parallel_size > 1): it has no scan_layers stack "
            "to cut into stages, as in the JAX package")
    if arch.num_layers % pp:
        raise ValueError(
            f"num_layers={arch.num_layers} must divide by "
            f"pipeline_parallel_size={pp}")
    div = pp * cfg.ulysses_sequence_parallel_size
    for b in token_buckets:
        if b % div:
            raise ValueError(
                f"token bucket {b} not divisible by pp*sp={div}; use a "
                "power-of-two max_num_batched_tokens")


def send_next(h: torch.Tensor, mesh: Mesh) -> None:
    """Hand ``h`` to the next stage (a broadcast over the pair)."""
    dist.broadcast(h.contiguous(), src=mesh.global_rank,
                   group=mesh.next_group)


def recv_prev(shape, dtype, device, mesh: Mesh) -> torch.Tensor:
    """The previous stage's activation of ``shape``."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(buf, src=mesh.prev_rank, group=mesh.prev_group)
    return buf


def make_pp_forward(module, arch, mesh: Mesh, mode: str, attn_impl,
                    reslice_cache=None):
    """The pipelined forward of this rank's stage in ``mode`` (``"sp"``:
    Ulysses sp x tp, plain tp when sp = 1; ``"shift"``: full tp over the
    fused ``(tp, sp)`` group): ``fn(params, kv, inputs) -> (kv,
    hidden [T, D])`` over the step's global inputs, the stage's layers
    and the stage's cache; every rank returns the same hidden rows."""
    pp = mesh.stages
    assert pp > 1 and mode in ("sp", "shift")
    pctx = ParallelContext(mesh, mode, num_kv_heads=arch.num_kv_heads,
                           head_dim=arch.head_dim,
                           slice_axes=getattr(module, "SHIFT_SLICE_AXES",
                                              None))
    split = mode == "sp" and mesh.sp > 1
    row_shard = mesh.sp if split else 1
    grouped = bool(getattr(attn_impl, "is_grouped_decode", False))
    stage = mesh.stage
    resliced = {} if reslice_cache is None else reslice_cache

    def microbatch(inputs: dict, m: int, tm: int) -> dict:
        lo = m * tm
        mb = {k: v for k, v in inputs.items()
              if k not in SCHEDULE_KEYS and not k.startswith("ppattn_")}
        for k in ROW_KEYS:
            if k in inputs:
                mb[k] = inputs[k][lo:lo + tm]
        if grouped:
            # Uniform decode rows (the fused loop): the microbatch is
            # B / pp whole slots, its block tables and lengths theirs.
            nb = inputs["seq_lens"].shape[0] // pp
            mb["block_tables"] = inputs["block_tables"][m * nb:(m + 1) * nb]
            mb["seq_lens"] = inputs["seq_lens"][m * nb:(m + 1) * nb]
        else:
            if "ppattn_item_req" not in inputs:
                raise ValueError(
                    "a pipelined step needs the runner's per-microbatch "
                    "schedules (the pp-prefixed attention keys)")
            for k in SCHEDULE_KEYS:
                if "pp" + k in inputs:
                    mb[k] = inputs["pp" + k][m]
        c = tm // row_shard
        s = mesh.sp_rank if split else 0
        mb["positions_local"] = inputs["positions"][lo + s * c:
                                                    lo + (s + 1) * c]
        return mb

    def fn(params, kv, inputs):
        t = inputs["input_ids"].shape[0]
        if t % (pp * row_shard):
            raise ValueError(f"{t} token rows do not divide by "
                             f"pp*sp={pp * row_shard}")
        tm = t // pp
        c = tm // row_shard
        s = mesh.sp_rank if split else 0
        layers = mode_params(pctx, params, resliced)["layers"]
        dt = params["final_norm"].dtype
        d = arch.hidden_size
        dev = params["final_norm"].device
        outs = []
        for m in range(pp):
            mb = microbatch(inputs, m, tm)
            if stage == 0:
                lo = m * tm + s * c
                h = module.embed_lookup(
                    params, inputs["input_ids"][lo:lo + c]).to(dt)
            else:
                h = recv_prev((c, d), dt, dev, mesh)
            kv, h = module.scan_layers(layers, arch, kv, h, mb,
                                       attn_impl=attn_impl, pctx=pctx)
            if stage < pp - 1:
                send_next(h, mesh)
            else:
                outs.append(module.finalize_hidden(params, arch, h))
        if stage == pp - 1:
            out = torch.cat(outs)
            if split:
                # [sp][pp][c] -> row order [pp][sp][c].
                out = all_gather_cat(out, mesh.sp_group).reshape(
                    row_shard, pp, c, d).transpose(0, 1).reshape(t, d)
        else:
            out = torch.empty((t, d), dtype=dt, device=dev)
        out = out.contiguous()
        dist.broadcast(out, src=mesh.last_rank, group=mesh.pp_group)
        return kv, out

    return fn
