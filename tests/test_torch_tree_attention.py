"""Tree-mask attention (token-tree verification) in the port against the
JAX package.

- The plain version (``ops/attention.py``) against the JAX
  ``ragged_paged_attention_reference`` with ``tree_start`` /
  ``row_tree_mask``, float32: max abs diff <= 1e-5.  Cases: the one of
  tests/test_tree_spec.py (one request, frontier + 4 nodes, D = 128), a
  step with a prefill chunk beside a tree, and the same with an fp8 cache
  and per-layer ``kv_scale``.
- The wrapper's CPU route with a 9-tuple schedule (``item_tree_start``,
  ``item_tree_mask``) against the Pallas kernel's ``use_tree`` branch in
  interpret mode, as tests/test_tree_spec.py runs it: max abs diff < 0.02
  (the Pallas kernel rounds q and the softmax weights to bf16).
The CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu.ops.attention import (
    ragged_paged_attention_reference as jax_reference)
from arcticinference_tpu.ops.pallas import ragged_attention as jra
from arcticinference_tpu_torch.ops.attention import (
    ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops.cuda import ragged_attention as tra

from tests.test_torch_attention import to_torch

BS = 32


def random_tree(rng, n):
    """Parents of a best-first tree of ``n`` nodes: node i hangs off the
    frontier (-1) or an earlier node."""
    return [int(rng.integers(-1, i)) if i else -1 for i in range(n)]


def tree_case(reqs, Hq=4, Hkv=2, D=128, seed=0, layers=None, t_pad=None):
    """One step over ``reqs``: (context, real tokens fed, tree parents or
    None).  With parents, the last real token is the frontier and the
    nodes follow it: slots linear, positions depth-based, ancestor
    bitmasks as the runner builds them."""
    rng = np.random.default_rng(seed)
    B = len(reqs)
    n_new = [c + len(p or ()) for _, c, p in reqs]
    T = sum(n_new)
    t_pad = t_pad or T
    max_blk = max(-(-(ctx + n) // BS) for (ctx, _, _), n in zip(reqs, n_new))
    bt = np.zeros((B, max_blk), np.int32)
    nb = 1
    for r, ((ctx, _, _), n) in enumerate(zip(reqs, n_new)):
        k = -(-(ctx + n) // BS)
        bt[r, :k] = np.arange(nb, nb + k)
        nb += k
    shape = (nb + 1, 2, BS, Hkv * D)
    kv = rng.standard_normal(((layers,) if layers else ()) + shape).astype(
        np.float32)
    positions = np.zeros(t_pad, np.int32)
    req_idx = np.full(t_pad, -1, np.int32)
    row_mask = np.zeros(t_pad, np.int32)
    tree_start = np.full(B, -1, np.int32)
    t = 0
    for r, ((ctx, chunk, parents), n) in enumerate(zip(reqs, n_new)):
        positions[t:t + chunk] = np.arange(ctx, ctx + chunk)
        req_idx[t:t + n] = r
        if parents:
            frontier = ctx + chunk - 1
            tree_start[r] = frontier
            depth, mask = [], []
            for i, p in enumerate(parents):
                depth.append(0 if p < 0 else depth[p] + 1)
                mask.append((1 if p < 0 else mask[p]) | (1 << (i + 1)))
            positions[t + chunk:t + n] = frontier + 1 + np.array(depth)
            row_mask[t + chunk:t + n] = mask
        t += n
    seq_lens = np.array([c + n for (c, _, _), n in zip(reqs, n_new)],
                        np.int32)
    q = rng.standard_normal((t_pad, Hq, D)).astype(np.float32)
    return dict(q=q, kv=kv, positions=positions, req_idx=req_idx,
                block_tables=bt, seq_lens=seq_lens, tree_start=tree_start,
                row_mask=row_mask, n_new=n_new, reqs=reqs)


def tree_schedule(case, qb):
    """The 9-tuple schedule: work items over cache slots (the last slot
    of each request) plus per item its frontier slot and per window
    offset the row's bitmask."""
    qlens = np.array(case["n_new"], np.int64)
    last = np.array([c + n - 1 for (c, _, _), n in
                     zip(case["reqs"], case["n_new"])], np.int64)
    t = case["q"].shape[0]
    n_items = t // qb + len(qlens) + 1
    sched = jra.build_work_items(qlens, last, qb, BS, n_items, t)
    item_req, token_item, token_off = sched[0], sched[5], sched[6]
    it_ts = np.full(n_items, -1, np.int32)
    it_mask = np.zeros((n_items, qb + 8), np.int32)
    for tt in np.nonzero(case["row_mask"])[0]:
        it = token_item[tt]
        it_mask[it, token_off[tt]] = case["row_mask"][tt]
        it_ts[it] = case["tree_start"][item_req[it]]
    return sched + (it_ts, it_mask)


SINGLE = [(10, 1, [-1, 0, -1, 2])]     # tests/test_tree_spec.py:34-40


def _mixed():
    return [(5, 20, None), (40, 1, random_tree(np.random.default_rng(1), 12))]


def _trees():
    rng = np.random.default_rng(2)
    return [(int(c), 1, random_tree(rng, 30)) for c in (3, 61, 100)]


CASES = {"single": SINGLE, "prefill+tree": _mixed(), "three trees": _trees()}


@pytest.mark.parametrize("name,kv_scale", [
    ("single", None), ("prefill+tree", None), ("prefill+tree", [0.5, 2.0]),
    ("three trees", None)])
def test_plain_tree_matches_jax_reference(name, kv_scale):
    case = tree_case(CASES[name], t_pad=sum(
        c + len(p or ()) for _, c, p in CASES[name]) + 3)
    kv = case["kv"]
    if kv_scale is not None:
        # fp8 cache: the same e4m3 bytes on both sides.
        kj = jnp.asarray(kv * 0.5, jnp.float32).astype(jnp.float8_e4m3fn)
        kt = to_torch(kj)
    else:
        kj, kt = jnp.asarray(kv), torch.from_numpy(kv)
    names = ("q", "positions", "req_idx", "block_tables", "seq_lens")
    ref = np.asarray(jax_reference(
        jnp.asarray(case["q"]), kj,
        *(jnp.asarray(case[k]) for k in names[1:]), kv_scale=kv_scale,
        tree_start=jnp.asarray(case["tree_start"]),
        row_tree_mask=jnp.asarray(case["row_mask"])))
    out = ragged_paged_attention_reference(
        torch.from_numpy(case["q"]), kt,
        *(torch.from_numpy(case[k]) for k in names[1:]), kv_scale=kv_scale,
        tree_start=torch.from_numpy(case["tree_start"]),
        row_tree_mask=torch.from_numpy(case["row_mask"])).numpy()
    live = case["req_idx"] >= 0
    assert np.abs(out[live] - ref[live]).max() <= 1e-5
    assert not out[~live].any()
    # The masks change the result: without them the rows differ.
    causal = ragged_paged_attention_reference(
        torch.from_numpy(case["q"]), kt,
        *(torch.from_numpy(case[k]) for k in names[1:]),
        kv_scale=kv_scale).numpy()
    assert np.abs(causal[live] - ref[live]).max() > 1e-2


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("name,qb", [("single", 8), ("prefill+tree", 8),
                                     ("prefill+tree", 32),
                                     ("three trees", 32)])
def test_tree_wrapper_matches_pallas_kernel(name, qb, kv_dtype):
    case = tree_case(CASES[name], layers=2, seed=3)
    kv = case["kv"]
    scale = np.ones((2, 2), np.float32)
    if kv_dtype == "fp8":
        kj = jnp.asarray(kv * 0.5, jnp.float32).astype(jnp.float8_e4m3fn)
        scale[1] = [0.5, 2.0]
    elif kv_dtype == "bf16":
        kj = jnp.asarray(kv, jnp.bfloat16)
    else:
        kj = jnp.asarray(kv)
    kt = to_torch(kj)
    sched = tree_schedule(case, qb)
    names = ("positions", "req_idx", "block_tables", "seq_lens")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.ragged_paged_attention_kernel(
            jnp.asarray(case["q"]), kj, *(jnp.asarray(case[k])
                                          for k in names),
            qb=qb, schedule=tuple(jnp.asarray(a) for a in sched),
            kv_scale=jnp.asarray(scale), layer=jnp.asarray(1, jnp.int32)))
    tra.reset_launch_counts()
    args = (torch.from_numpy(case["q"]), kt,
            *(torch.from_numpy(case[k]) for k in names))
    out = tra.ragged_paged_attention_kernel(
        *args, qb=qb, schedule=tuple(torch.from_numpy(a) for a in sched),
        kv_scale=torch.from_numpy(scale), layer=1)
    assert np.abs(out.numpy() - ref).max() < 0.02
    # The CPU route is the plain version with the tree arrays read back
    # from the work items.
    plain = ragged_paged_attention_reference(
        args[0], kt[1], *args[2:], kv_scale=scale[1],
        tree_start=torch.from_numpy(case["tree_start"]),
        row_tree_mask=torch.from_numpy(case["row_mask"]))
    assert torch.equal(out, plain)
    assert tra.tree_attention_launches == tra.ragged_attention_launches == 0


def test_tree_rows_reads_back_the_runner_masks():
    """``tree_rows`` inverts the lowering onto work items: per request
    its frontier slot, per token row its bitmask (padding rows 0)."""
    case = tree_case(_mixed() + _trees(), t_pad=128)
    for qb in (8, 32):
        ts, rows = tra.tree_rows(tree_schedule(case, qb), case["req_idx"],
                                 len(case["reqs"]))
        np.testing.assert_array_equal(ts.numpy(), case["tree_start"])
        np.testing.assert_array_equal(rows.numpy(), case["row_mask"])


def test_schedule_of_other_length_is_refused():
    case = tree_case(SINGLE)
    sched = tree_schedule(case, 8)
    with pytest.raises(ValueError):
        tra.ragged_paged_attention_kernel(
            torch.from_numpy(case["q"]), torch.from_numpy(case["kv"]),
            *(torch.from_numpy(case[k]) for k in
              ("positions", "req_idx", "block_tables", "seq_lens")),
            qb=8, schedule=sched[:8])
