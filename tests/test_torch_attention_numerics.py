"""The rounding scheme of the ragged kernel's tensor-core products, pinned
on the CPU.

The CUDA kernel (``csrc/ragged_attention.cu``, kernel 1) multiplies
16-bit operands with float32 sums.  :func:`mma_model` repeats its
rounding in plain torch: q scaled by ``scale * k_scale * log2(e)``;
pages of 32 slots folded into a base-2 online softmax; q and P each
split into a high part and the rounded remainder before their products.
bf16 pages keep K and V as they are and split in bf16; fp8 pages become
fp16 (exactly) and split in fp16.

The model is held against

- the port's plain version (float32 throughout; what the kernel is held
  against on the card) within the card check's relative-norm bound,
  ``||model - plain|| <= 1e-3 ||plain||`` over the valid rows, on the
  card check's inputs (q std 1 and 5, K and V std 0.5); and
- the JAX Pallas kernel in interpret mode (head dim 128, the TPU
  kernel's tiling) within atol = rtol = 2e-2, the bound
  tests/test_kernels.py uses.

Rounding q and P to bf16 once, as the TPU kernel does, misses the 1e-3
bound on the card check's inputs: the last test shows it, so the split
is needed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu.ops.pallas import ragged_attention as jra
from arcticinference_tpu_torch.ops.attention import (
    ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops.cuda import ragged_attention as tra

from tests.test_torch_attention import to_torch
from tests.test_torch_tree_attention import random_tree, tree_case, \
    tree_schedule

REL_TOL = 1e-3
TOL = 2e-2
PAGE = 32
LOG2E = 1.0 / math.log(2.0)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _split(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _round(x, dtype)
    return hi, _round(x - hi, dtype)


def mma_model(q, kv, positions, req_idx, block_tables, seq_lens, kv_scale,
              tree_start=None, row_tree_mask=None, scheme="kernel"):
    """The kernel's arithmetic on one cache layer ``kv`` [N, 2, 32,
    Hkv*D]; float32 out [T, Hq, D], padding rows zero.

    ``scheme="kernel"``: the rounding above.  ``scheme="single"``: q and
    P each rounded to bf16 once (the TPU kernel's rounding)."""
    t, hq, d = q.shape
    hkv = kv.shape[-1] // d
    group = hq // hkv
    fp8 = kv.dtype == torch.float8_e4m3fn
    dt = torch.float16 if fp8 and scheme == "kernel" else torch.bfloat16
    k_scale, v_scale = (float(x) for x in kv_scale)
    out = torch.zeros((t, hq, d))
    for r in torch.unique(req_idx[req_idx >= 0]).tolist():
        rows = torch.nonzero(req_idx == r).flatten()
        s_len = int(seq_lens[r])
        pages = block_tables[r, :-(-s_len // PAGE)].long()
        # K and V as the MMAs see them: bf16 as stored, fp8 as fp16 (exact).
        k = kv[pages, 0].reshape(-1, hkv, d)[:s_len].float()
        v = kv[pages, 1].reshape(-1, hkv, d)[:s_len].float()
        qs = q[rows].float() * (d ** -0.5 * k_scale * LOG2E)
        qg = qs.reshape(-1, hkv, group, d)
        if scheme == "kernel":
            q_hi, q_lo = _split(qg, dt)
            s = (torch.einsum("thgd,shd->thgs", q_hi, k)
                 + torch.einsum("thgd,shd->thgs", q_lo, k))
        else:
            s = torch.einsum("thgd,shd->thgs", _round(qg, dt), k)
        kv_pos = torch.arange(s_len)
        pos = positions[rows].long()
        valid = kv_pos[None, :] <= pos[:, None]
        if tree_start is not None:
            m = row_tree_mask[rows].long()[:, None]
            rel = kv_pos[None, :] - int(tree_start[r])
            bit = (m >> rel.clamp(0, 31)) & 1
            override = (m != 0) & (rel >= 1)
            valid = torch.where(override, (rel < 32) & (bit > 0), valid)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        # The online softmax, one page at a time.
        m_run = torch.full(s.shape[:-1], float("-inf"))
        l_run = torch.zeros(s.shape[:-1])
        acc = torch.zeros(s.shape[:-1] + (d,))
        for lo in range(0, s_len, PAGE):
            sc = s[..., lo:lo + PAGE]
            m_new = torch.maximum(m_run, sc.amax(-1))
            m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
            alpha = torch.exp2(m_run - m_use)
            p = torch.exp2(sc - m_use[..., None])
            l_run = l_run * alpha + p.sum(-1)
            vc = v[lo:lo + PAGE]
            if scheme == "kernel":
                p_hi, p_lo = _split(p, dt)
                pv = (torch.einsum("thgs,shd->thgd", p_hi, vc)
                      + torch.einsum("thgs,shd->thgd", p_lo, vc))
            else:
                pv = torch.einsum("thgs,shd->thgd", _round(p, dt), vc)
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        o = acc * (v_scale / l_run.clamp(min=1e-20))[..., None]
        out[rows] = o.reshape(-1, hq, d)
    return out


def numerics_case(q_std, kv_dtype, d, tree, seed=0):
    """A step with a prefill chunk, decode rows and (with ``tree``) two
    token trees, on a 2-layer cache (layer 1 read; fp8 with scales 2 and
    0.5); K and V std 0.5, q std ``q_std``.  Returns the numpy arrays,
    the torch cache and scales, and the 9-tuple schedule at qb 32 (7-tuple
    without trees)."""
    rng = np.random.default_rng(seed)
    trees = ([(200, 1, random_tree(rng, 30)), (90, 3, random_tree(rng, 9))]
             if tree else [(200, 1, None), (90, 3, None)])
    reqs = [(0, 45, None), (300, 1, None)] + trees
    case = tree_case(reqs, Hq=8, Hkv=2, D=d, seed=seed + 1, layers=2)
    q = (rng.standard_normal(case["q"].shape) * q_std).astype(np.float32)
    case["q"] = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    kv = case["kv"] * 0.5
    scale = np.ones((2, 2), np.float32)
    if kv_dtype == "fp8":
        kj = jnp.asarray(kv, jnp.float32).astype(jnp.float8_e4m3fn)
        scale[1] = [2.0, 0.5]
    else:
        kj = jnp.asarray(kv, jnp.bfloat16)
    sched = tree_schedule(case, 32)
    return case, kj, to_torch(kj), scale, (sched if tree else sched[:7])


def _torch_args(case):
    return [torch.from_numpy(case[k]) for k in
            ("positions", "req_idx", "block_tables", "seq_lens")]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("q_std", [1.0, 5.0])
def test_kernel_rounding_meets_the_card_bound(q_std, kv_dtype, d, tree):
    case, kj, kt, scale, sched = numerics_case(q_std, kv_dtype, d, tree)
    pos, req, bt, sl = _torch_args(case)
    live = req >= 0
    q = torch.from_numpy(case["q"])
    tree_kw = dict(tree_start=torch.from_numpy(case["tree_start"]),
                   row_tree_mask=torch.from_numpy(case["row_mask"])) \
        if tree else {}
    model = mma_model(q, kt[1], pos, req, bt, sl, scale[1], **tree_kw)
    plain32 = ragged_paged_attention_reference(
        q, kt[1], pos, req, bt, sl, kv_scale=scale[1], **tree_kw)
    assert _rel(model[live], plain32[live]) <= REL_TOL / 100
    # The kernel's output and the plain version's are both bf16.
    plain = ragged_paged_attention_reference(
        q.to(torch.bfloat16), kt[1], pos, req, bt, sl, kv_scale=scale[1],
        **tree_kw)
    assert _rel(model.to(torch.bfloat16)[live].float(),
                plain[live].float()) <= REL_TOL
    assert not model[~live].any()
    if d != 128:
        return
    # The TPU kernel in interpret mode, through the same schedule.
    names = ("positions", "req_idx", "block_tables", "seq_lens")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.ragged_paged_attention_kernel(
            jnp.asarray(case["q"]), kj,
            *(jnp.asarray(case[k]) for k in names), qb=32,
            schedule=tuple(jnp.asarray(a) for a in sched),
            kv_scale=jnp.asarray(scale), layer=jnp.asarray(1, jnp.int32)))
    np.testing.assert_allclose(model[live].numpy(), ref[live.numpy()],
                               atol=TOL, rtol=TOL)
    # The wrapper's CPU route with the same schedule is the plain version.
    out = tra.ragged_paged_attention_kernel(
        q, kt, pos, req, bt, sl, qb=32,
        schedule=tuple(torch.from_numpy(a) for a in sched),
        kv_scale=torch.from_numpy(scale), layer=1)
    assert _rel(model[live], out[live]) <= REL_TOL


def test_single_bf16_rounding_misses_the_card_bound():
    """q and P rounded to bf16 once, at q std 5 over contexts ~3000 (the
    card check's inputs): the relative error exceeds the bound the
    kernel is held to, while the kernel's scheme stays well inside it."""
    rng = np.random.default_rng(9)
    reqs = [(int(c), 1, None) for c in rng.integers(2800, 3200, 16)] + [
        (2900, 64, None)]
    case = tree_case(reqs, Hq=8, Hkv=2, D=128, seed=10)
    q = torch.from_numpy(rng.standard_normal(case["q"].shape).astype(
        np.float32) * 5.0).to(torch.bfloat16)
    kt = torch.from_numpy(case["kv"] * 0.5).to(torch.bfloat16)
    pos, req, bt, sl = _torch_args(case)
    scale = np.ones(2, np.float32)
    plain = ragged_paged_attention_reference(
        q.float(), kt, pos, req, bt, sl, kv_scale=scale)
    single = mma_model(q, kt, pos, req, bt, sl, scale, scheme="single")
    kernel = mma_model(q, kt, pos, req, bt, sl, scale)
    assert _rel(single, plain) > REL_TOL
    assert _rel(kernel, plain) < REL_TOL / 10
