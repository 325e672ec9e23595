"""The port's plain attention against the JAX reference and the JAX
Pallas kernels (interpret mode, as tests/test_kernels.py runs them), and
the CUDA wrappers' routing.

Tolerances: plain vs the JAX reference, float32, atol 1e-4; plain vs the
Pallas kernels (which round q and the softmax weights to bf16 before
their products) atol = rtol = 2e-2 on valid rows, the bound
tests/test_kernels.py uses.  The CUDA kernels themselves are held against
the plain version on the card by tests/test_torch_kernels_cuda.py.
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

TOL = 2e-2


def to_torch(x) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor, bf16 and fp8 bit for bit."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def make_case(qlens, ctx, Hq=4, Hkv=2, D=128, Bs=32, MaxBlk=8, seed=0,
              t_pad=None, layers=None):
    """tests/test_kernels.py:make_case as numpy, with optional padding rows
    and a stacked [layers, ...] cache."""
    rng = np.random.default_rng(seed)
    B = len(qlens)
    T = sum(qlens)
    block_tables = np.zeros((B, MaxBlk), np.int32)
    nb = 1
    for r in range(B):
        for i in range((ctx[r] + qlens[r] + Bs - 1) // Bs):
            block_tables[r, i] = nb
            nb += 1
    shape = (nb + 1, 2, Bs, Hkv * D)
    if layers:
        shape = (layers,) + shape
    kv = rng.standard_normal(shape).astype(np.float32)
    t_pad = t_pad or T
    positions = np.zeros(t_pad, np.int32)
    req_idx = np.full(t_pad, -1, np.int32)
    t = 0
    for r in range(B):
        for i in range(qlens[r]):
            positions[t] = ctx[r] + i
            req_idx[t] = r
            t += 1
    seq_lens = np.array([ctx[r] + qlens[r] for r in range(B)], np.int32)
    q = rng.standard_normal((t_pad, Hq, D)).astype(np.float32)
    return q, kv, positions, req_idx, block_tables, seq_lens


CASES = [([10, 1], [0, 37]), ([1, 1, 1], [5, 64, 31]), ([40, 3], [0, 100])]


@pytest.mark.parametrize("qlens,ctx,kv_scale", [
    (*CASES[0], None), (*CASES[1], [0.5, 2.0]), (*CASES[2], None)])
def test_plain_matches_jax_reference(qlens, ctx, kv_scale):
    q, kv, pos, req, bt, sl = make_case(qlens, ctx, D=32, t_pad=sum(qlens) + 5)
    args = (q, kv, pos, req, bt, sl)
    ref = np.asarray(jax_reference(*map(jnp.asarray, args),
                                   kv_scale=kv_scale))
    out = ragged_paged_attention_reference(*map(to_torch, args),
                                           kv_scale=kv_scale).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert not out[req < 0].any()          # padding rows are zeros


def test_plain_refuses_tree_masks():
    """A tree mask without its frontier slots (or the reverse) is
    refused; the tree rule itself is held against the JAX reference in
    tests/test_torch_tree_attention.py."""
    q, kv, pos, req, bt, sl = map(to_torch, make_case([3], [4], D=32))
    with pytest.raises(ValueError):
        ragged_paged_attention_reference(
            q, kv, pos, req, bt, sl, row_tree_mask=torch.zeros(3, dtype=int))
    with pytest.raises(ValueError):
        ragged_paged_attention_reference(
            q, kv, pos, req, bt, sl, tree_start=torch.zeros(1, dtype=int))


def _stacked_cache(kv_f32, kv_dtype):
    """(jax cache, torch cache, per-layer kv_scale) in ``kv_dtype``."""
    if kv_dtype == "fp8":
        kj = jnp.asarray(kv_f32 * 0.5, jnp.float32).astype(jnp.float8_e4m3fn)
        scale = np.array([[1.0, 1.0], [0.5, 2.0]], np.float32)
    else:
        kj = jnp.asarray(kv_f32, jnp.bfloat16)
        scale = np.array([[1.0, 1.0], [1.0, 1.0]], np.float32)
    return kj, to_torch(kj), scale


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("qb", [8, 32])
def test_plain_matches_ragged_pallas_kernel(qb, kv_dtype):
    q, kv, pos, req, bt, sl = make_case([40, 1, 9], [0, 37, 64], layers=2,
                                        t_pad=56)
    kj, kt, scale = _stacked_cache(kv, kv_dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.ragged_paged_attention_kernel(
            jnp.asarray(q), kj, jnp.asarray(pos), jnp.asarray(req),
            jnp.asarray(bt), jnp.asarray(sl), qb=qb,
            kv_scale=jnp.asarray(scale), layer=jnp.asarray(1, jnp.int32)))
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(
        to_torch(q), kt, to_torch(pos), to_torch(req), to_torch(bt),
        to_torch(sl), qb=qb, kv_scale=to_torch(scale), layer=1).numpy()
    valid = req >= 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=TOL, rtol=TOL)
    assert not out[~valid].any()
    assert tra.ragged_attention_launches == 0      # the CPU path ran


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("qlen", [1, 3])
def test_plain_matches_grouped_pallas_kernel(qlen, kv_dtype):
    """Uniform decode, D=128: a dead slot (seq_lens 0), scattered pages."""
    rng = np.random.default_rng(11)
    L, NB, Bs, Hkv, D, Hq, B = 2, 24, 32, 2, 128, 4, 4
    n_comp = np.array([17, 0, 70, 5], np.int32)
    seq_lens = np.where(n_comp > 0, n_comp + qlen, 0).astype(np.int32)
    bt = np.zeros((B, 4), np.int32)
    pages = rng.permutation(np.arange(1, NB))
    k = 0
    for r in range(B):
        n = -(-int(seq_lens[r]) // Bs)
        bt[r, :n] = pages[k:k + n]
        k += n
    kv = rng.standard_normal((L, NB, 2, Bs, Hkv * D)).astype(np.float32)
    kj, kt, scale = _stacked_cache(kv, kv_dtype)
    q = rng.standard_normal((B * qlen, Hq, D)).astype(np.float32)
    pos_base = np.maximum(seq_lens - qlen, 0).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.grouped_decode_attention_kernel(
            jnp.asarray(q), kj, jnp.asarray(pos_base), jnp.asarray(bt),
            jnp.asarray(seq_lens), qlen=qlen, gsz=2,
            kv_scale=jnp.asarray(scale), layer=jnp.asarray(1, jnp.int32)))
    tra.reset_launch_counts()
    out = tra.grouped_decode_attention_kernel(
        to_torch(q), kt, to_torch(pos_base), to_torch(bt),
        to_torch(seq_lens), qlen=qlen, kv_scale=to_torch(scale),
        layer=1).numpy()
    live = np.repeat(seq_lens > 0, qlen)
    np.testing.assert_allclose(out[live], ref[live], atol=TOL, rtol=TOL)
    assert not out[~live].any()
    assert tra.grouped_decode_launches == 0


@pytest.mark.parametrize("t_rows", [2, 8, 12])
def test_grouped_cpu_path_fits_bucket_to_slots(t_rows):
    """The token bucket may be narrower or wider than B * qlen (the JAX
    dispatch's ``fit``): rows map to slot r // qlen, rows past the slots
    and dead slots are zero, and the result is the plain attention of
    those rows."""
    qlen, B = 2, 4
    q, kv, pos, req, bt, sl = make_case([2, 2, 2, 2], [5, 40, 0, 9], D=32)
    sl[2] = 0                                  # dead slot
    q = np.random.default_rng(3).standard_normal(
        (t_rows, 4, 32)).astype(np.float32)
    pos_base = np.maximum(sl - qlen, 0).astype(np.int32)
    tra.reset_launch_counts()
    out = tra.grouped_decode_attention_kernel(
        to_torch(q), to_torch(kv), to_torch(pos_base), to_torch(bt),
        to_torch(sl), qlen=qlen).numpy()
    rows = np.arange(t_rows)
    slot = rows // qlen
    live = (slot < B) & (sl[np.minimum(slot, B - 1)] > 0)
    rpos = pos_base[np.minimum(slot, B - 1)] + rows % qlen
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(rpos),
        jnp.asarray(np.where(live, slot, -1).astype(np.int32)),
        jnp.asarray(bt), jnp.asarray(sl)))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert out.shape == (t_rows, 4, 32)
    assert tra.grouped_decode_launches == 0


def uniform_case(qlen, D, Bs, n_comp, rng, L=2, Hkv=2, Hq=4,
                 scattered=True):
    """A uniform decode step: slot r at ``n_comp[r]`` cached tokens (0 =
    dead), ``qlen`` rows each; pages drawn in a scattered order (or
    consecutive)."""
    b = len(n_comp)
    seq_lens = np.where(n_comp > 0, n_comp + qlen, 0).astype(np.int32)
    need = [-(-int(s) // Bs) for s in seq_lens]
    nb = sum(need) + 2
    bt = np.zeros((b, max(need) + 1), np.int32)
    pages = (rng.permutation(np.arange(1, nb)) if scattered
             else np.arange(1, nb))
    k = 0
    for r, n in enumerate(need):
        bt[r, :n] = pages[k:k + n]
        k += n
    kv = rng.standard_normal((L, nb, 2, Bs, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((b * qlen, Hq, D)).astype(np.float32)
    pos_base = np.maximum(seq_lens - qlen, 0).astype(np.int32)
    return q, kv, pos_base, bt, seq_lens


@pytest.mark.parametrize("case", ["d32_f32_q4", "d128_bf16_q1",
                                  "d128_bf16_q4", "d128_fp8_q4",
                                  "d128_bf16_q4_contiguous",
                                  "d128_bf16_q4_wide"])
def test_plain_matches_decode_paged_pallas_kernel(case):
    """Kernel 4 (``decode_paged_attention_kernel``): the port's wrapper on
    CPU tensors (its plain version) against the JAX kernel in interpret
    mode: D=32 in float32 with 8-token pages (tests/test_kernels.py's
    shape), D=128 in bf16 at qlen 1 and 4, an e4m3 cache with per-layer
    [L, 2] scales; a dead slot and scattered block tables throughout, once
    consecutive ones (the TPU kernel's one-DMA run), and once 16 kv heads
    (Hkv * D = 2048 bf16 elements a token row, which the TPU kernel
    stages as any other width)."""
    rng = np.random.default_rng(21)
    d = 32 if case.startswith("d32") else 128
    qlen = 1 if "_q1" in case else 4
    bs = 8 if d == 32 else 32
    heads = dict(Hkv=16, Hq=32) if case.endswith("wide") else {}
    q, kv, pos_base, bt, sl = uniform_case(
        qlen, d, bs, np.array([40, 0, 300, 7], np.int32), rng,
        scattered=not case.endswith("contiguous"), **heads)
    if "f32" in case:
        kj, kt = jnp.asarray(kv), to_torch(kv)
        scale = np.ones((2, 2), np.float32)
    else:
        kj, kt, scale = _stacked_cache(kv, "fp8" if "fp8" in case
                                       else "bf16")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.decode_paged_attention_kernel(
            jnp.asarray(q), kj, jnp.asarray(pos_base), jnp.asarray(bt),
            jnp.asarray(sl), qlen, kv_scale=jnp.asarray(scale),
            layer=jnp.asarray(1, jnp.int32)))
    tra.reset_launch_counts()
    out = tra.decode_paged_attention_kernel(
        to_torch(q), kt, to_torch(pos_base), to_torch(bt), to_torch(sl),
        qlen, kv_scale=to_torch(scale), layer=1).numpy()
    live = np.repeat(sl > 0, qlen)
    np.testing.assert_allclose(out[live], ref[live], atol=TOL, rtol=TOL)
    assert not out[~live].any() and not ref[~live].any()
    assert tra.decode_paged_launches == 0          # the CPU path ran


@pytest.mark.parametrize("range_pages", [1, 2, 16, tra.RANGE_PAGES])
def test_range_plan_covers_every_page_once(range_pages):
    """Kernel 4's page ranges (``range_plan``, a function of the attended
    length and the range size only): every page of the sequence once, in
    order, in ranges of at most ``range_pages`` pages starting at
    multiples of it; the kernel's own count of ranges
    (``(last_slot // 32) // R + 1``) agrees."""
    for seq_len in list(range(1, 70)) + [511, 512, 513, 4096, 32768]:
        plan = tra.range_plan(seq_len, range_pages)
        pages = -(-seq_len // 32)
        assert [p for a, b in plan for p in range(a, b)] == list(
            range(pages))
        assert all(a % range_pages == 0 and 0 < b - a <= range_pages
                   for a, b in plan)
        assert len(plan) == ((seq_len - 1) // 32) // range_pages + 1


@pytest.mark.parametrize("range_pages", [2, tra.RANGE_PAGES])
def test_range_plan_does_not_depend_on_qlen_or_batch(range_pages):
    """The ranges a row attends are the same whether it is row j of a
    qlen-8 step or the single row of a qlen-1 step, and whichever other
    sequences share the batch: each is a range of the longer row's plan
    (the last one possibly cut short), so range boundaries never move."""
    rng = np.random.default_rng(3)
    batch = rng.integers(1, 5000, 16)
    plans = {int(p): tra.range_plan(int(p) + 8, range_pages) for p in batch}
    for p in batch[:8]:           # a smaller batch: the same plans
        assert tra.range_plan(int(p) + 8, range_pages) == plans[int(p)]
    for p, step in plans.items():
        for j in range(8):
            row = tra.range_plan(p + j + 1, range_pages)
            assert row[:-1] == step[:len(row) - 1]
            assert row[-1][0] == step[len(row) - 1][0]
            assert row[-1][1] <= step[len(row) - 1][1]


def test_plain_stops_at_the_block_table_end():
    """A uniform step near max_model_len gives rows past the limit a
    seq_len beyond the block table; the plain version reads the table's
    pages only, and the rows inside it are unchanged."""
    rng = np.random.default_rng(5)
    q, kv, pos_base, bt, sl = uniform_case(2, 32, 8, np.array([14, 30]),
                                           rng, L=1)
    args = [to_torch(x) for x in (q, kv[0], pos_base, bt)]
    full = tra.grouped_decode_attention_kernel(*args, to_torch(sl), qlen=2)
    over = sl.copy()
    over[1] += 3 * 8                     # 3 pages past the table's end
    out = tra.grouped_decode_attention_kernel(*args, to_torch(over), qlen=2)
    assert torch.equal(out, full)


def test_ragged_cpu_path_is_the_plain_version():
    q, kv, pos, req, bt, sl = map(to_torch, make_case([10, 3], [0, 50], D=32))
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(q, kv, pos, req, bt, sl, qb=8)
    ref = ragged_paged_attention_reference(q, kv, pos, req, bt, sl)
    assert torch.equal(out, ref)
    assert tra.ragged_attention_launches == 0
