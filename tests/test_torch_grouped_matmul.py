"""The grouped matmul of the MoE block and its host-free routing, against
the JAX package on the CPU.

- The plain version (``grouped_matmul_reference``, the CPU path of the
  kernel's wrapper) against ``jax.lax.ragged_dot`` over the stack that
  the JAX ``fp8_dequantize`` gives: bf16, fp8 (one scale, one per
  expert), int8 and int4 (packed and unpacked) weights, empty groups and
  counts that leave rows past the last group (zero in both).  Exact on
  integer-valued float32 inputs (every sum is exact, in any order), 1e-5
  on normal float32 inputs (float32 sums in another order) and 1e-2 on
  bf16 rows.
- ``ops/moe.py``: ``group_offsets`` equals the prefix sum of
  ``jnp.bincount``, ``sort_assignments`` the order of ``jnp.argsort``
  (stable, on assignments full of ties), ``route`` the JAX router.
- The launch plan: a pure function of ``(R, E, N)`` (no routing enters,
  and K is never split), at most ``ceil(R / BM) + E`` row tiles whose
  column tiles cover N once, and its walk (``tile_map``, the kernel's on
  the host) covers every row once, with the right expert, for every count
  vector of a seeded sweep; the plain product computed tile by tile along
  that walk equals the plain version exactly, also stage by stage as the
  kernel's producer addresses the weight, x and int4 group scales.
- ``weight_format`` takes what the kernel takes and refuses the rest.

The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu.ops import fp8 as jfp8
from arcticinference_tpu_torch.ops import moe
from arcticinference_tpu_torch.ops.cuda import grouped_matmul as gm
from arcticinference_tpu_torch.weights import params_from_jax


def offsets_of(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def jax_ragged(xs, w_deq, counts):
    return np.asarray(jax.lax.ragged_dot(
        jnp.asarray(xs), w_deq, jnp.asarray(counts, jnp.int32),
        preferred_element_type=jnp.float32))


def port_plain(xs, w, offsets):
    """The wrapper on CPU tensors (its plain version) for a port weight
    (a tensor or a QuantizedLinear)."""
    return moe.grouped_matmul(torch.from_numpy(np.asarray(xs)), w,
                              torch.from_numpy(offsets)).numpy()


# Count vectors over 4 experts of R = 24 rows: empty groups first, last
# and in the middle, one expert with every row, and sums short of R.
COUNTS = [(6, 6, 6, 6), (0, 10, 0, 14), (24, 0, 0, 0), (0, 0, 0, 24),
          (3, 0, 9, 2), (0, 0, 0, 0), (1, 1, 1, 1)]


@pytest.mark.parametrize("counts", COUNTS)
def test_plain_matches_ragged_dot_exact_on_integers(counts):
    rng = np.random.default_rng(sum(counts))
    r, e, k, n = 24, 4, 32, 16
    xs = rng.integers(-3, 4, (r, k)).astype(np.float32)
    w = rng.integers(-3, 4, (e, k, n)).astype(np.float32)
    want = jax_ragged(xs, jnp.asarray(w), counts)
    got = port_plain(xs, torch.from_numpy(w), offsets_of(counts))
    np.testing.assert_array_equal(got, want)
    assert not got[sum(counts):].any()


@pytest.mark.parametrize("counts", COUNTS[:5])
def test_plain_matches_ragged_dot_float32(counts):
    rng = np.random.default_rng(7)
    r, e, k, n = 24, 4, 64, 32
    xs = rng.standard_normal((r, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    want = jax_ragged(xs, jnp.asarray(w), counts)
    got = port_plain(xs, torch.from_numpy(w), offsets_of(counts))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def quantized_pair(w: np.ndarray, mode: str):
    """(JAX dequantized stack, port weight) of one quantization of the
    [E, K, N] stack ``w``: "fp8" one scale over the stack (a layer of a
    quantized [L, E, K, N] model), "fp8 expert" one per expert (the JAX
    quantizer on a lone [E, K, N] stack), "int8", "int4" (packed when K
    is a multiple of 128, else int4 values in int8)."""
    wj = jnp.asarray(w, jnp.bfloat16)
    if mode == "bf16":
        return wj, params_from_jax({"w": np.asarray(wj)}, "cpu")["w"]
    if mode == "fp8":
        q = jfp8.weight_quantize(wj[None], "fp8")
        q = jfp8.QuantizedLinear(q.weight[0], q.scale[0])
    else:
        q = jfp8.weight_quantize(wj, mode.split()[0])
    tq = params_from_jax({"w": jax.tree.map(np.asarray, q)}, "cpu")["w"]
    return jfp8.fp8_dequantize(q), tq


@pytest.mark.parametrize("mode,k", [
    ("bf16", 64), ("fp8", 64), ("fp8 expert", 64), ("int8", 64),
    ("int4", 256), ("int4", 64)])
@pytest.mark.parametrize("bf16_rows", [False, True])
def test_plain_matches_ragged_dot_quantized(mode, k, bf16_rows):
    """Dequantized to bf16 before the product, in both packages: float32
    rows agree to float32 rounding, bf16 rows within 1e-2."""
    rng = np.random.default_rng(k)
    r, e, n = 24, 4, 32
    counts = (5, 0, 11, 6)           # 2 rows past the last group
    xs = rng.standard_normal((r, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    w_deq, tw = quantized_pair(w, mode)
    if mode == "int4":
        packed = k % jfp8.INT4_GROUP == 0
        assert (tw.scale.dim() == tw.weight.dim()) == packed
    if bf16_rows:
        xj = jnp.asarray(xs, jnp.bfloat16)
        want = np.asarray(jax.lax.ragged_dot(
            xj, w_deq, jnp.asarray(counts, jnp.int32),
            preferred_element_type=jnp.float32))
        xt = params_from_jax({"x": np.asarray(xj)}, "cpu")["x"]
        got = moe.grouped_matmul(xt, tw, torch.from_numpy(
            offsets_of(counts))).numpy()
        tol = 1e-2
    else:
        want = jax_ragged(xs, w_deq, counts)
        got = port_plain(xs, tw, offsets_of(counts))
        tol = 1e-5
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not got[sum(counts):].any()


def test_dequantized_stack_equals_jax_bit_for_bit():
    """The stack the products read is the JAX ``fp8_dequantize``'s, bit
    for bit, in every format."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 256, 32)).astype(np.float32)
    for mode in ("fp8", "fp8 expert", "int8", "int4"):
        w_deq, tw = quantized_pair(w, mode)
        got = gm.dequantized(tw.weight, tw.scale)
        want = params_from_jax({"w": np.asarray(w_deq)}, "cpu")["w"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_group_offsets_and_stable_sort_match_jax():
    rng = np.random.default_rng(0)
    for t, k, e in ((13, 2, 8), (64, 2, 8), (40, 1, 4), (9, 3, 6)):
        # Few experts for many assignments: the sort is full of ties.
        top_i = rng.integers(0, e, (t, k)).astype(np.int32)
        flat = top_i.reshape(-1)
        order, sorted_e, tok = moe.sort_assignments(torch.from_numpy(top_i))
        np.testing.assert_array_equal(order.numpy(),
                                      np.asarray(jnp.argsort(flat)))
        np.testing.assert_array_equal(sorted_e.numpy(), np.sort(flat))
        np.testing.assert_array_equal(tok.numpy(),
                                      np.asarray(jnp.argsort(flat)) // k)
        offsets = moe.group_offsets(sorted_e, e)
        assert offsets.dtype == torch.int32
        want = np.concatenate([[0], np.cumsum(np.asarray(
            jnp.bincount(jnp.asarray(flat), length=e)))])
        np.testing.assert_array_equal(offsets.numpy(), want)


def test_route_matches_jax_router():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((11, 32)).astype(np.float32)
    wr = rng.standard_normal((32, 8)).astype(np.float32)
    logits = jnp.dot(jnp.asarray(x), jnp.asarray(wr))
    top_v, top_i = jax.lax.top_k(logits, 2)
    gate, ti = moe.route(torch.from_numpy(x), torch.from_numpy(wr), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(top_i))
    np.testing.assert_allclose(gate.numpy(),
                               np.asarray(jax.nn.softmax(top_v, axis=-1)),
                               rtol=1e-6, atol=1e-7)


def test_combine_sums_each_tokens_rows():
    """The inverse permutation puts each sorted row back at its (token,
    slot), and the slots are summed with their gate weights."""
    rng = np.random.default_rng(2)
    t, k, e, d = 10, 2, 4, 8
    top_i = torch.from_numpy(rng.integers(0, e, (t, k)))
    gate = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    order, _, tok = moe.sort_assignments(top_i)
    y = torch.from_numpy(rng.standard_normal((t * k, d)).astype(np.float32))
    want = torch.zeros((t, d))
    flat_gate = gate.reshape(-1)[order]
    want.index_add_(0, tok, y * flat_gate[:, None])
    torch.testing.assert_close(moe.combine(y, gate, order), want,
                               rtol=1e-6, atol=1e-6)


# The plan at the shapes the card runs (Mixtral-8x7B's experts, decode and
# prefill rows) and odd ones.
PLAN_SHAPES = [(128, 8, 14336), (128, 8, 4096), (512, 8, 14336),
               (4096, 8, 4096), (1, 8, 128), (7, 3, 256), (300, 16, 128),
               (64, 1, 128), (2000, 8, 384)]


@pytest.mark.parametrize("r,e,n", PLAN_SHAPES)
def test_launch_plan_is_a_function_of_the_sizes(r, e, n):
    """The plan takes the three sizes and nothing else (no offsets, no K
    split); its row tiles cover any routing, its column tiles N once."""
    import inspect

    assert list(inspect.signature(gm.launch_plan).parameters) == [
        "r", "e", "n"]
    bm, wgs, row_tiles, col_tiles = gm.launch_plan(r, e, n)
    assert (bm, wgs, row_tiles, col_tiles) == gm.launch_plan(r, e, n)
    assert bm in gm.ROW_TILES
    assert row_tiles == -(-r // bm) + e
    assert wgs in (1, 2) and (wgs == 1 or bm == 128)
    assert col_tiles * wgs * gm.BN == n


def test_launch_plan_at_mixtral_shapes():
    assert gm.launch_plan(128, 8, 14336) == (32, 1, 12, 112)  # decode
    assert gm.launch_plan(128, 8, 4096) == (32, 1, 12, 32)
    assert gm.launch_plan(4096, 8, 4096) == (128, 2, 40, 16)  # a chunk
    assert gm.launch_plan(4096, 8, 14336) == (128, 2, 40, 56)
    assert gm.launch_plan(256, 1, 384) == (128, 1, 3, 3)


def random_counts(rng, r, e):
    """A count vector summing to at most ``r``: uniform, skewed (most
    rows on one expert), some groups empty, or a short sum."""
    kind = rng.integers(0, 4)
    if kind == 0:
        return rng.multinomial(r, np.ones(e) / e)
    if kind == 1:
        p = np.full(e, 0.3 / max(e - 1, 1))
        p[rng.integers(0, e)] = 0.7 if e > 1 else 1.0
        return rng.multinomial(r, p / p.sum())
    if kind == 2:
        live = rng.random(e) < 0.5
        live[rng.integers(0, e)] = True
        c = rng.multinomial(r, live / live.sum())
        return c
    return rng.multinomial(int(rng.integers(0, r + 1)), np.ones(e) / e)


@pytest.mark.parametrize("r,e,n", PLAN_SHAPES)
def test_launch_plan_covers_every_row(r, e, n):
    """For every count vector of the sweep the walk gives each row to one
    tile: a group's rows to its expert, the rest to a zeroing tile."""
    rng = np.random.default_rng(17 + r + e)
    bm, _, row_tiles, _ = gm.launch_plan(r, e, n)
    for _ in range(40):
        counts = random_counts(rng, r, e)
        offs = offsets_of(counts)
        owner = np.full(r, -2)
        for kind, expert, row0, rows in gm.tile_map(
                offs.tolist(), r, bm, row_tiles):
            if kind == "exit":
                continue
            assert 0 < rows <= bm
            assert (owner[row0:row0 + rows] == -2).all()
            owner[row0:row0 + rows] = expert
        want = np.repeat(np.arange(e), counts)
        np.testing.assert_array_equal(owner[:len(want)], want)
        assert (owner[len(want):] == -1).all()


@pytest.mark.parametrize("counts", [(8, 0, 20, 2, 7), (40, 0, 0, 0, 0),
                                    (1, 2, 3, 4, 5)])
def test_tile_walk_computes_the_plain_product(counts):
    """The product computed tile by tile along the kernel's walk, each
    tile on its own rows, equals the plain version exactly."""
    rng = np.random.default_rng(4)
    r, e, k, n = 40, 5, 32, 16
    xs = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32))
    bm, _, row_tiles, _ = gm.launch_plan(r, e, n)
    offs = offsets_of(counts)
    want = gm.grouped_matmul_reference(xs, w, None, torch.from_numpy(offs))
    got = torch.full((r, n), float("nan"))
    for kind, expert, row0, rows in gm.tile_map(
            offs.tolist(), r, bm, row_tiles):
        if kind == "mma":
            got[row0:row0 + rows] = xs[row0:row0 + rows] @ w[expert]
        elif kind == "zero":
            got[row0:row0 + rows] = 0
    assert torch.equal(got, want)


def stage_walk(xs, q, offsets, mode, r, e, n):
    """The kernel's tiles stage by stage, on the host: each CTA's weight
    tile [64 (packed) rows, BN columns] of its expert at (n0, 64 t, e),
    its x tile [BM, 64] at (64 t, row0) (rows past R zero), int4's high
    half at K/2 + 64 t with the group-scale rows 64 t / 128 and (K/2 +
    64 t) / 128, every element bf16(float(w) * scale) before the product;
    only the tile's own rows stored."""
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    bm, wgs, row_tiles, col_tiles = gm.launch_plan(r, e, n)
    bn = wgs * gm.BN
    w, scale = (q.weight, q.scale) if isinstance(q, QuantizedLinear) \
        else (q, None)
    k = xs.shape[1]
    packed = mode == "int4"
    xpad = torch.cat([xs.float(), torch.zeros((bm, k))])
    out = torch.full((r, n), float("nan"))
    for kind, expert, row0, rows in gm.tile_map(
            offsets.tolist(), r, bm, row_tiles):
        for ct in range(col_tiles):
            cols = slice(ct * bn, ct * bn + bn)
            if kind == "zero":
                out[row0:row0 + rows, cols] = 0
            if kind != "mma":
                continue
            acc = torch.zeros((bm, bn))
            for t in range((k // 2 if packed else k) // gm.KS):
                raw = w[expert, t * gm.KS:(t + 1) * gm.KS, cols]
                if packed:
                    b = raw.to(torch.int32) & 0xFF
                    lo = ((b << 28).to(torch.int32) >> 28).float()
                    hi = ((b << 24).to(torch.int32) >> 28).float()
                    glo = t * gm.KS // gm.GROUP
                    ghi = (k // 2 + t * gm.KS) // gm.GROUP
                    parts = ((lo * scale[expert, glo, cols], t * gm.KS),
                             (hi * scale[expert, ghi, cols],
                              k // 2 + t * gm.KS))
                elif mode == "int8":
                    parts = ((raw.float() * scale[expert, cols], t * gm.KS),)
                elif mode == "fp8":
                    parts = ((raw.float() * scale.reshape(()), t * gm.KS),)
                else:
                    parts = ((raw.float(), t * gm.KS),)
                for wd, c0 in parts:
                    wd = wd.to(torch.bfloat16).float()
                    acc += xpad[row0:row0 + bm, c0:c0 + gm.KS] @ wd
            out[row0:row0 + rows, cols] = acc[:rows]
    return out


@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "int4"])
def test_stage_walk_computes_the_plain_product(mode):
    """A host model of the kernel's addressing, stage by stage
    (:func:`stage_walk`), equals the plain version exactly on
    integer-valued rows and weights quantized with power-of-two scales
    (every sum exact in any order): the 3-D weight tile, the x tile at the
    tile's row0, int4's halves and group-scale rows, the scale folded in
    before the product.  It documents the addressing; the kernel itself
    is held to the plain version by the card tests."""
    # An empty group, a group over two 32-row tiles, a row past offsets[E].
    counts = (9, 0, 35, 2)
    from arcticinference_tpu_torch.models.mixtral import quantize_experts
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    rng = np.random.default_rng(len(mode) + sum(counts))
    r, e, k, n = 47, 4, 512, 256
    xs = torch.from_numpy(rng.integers(-2, 3, (r, k)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-7, 8, (e, k, n)).astype(np.float32))
    if mode == "bf16":
        q = w.to(torch.bfloat16)
    else:
        q = quantize_experts(w, mode)
        q = QuantizedLinear(q.weight, torch.exp2(torch.round(
            torch.log2(q.scale))))
    offs = torch.from_numpy(offsets_of(counts))
    want = gm.grouped_matmul_reference(xs, q.weight if mode != "bf16"
                                       else q, None if mode == "bf16"
                                       else q.scale, offs)
    got = stage_walk(xs, q, offs, mode, r, e, n)
    assert torch.equal(got, want)
    assert want[:sum(counts)].abs().max() > 0
    assert not got[sum(counts):].any()


def test_clamped_offsets():
    assert gm.clamped_offsets([3, 2, 9, 5, 40], 20) == [0, 2, 9, 9, 20]


def test_weight_format_takes_the_kernels_formats():
    """The layouts ``quantize_experts`` gives (and bf16); the rest is
    refused, per-expert fp8 scales among them."""
    from arcticinference_tpu_torch.models.mixtral import quantize_experts

    e, k, n = 4, 256, 128
    bf = torch.zeros((e, k, n), dtype=torch.bfloat16)
    assert gm.weight_format(bf, None) == (gm._BF16, k)
    for mode, fmt in (("fp8", gm._E4M3), ("int8", gm._INT8),
                      ("int4", gm._INT4)):
        q = quantize_experts(torch.randn((e, k, n)), mode)
        assert gm.weight_format(q.weight, q.scale) == (fmt, k)
    f8 = torch.zeros((e, k, n), dtype=torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        gm.weight_format(bf.float(), None)
    with pytest.raises(ValueError):
        gm.weight_format(f8, torch.ones(e))
    with pytest.raises(ValueError):
        gm.weight_format(torch.zeros((e, k // 2, n), dtype=torch.int8),
                         torch.ones(e, 3, n))
    with pytest.raises(ValueError):
        gm.weight_format(bf[0], None)
