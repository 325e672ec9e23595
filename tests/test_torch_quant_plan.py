"""The quantized matmul kernels' launch plan and a plain model of their
float32 summation order, on the CPU.

- ``launch_plan`` (``ops/cuda/fp8_matmul.py``) at every Llama-3.1-8B
  weight shape the engine multiplies and at 1-2048 rows on 132 SMs (an
  H100 SXM): the tiles cover N, every K split is non-empty and contiguous,
  the split fits one thread-block cluster, the grid fills the card's CTA
  slots at most once when it splits, and the plan is the same for every
  row count of one bucket.
- The kernels' summation order (``csrc/quant_wgmma.cuh``): each split of
  the plan sums its K range in float32, the splits' partials are added in
  rank order, the scale multiplies the sums in the epilogue and int4 folds
  its group scale into the bf16 weight, bf16(q * s).  That model, at full
  K (4096 and 14336) and N = 256, against the port's plain versions
  (||model - plain|| <= 1e-3 ||plain||: only the order of the float32 sums
  differs) and against the JAX Pallas ``fp8_matmul_kernel`` and
  ``int4_matmul_kernel`` in interpret mode (atol = rtol = 2e-2 of the
  outputs' scale, the bound ``tests/test_torch_quant.py`` holds the plain
  versions to; the int4 Pallas kernel scales its float32 partial sums
  where the port rounds bf16(q * s)).
- Kernel 8 (``ops/cuda/stream_matmul.py``) runs kernel 5's pipeline and
  plan with no scale: its plan is kernel 5's at the stream microbench's
  five shapes, and the same summation model on each variant's
  dequantized weight is within one bf16 ulp of each Pallas body of
  ``benchmarks/stream_microbench.py`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu.ops import fp8 as jfp8
from arcticinference_tpu.ops.pallas.fp8_matmul import (
    fp8_matmul_kernel as jax_fp8_kernel)
from arcticinference_tpu.ops.pallas.int4_matmul import (
    int4_matmul_kernel as jax_int4_kernel)
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda import fp8_matmul as tfm
from arcticinference_tpu_torch.ops.cuda import int4_matmul as tim
from arcticinference_tpu_torch.ops.cuda import stream_matmul as tsm

from tests.test_torch_stream_matmul import (BODIES, jsm, layer0,
                                            torch_weight,
                                            within_one_bf16_ulp)

SMS = 132  # H100 SXM
# Llama-3.1-8B's quantized products: (K, N).
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w_gateup": (4096, 28672), "w_down": (14336, 4096),
          "lm_head": (4096, 128256)}
# Decode batches, verify rows of the fused steps, a prefill chunk, and
# row counts inside buckets.
ROWS = (1, 16, 40, 64, 128, 200, 256, 2048)
REL_TOL = 1e-3
TOL = 2e-2


def k_tiles(k: int, fmt: str) -> int:
    """Weight stages along K: 64 rows of bytes (packed rows for int4)."""
    return (k // 2 if fmt == "int4" else k) // tfm.BKW


def split_ranges(tiles: int, splits: int) -> list[tuple[int, int]]:
    """The stages [start, end) of each split, as the kernel takes them."""
    per = -(-tiles // splits)
    return [(s * per, min(tiles, (s + 1) * per)) for s in range(splits)]


def row_bucket(m: int) -> tuple[int, int]:
    """The rows the plan may see of m: its row tile and the tile count."""
    bm = next((b for b in tfm.ROW_TILES if m <= b), tfm.ROW_TILES[-1])
    return bm, -(-m // bm)


def bucket_bounds(m: int) -> tuple[int, int]:
    """The first and last row count of m's bucket."""
    bm, tiles = row_bucket(m)
    smaller = [b for b in tfm.ROW_TILES if b < bm]
    return (max((smaller[-1] if smaller else 0) + 1, (tiles - 1) * bm + 1),
            tiles * bm)


@pytest.mark.parametrize("fmt", ["fp8", "int4"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_launch_plan_covers_the_output(name, m, fmt):
    k, n = SHAPES[name]
    tiles = k_tiles(k, fmt)
    bm, wgs, kwgs, splits = tfm.launch_plan(m, n, tiles, SMS)
    assert (bm, -(-m // bm)) == row_bucket(m)
    # The kernel's instances: two consumer warpgroups at most, side by
    # side only at 128 rows.
    assert (wgs, kwgs) in ((1, 1), (1, 2)) or (wgs, kwgs, bm) == (2, 1, 128)
    assert n % (tfm.BN * wgs) == 0                     # tiles cover N
    assert 1 <= splits <= tfm.MAX_SPLITS               # one cluster
    ranges = split_ranges(tiles, splits)
    assert all(b > a for a, b in ranges)               # none empty
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    if splits > 1:
        assert kwgs == 2
        assert all(b - a >= kwgs * tfm.MIN_SPLIT_STAGES
                   for a, b in ranges[:-1])
        ctas = -(-m // bm) * (n // (tfm.BN * wgs))
        assert ctas * splits <= SMS                    # one wave
    # The plan sees only the bucket: the bucket's first and last row
    # counts get the same plan.
    for other in bucket_bounds(m):
        assert row_bucket(other) == row_bucket(m)
        assert tfm.launch_plan(other, n, tiles, SMS) == (bm, wgs, kwgs,
                                                         splits)


def test_launch_plan_splits_small_grids():
    """The 8B's decode shapes with few column tiles are split in three
    (wqkv in two) over CTAs of two K warpgroups; the wide ones are not
    (w_gateup, lm_head), and a 2048-row prefill takes 256-column tiles."""
    assert tfm.launch_plan(64, 4096, 64, SMS) == (64, 1, 2, 3)      # wo
    assert tfm.launch_plan(64, 6144, 64, SMS) == (64, 1, 2, 2)      # wqkv
    assert tfm.launch_plan(64, 4096, 224, SMS) == (64, 1, 2, 3)     # w_down
    assert tfm.launch_plan(64, 28672, 64, SMS) == (64, 1, 1, 1)     # gateup
    assert tfm.launch_plan(64, 128256, 64, SMS) == (64, 1, 1, 1)    # head
    assert tfm.launch_plan(2048, 28672, 64, SMS) == (128, 2, 1, 1)
    assert tfm.launch_plan(256, 4096, 64, SMS) == (128, 1, 2, 2)
    assert tfm.launch_plan(16, 384, 16, SMS) == (16, 1, 2, 2)


def quantized(fmt: str, k: int, n: int, seed: int):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)
    return w, tfp8.weight_quantize(torch.from_numpy(w), fmt)


def dequantized(fmt: str, q) -> torch.Tensor:
    """The bf16 weight values the kernel multiplies, as float32 [K, N]."""
    if fmt == "int4":
        k = 2 * q.weight.shape[0]
        w4 = tfp8._unpack_int4(q.weight).float()
        wg = w4.reshape(k // tim.GROUP, tim.GROUP, -1) * q.scale[:, None, :]
        return wg.reshape(k, -1).to(torch.bfloat16).float()
    return q.weight.float()


def kernel_model(fmt: str, x: torch.Tensor, q, m_plan: int) -> torch.Tensor:
    """The kernel's float32 result: in each split of the plan, K
    warpgroup w sums the split's stages w, w + kwgs, ...; the split's
    partial is warpgroup 0's sum plus warpgroup 1's; the partials are
    added in rank order, then scaled (fp8 / int8)."""
    k = x.shape[1]
    n = q.weight.shape[1]
    tiles = k_tiles(k, fmt)
    _, _, kwgs, splits = tfm.launch_plan(m_plan, n, tiles, SMS)
    xf = x.to(torch.bfloat16).float()
    wd = dequantized(fmt, q)

    def stage_rows(t):
        rows = torch.arange(t * tfm.BKW, (t + 1) * tfm.BKW)
        if fmt == "int4":  # a packed stage feeds both halves of K
            rows = torch.cat([rows, rows + k // 2])
        return rows

    acc = None
    for t0, t1 in split_ranges(tiles, splits):
        part = None
        for w in range(kwgs):
            rows = torch.cat([stage_rows(t) for t in range(t0 + w, t1, kwgs)])
            wsum = xf[:, rows] @ wd[rows]
            part = wsum if part is None else part + wsum
        acc = part if acc is None else acc + part
    if fmt == "int4":
        return acc
    scale = q.scale if q.scale.dim() == 1 else q.scale.reshape(())
    return acc * scale


@pytest.mark.parametrize("m", [16, 200])
@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("fmt", ["fp8", "int8", "int4"])
def test_summation_model_matches_plain(fmt, k, m):
    """The largest split at N = 256 (one or two row tiles), two K
    warpgroups: the model against the plain version at 1e-3 of its norm,
    float32 and bf16 out."""
    n = 256
    assert tfm.launch_plan(m, n, k_tiles(k, fmt), SMS)[2:] == (
        2, tfm.MAX_SPLITS)
    _, q = quantized(fmt, k, n, seed=k + m)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (m, k)).astype(np.float32)).to(torch.bfloat16)
    got = kernel_model(fmt, x, q, m)
    plain = (tim.int4_matmul_reference if fmt == "int4"
             else tfm.fp8_matmul_reference)
    for out_dtype in (torch.float32, torch.bfloat16):
        want = plain(x, q.weight, q.scale, out_dtype).float()
        o = got.to(out_dtype).float()
        assert float((o - want).norm() / want.norm()) <= REL_TOL


@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("fmt", ["fp8", "int4"])
def test_summation_model_matches_pallas_kernel(fmt, k):
    """The model against the JAX Pallas kernel in interpret mode, 16
    rows, N = 256 (the TPU fp8 kernel takes a scalar scale)."""
    n, m = 256, 16
    w, q = quantized(fmt, k, n, seed=k)
    x = np.random.default_rng(2).standard_normal((m, k)).astype(np.float32)
    if fmt == "int4":
        jq = jfp8.int_quantize(jnp.asarray(w), bits=4)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_int4_kernel(jnp.asarray(x), jq.weight,
                                              jq.scale, out_dtype=jnp.float32))
    else:
        jq = jfp8.fp8_quantize(jnp.asarray(w))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_fp8_kernel(
                jnp.asarray(x, jnp.bfloat16), jq.weight, jq.scale,
                out_dtype=jnp.float32))
    got = kernel_model(fmt, torch.from_numpy(x), q, m).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


# ---- kernel 8: the weight-stream variants on kernel 5's pipeline ------------

# The stream microbench's five shapes (K, N), 64 rows.
STREAM_SHAPES = {"gateup": (4096, 14336), "down": (14336, 4096),
                 "qo": (4096, 4096), "gateup-fused": (4096, 28672),
                 "qkv-fused": (4096, 6144)}


@pytest.mark.parametrize("name", list(STREAM_SHAPES))
def test_stream_plan_is_kernel5_plan(name):
    """Kernel 8 launches kernel 5's plan for the same product (its own
    plan and split-K workspace are gone)."""
    k, n = STREAM_SHAPES[name]
    assert tsm.plan(64, n, k, SMS) == tfm.launch_plan(64, n, k // tfm.BKW,
                                                      SMS)


def stream_model(x: torch.Tensor, wd: torch.Tensor, m_plan: int
                 ) -> torch.Tensor:
    """Kernel 8's float32 result without a scale: kernel 5's summation
    order (:func:`kernel_model`) on the weight's dequantized values."""
    k, n = wd.shape
    tiles = k // tfm.BKW
    _, _, kwgs, splits = tfm.launch_plan(m_plan, n, tiles, SMS)
    xf = x.to(torch.bfloat16).float()
    acc = None
    for t0, t1 in split_ranges(tiles, splits):
        part = None
        for w in range(kwgs):
            rows = torch.cat([torch.arange(t * tfm.BKW, (t + 1) * tfm.BKW)
                              for t in range(t0 + w, t1, kwgs)])
            wsum = xf[:, rows] @ wd[rows]
            part = wsum if part is None else part + wsum
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("variant", ["f16trick", "bittrick", "astype_e4m3",
                                     "astype_int8"])
def test_stream_model_matches_pallas_body(variant):
    """The summation model of kernel 8 (64 rows, K = 4096 split three
    ways over two K warpgroups, N = 256) against the microbench's Pallas
    body of the variant in interpret mode, weights from its ``gen_ws``:
    bf16 outputs within one bf16 ulp (only the order of the float32 sums
    differs)."""
    m, k, n = 64, 4096, 256
    assert tfm.launch_plan(m, n, k // tfm.BKW, SMS)[2:] == (2, 3)
    kernel, dt = BODIES[variant]
    wbytes = layer0(k, n, dt)
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(wbytes)
    wj = (wj.view(jnp.float8_e4m3fn) if variant == "astype_e4m3"
          else wj.view(jnp.int8))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsm.make_pallas_body(kernel, m, k, n, 512, 128)(
            xj, wj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    wd = tsm.dequant(torch_weight(wbytes, variant), variant).to(
        torch.bfloat16).float()
    got = stream_model(xt, wd, m).to(torch.bfloat16).float().numpy()
    assert np.isfinite(want).all()
    ok = within_one_bf16_ulp(got, want)
    assert ok.all(), (np.abs(got - want).max(), int((~ok).sum()))
