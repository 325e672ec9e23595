"""The port's weight-stream matmul variants against the JAX microbench.

``ops/cuda/stream_matmul.py`` ports ``benchmarks/stream_microbench.py``'s
``make_pallas_body`` and its three kernel bodies.  Here:

- every one of the 256 weight bytes, per variant, dequantizes exactly as
  the JAX expression of that variant (the f16 trick and the bit trick map
  e4m3's NaN codes to +-480, ``astype`` keeps NaN: NaN compares equal to
  NaN);
- the plain versions (what the wrapper computes for CPU tensors) against
  the Pallas kernels run in interpret mode on the CPU, weights drawn by
  the microbench's own ``gen_ws``: bf16 outputs within one bf16 ulp (both
  sum float32 products, in another order);
- the CUDA-only checks of the wrapper do not run for CPU tensors.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu_torch.ops.cuda import stream_matmul as sm


def _load_microbench():
    """``benchmarks/stream_microbench.py`` by path (``tests/benchmarks``
    shadows the repository's ``benchmarks`` directory as a package)."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "stream_microbench.py"
    spec = importlib.util.spec_from_file_location("jax_stream_microbench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jsm = _load_microbench()

CODES = np.arange(256, dtype=np.uint8)


def jax_dequant(variant: str) -> np.ndarray:
    """Each variant's bf16 value of every byte, as the JAX kernel body
    writes it (``pltpu.bitcast`` as ``lax.bitcast_convert_type``)."""
    w8 = jnp.asarray(CODES.view(np.int8))
    if variant == "f16trick":                      # stream_microbench.py:104
        u = jax.lax.bitcast_convert_type(w8, jnp.uint8).astype(jnp.uint16)
        h = jax.lax.bitcast_convert_type(((u & 0x80) << 8)
                                         | ((u & 0x7F) << 7), jnp.float16)
        wt = (h.astype(jnp.float32) * 256.0).astype(jnp.bfloat16)
    elif variant == "bittrick":                    # stream_microbench.py:139
        u = w8.astype(jnp.int32) & 0xFF
        mag = u & 0x7F
        sign = (u & 0x80) << 24
        normal = jax.lax.bitcast_convert_type(
            sign | ((mag << 20) + (120 << 23)), jnp.float32)
        sub = jnp.where(u >= 0x80, -1.0, 1.0) * (mag.astype(jnp.float32)
                                                 * jnp.float32(2.0 ** -9))
        wt = jnp.where(mag < 8, sub, normal).astype(jnp.bfloat16)
    elif variant == "astype_e4m3":                 # stream_microbench.py:121
        wt = jnp.asarray(CODES).view(jnp.float8_e4m3fn).astype(jnp.bfloat16)
    else:
        wt = w8.astype(jnp.bfloat16)
    return np.asarray(wt.astype(jnp.float32))


def torch_weight(codes: np.ndarray, variant: str) -> torch.Tensor:
    t = torch.from_numpy(codes.view(np.int8).copy())
    return t.view(torch.float8_e4m3fn) if variant == "astype_e4m3" else t


@pytest.mark.parametrize("variant", sm.VARIANTS)
def test_every_code_dequantizes_as_jax(variant):
    got = sm.dequant(torch_weight(CODES, variant), variant)
    got = got.to(torch.bfloat16).float().numpy()
    want = jax_dequant(variant)
    np.testing.assert_array_equal(got, want)
    # Signed zeros too (0x80 is -0.0 in every e4m3 reading); a NaN's sign
    # is not part of the value.
    real = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[real]),
                                  np.signbit(want[real]))
    if variant in ("f16trick", "bittrick"):
        assert got[0x7F] == 480.0 and got[0xFF] == -480.0
    elif variant == "astype_e4m3":
        assert np.isnan(got[0x7F]) and np.isnan(got[0xFF])


def within_one_bf16_ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| at most one bf16 ulp of the larger magnitude."""
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(a - b) <= ulp


# (kernel body, gen_ws dtype) per variant.
BODIES = {
    "f16trick": (jsm._mm_kernel_f16trick, "fp8asint8"),
    "bittrick": (jsm._mm_kernel_bittrick_i32, "fp8asint8"),
    "astype_e4m3": (jsm._mm_kernel_astype, "fp8"),
    "astype_int8": (jsm._mm_kernel_astype, "int8"),
}


@functools.lru_cache(maxsize=None)
def layer0(k: int, n: int, dt: str) -> np.ndarray:
    """Layer 0 of the microbench's ``gen_ws`` weights, as raw bytes."""
    ws = jsm.gen_ws(jax.random.PRNGKey(1), k, n, dt)
    return np.asarray(jax.lax.bitcast_convert_type(ws[0], jnp.uint8))


@pytest.mark.parametrize("variant", sm.VARIANTS)
@pytest.mark.parametrize("m,k,n", [(16, 256, 256), (64, 512, 256)])
def test_plain_matches_pallas_body(variant, m, k, n):
    kernel, dt = BODIES[variant]
    wbytes = layer0(k, n, dt)
    x = (np.random.default_rng(k + n + m).standard_normal((m, k))
         .astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(wbytes)
    wj = (wj.view(jnp.float8_e4m3fn) if variant == "astype_e4m3"
          else wj.view(jnp.int8))
    body = jsm.make_pallas_body(kernel, m, k, n, 128, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(body(xj, wj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = sm.stream_matmul_kernel(xt, torch_weight(wbytes, variant), variant)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    assert np.isfinite(want).all()
    ok = within_one_bf16_ulp(got, want)
    assert ok.all(), (np.abs(got - want).max(), int((~ok).sum()))


def test_unknown_variant_raises():
    x = torch.zeros((16, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="variant"):
        sm.stream_matmul_kernel(x, w, "cvt")
    with pytest.raises(ValueError, match="variant"):
        sm.dequant(w, "cvt")


def test_counts_only_kernel_launches():
    """A CPU tensor runs the plain version: no launch is counted."""
    sm.reset_launch_counts()
    x = torch.zeros((16, 64), dtype=torch.bfloat16)
    sm.stream_matmul_kernel(x, torch.zeros((64, 128), dtype=torch.int8),
                            "astype_int8")
    assert sm.stream_matmul_launches == 0
