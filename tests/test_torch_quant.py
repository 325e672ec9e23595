"""The port's weight-only quantization against the JAX package's, on the
same numpy inputs.

- Quantizers (``fp8_quantize``, ``int_quantize`` for 8 and 4 bits,
  packed and unpacked, the split-half nibble packing), ``fuse_quantized``
  and ``fp8_dequantize``: the bytes and scales are exactly equal (the
  same float32 division, clamp and round-to-nearest-even in both).
- The two matmul kernels' plain versions: the fp8 one against the JAX
  Pallas ``fp8_matmul_kernel`` in interpret mode (relative 1e-5: only the
  order of the float32 sums differs) and against the JAX ``matmul`` with
  per-column scales; the int4 one against the JAX
  ``int4_matmul_reference`` (bf16 outputs within one bf16 ulp) and the
  JAX Pallas ``int4_matmul_kernel`` in interpret mode (relative 2e-2, the
  bound ``tests/test_kernels.py`` holds that kernel to: it scales its
  float32 partial sums where the reference dequantizes to bf16 first).
- Quantized parameters: ``quantize_params``, ``params_from_jax``,
  pre-quantized fp8 and quantizing ``load_hf_state``.
- The fp8-KV calibration (``LLM.calibrate_kv_scales``).
- The build names a library by its source and every shared header.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import KVCalibrationMixin
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.models import llama as jllama
from arcticinference_tpu.ops import fp8 as jfp8
from arcticinference_tpu.ops.pallas.fp8_matmul import (
    fp8_matmul_kernel as jax_fp8_kernel)
from arcticinference_tpu.ops.pallas.int4_matmul import (
    int4_matmul_kernel as jax_int4_kernel,
    int4_matmul_reference as jax_int4_reference)
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.llm import LLM, fp8_kv_scales
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda import build
from arcticinference_tpu_torch.ops.cuda import fp8_matmul as tfm
from arcticinference_tpu_torch.ops.cuda import int4_matmul as tim
from arcticinference_tpu_torch.weights import params_from_jax

MODES = ("fp8", "int8", "int4")
# One bf16 ulp at |v| is at most 2^-7 |v| (8 significant bits).
BF16_ULP = 2.0 ** -7


def raw(a) -> np.ndarray:
    """Bytes of a torch tensor or JAX / numpy array (fp8 as uint8)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            a = a.view(torch.uint8)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def assert_same_quantized(t, j):
    assert isinstance(t, tfp8.QuantizedLinear)
    assert isinstance(j, jfp8.QuantizedLinear)
    assert tuple(t.weight.shape) == tuple(j.weight.shape)
    assert tuple(t.scale.shape) == tuple(j.scale.shape)
    assert str(t.weight.dtype).split(".")[-1] == str(j.weight.dtype)
    np.testing.assert_array_equal(raw(t.weight), raw(j.weight))
    np.testing.assert_array_equal(raw(t.scale), raw(j.scale))


def both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def weights(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Quantizers, fusion, dequantization: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 96), (3, 256, 96), (2, 96, 64)])
@pytest.mark.parametrize("mode", MODES)
def test_weight_quantize_is_exact(mode, shape, dtype):
    """(2, 96, 64) has an input dim that is not a multiple of 128: int4
    keeps its values unpacked in int8 with per-column scales."""
    j, t = both(weights(shape, seed=len(shape)), dtype)
    tq, jq = tfp8.weight_quantize(t, mode), jfp8.weight_quantize(j, mode)
    assert_same_quantized(tq, jq)
    packed = mode == "int4" and shape[-2] % 128 == 0
    assert tq.weight.shape[-2] == (shape[-2] // 2 if packed else shape[-2])


@pytest.mark.parametrize("mode", MODES)
def test_quantize_layers_equals_the_whole_stack(mode):
    w = torch.from_numpy(weights((3, 256, 128), seed=5))
    a, b = tfp8.quantize_layers(w, mode), tfp8.weight_quantize(w, mode)
    np.testing.assert_array_equal(raw(a.weight), raw(b.weight))
    np.testing.assert_array_equal(raw(a.scale), raw(b.scale))


def test_int4_packing_is_split_half():
    """Byte row u holds row u (low nibble) and row u + K/2 (high)."""
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, (2, 256, 16)).astype(np.int8)
    packed_t = tfp8._pack_int4(torch.from_numpy(q))
    packed_j = jfp8._pack_int4(jnp.asarray(q))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    b = packed_t.numpy().astype(np.uint8)
    lo = ((b & 0x0F).astype(np.int8) << 4) >> 4
    hi = b.astype(np.int8) >> 4
    np.testing.assert_array_equal(lo, q[:, :128])
    np.testing.assert_array_equal(hi, q[:, 128:])
    np.testing.assert_array_equal(tfp8._unpack_int4(packed_t).numpy(), q)
    np.testing.assert_array_equal(
        tfp8._unpack_int4(packed_t).numpy(),
        np.asarray(jfp8._unpack_int4(packed_j)))


@pytest.mark.parametrize("mode", MODES)
def test_fuse_and_dequantize_are_exact(mode):
    """q|k|v parts of a 2-layer stack, quantized and fused in both
    packages; per-tensor scales become per-column scales over each part."""
    parts = [weights((2, 256, n), seed=n) for n in (128, 64, 64)]
    jq = [jfp8.weight_quantize(jnp.asarray(p), mode) for p in parts]
    tq = [tfp8.weight_quantize(torch.from_numpy(p), mode) for p in parts]
    jf, tf = jfp8.fuse_quantized(jq), tfp8.fuse_quantized(tq)
    assert_same_quantized(tf, jf)
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            tfp8.fp8_dequantize(tf, getattr(torch, dtype)).float().numpy(),
            np.asarray(jfp8.fp8_dequantize(jf, getattr(jnp, dtype)),
                       np.float32))
        np.testing.assert_array_equal(
            tfp8.fp8_dequantize(tq[0], getattr(torch, dtype)).float().numpy(),
            np.asarray(jfp8.fp8_dequantize(jq[0], getattr(jnp, dtype)),
                       np.float32))
    # Each part's columns dequantize to exactly the part.
    full = tfp8.fp8_dequantize(tf, torch.float32)
    np.testing.assert_array_equal(
        full[..., 128:192].numpy(),
        tfp8.fp8_dequantize(tq[1], torch.float32).numpy())
    # The shard-interleaved order (ported; it raised before) is JAX's.
    assert_same_quantized(tfp8.fuse_quantized(tq, interleave=2),
                          jfp8.fuse_quantized(jq, interleave=2))
    with pytest.raises(ValueError):
        tfp8.fuse_quantized([tq[0], torch.from_numpy(parts[1])])


def test_quantized_linear_slices_a_layer():
    w = torch.from_numpy(weights((3, 256, 128), seed=9))
    for mode, scale_shape in (("fp8", ()), ("int8", (128,)),
                              ("int4", (2, 128))):
        q = tfp8.weight_quantize(w, mode)
        layer = q[1]
        assert tuple(layer.scale.shape) == scale_shape
        assert layer.shape == q.shape[1:]
        assert layer.out_features == 128
        assert q.nbytes == q.weight.nbytes + q.scale.nbytes
        moved = q.to("cpu")
        assert torch.equal(moved.scale, q.scale)
        np.testing.assert_array_equal(
            tfp8.fp8_dequantize(layer, torch.float32).numpy(),
            tfp8.fp8_dequantize(q, torch.float32)[1].numpy())


# ---------------------------------------------------------------------------
# The two matmul kernels' plain versions
# ---------------------------------------------------------------------------

def test_fp8_plain_matches_pallas_kernel():
    """As tests/test_kernels.py runs the Pallas kernel (K=256, N=128,
    float32 out); the wrapper given CPU tensors is the plain version."""
    x = weights((16, 256), seed=1)
    w = weights((256, 128), seed=2)
    jq = jfp8.fp8_quantize(jnp.asarray(w))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fp8_kernel(
            jnp.asarray(x, jnp.bfloat16), jq.weight, jq.scale,
            out_dtype=jnp.float32))
    tq = tfp8.fp8_quantize(torch.from_numpy(w))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tfm.reset_launch_counts()
    got = tfm.fp8_matmul_kernel(xt, tq.weight, tq.scale, torch.float32)
    assert tfm.fp8_matmul_launches == 0
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), tfm.fp8_matmul_reference(xt, tq.weight, tq.scale,
                                              torch.float32).numpy())
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["fp8", "fp8_fused", "int8", "int4",
                                  "int4_unpacked"])
def test_matmul_matches_jax_matmul(case, out_dtype):
    """The dispatch of ``matmul`` on every scale granularity, against the
    JAX ``matmul`` (its CPU path): float32 out within 1e-5 of the largest
    output (the order of the float32 sums), bf16 out within one ulp."""
    k = 96 if case == "int4_unpacked" else 256
    x = weights((12, k), seed=3)
    if case == "fp8_fused":
        parts = [weights((k, n), seed=n) for n in (128, 128)]
        jq = jfp8.fuse_quantized([jfp8.fp8_quantize(jnp.asarray(p))
                                  for p in parts])
        tq = tfp8.fuse_quantized([tfp8.fp8_quantize(torch.from_numpy(p))
                                  for p in parts])
        assert tq.scale.shape == (256,)
    else:
        w = weights((k, 256), seed=4)
        mode = case.split("_")[0]
        jq = jfp8.weight_quantize(jnp.asarray(w), mode)
        tq = tfp8.weight_quantize(torch.from_numpy(w), mode)
    xj, xt = both(x, "bfloat16")
    want = np.asarray(jfp8.matmul(xj, jq, getattr(jnp, out_dtype)),
                      np.float32)
    got = tfp8.matmul(xt, tq, getattr(torch, out_dtype)).float().numpy()
    if out_dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert (np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6).all()
    ref = tfp8.matmul_reference(xt, tq, getattr(torch, out_dtype))
    np.testing.assert_array_equal(ref.float().numpy(), got)


@pytest.mark.parametrize("k", [256, 128])
def test_int4_plain_matches_jax_reference(k):
    """K=128: the high half's rows share the low half's scale group."""
    x = weights((8, k), seed=6)
    w = weights((k, 128), seed=7)
    jq = jfp8.int_quantize(jnp.asarray(w), bits=4)
    tq = tfp8.int_quantize(torch.from_numpy(w), bits=4)
    xj, xt = both(x, "bfloat16")
    want = np.asarray(jax_int4_reference(xj, jq.weight, jq.scale),
                      np.float32)
    tim.reset_launch_counts()
    got = tim.int4_matmul_kernel(xt, tq.weight, tq.scale)
    assert tim.int4_matmul_launches == 0
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-6).all()
    f32 = tim.int4_matmul_reference(xt, tq.weight, tq.scale, torch.float32)
    want32 = np.asarray(jax_int4_reference(xj, jq.weight, jq.scale,
                                           out_dtype=jnp.float32))
    assert np.abs(f32.numpy() - want32).max() <= \
        1e-5 * np.abs(want32).max()


def test_int4_plain_matches_pallas_kernel():
    """As tests/test_kernels.py runs the Pallas kernel (K=2048, N=256)."""
    k, n = 2048, 256
    w = weights((k, n), seed=0)
    x = weights((12, k), seed=1)
    jq = jfp8.int_quantize(jnp.asarray(w), bits=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_int4_kernel(jnp.asarray(x), jq.weight,
                                          jq.scale), np.float32)
    tq = tfp8.int_quantize(torch.from_numpy(w), bits=4)
    got = tim.int4_matmul_kernel(torch.from_numpy(x), tq.weight,
                                 tq.scale).float().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel


def test_int4_shapes_ok():
    for k, n, ok in ((4096, 4096, True), (14336, 28672, True),
                     (4096, 128256, True), (128, 128, True),
                     (96, 128, False), (256, 96, False)):
        assert tim.int4_shapes_ok(k, n) == ok, (k, n)


# ---------------------------------------------------------------------------
# Quantized parameters
# ---------------------------------------------------------------------------

ARCH = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32)


def _walk(t, j):
    """Pairs of leaves of the port's and the JAX params (JAX quantized
    leaves stay whole)."""
    assert set(t) == set(j)
    for key in t:
        if isinstance(t[key], dict):
            yield from _walk(t[key], j[key])
        else:
            yield key, t[key], j[key]


def assert_same_params(t, j):
    for key, tv, jv in _walk(t, j):
        if isinstance(jv, jfp8.QuantizedLinear):
            assert_same_quantized(tv, jv)
        else:
            assert not isinstance(tv, tfp8.QuantizedLinear), key
            np.testing.assert_array_equal(raw(tv.float()),
                                          np.asarray(jv, np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_params_from_jax_and_quantize_params(mode):
    arch = jllama.LlamaArch.from_hf_config(ARCH)
    jplain = jllama.init_params(arch, jax.random.PRNGKey(0), jnp.float32)
    tplain = params_from_jax(jax.tree.map(np.asarray, jplain), "cpu")
    jq = jllama.quantize_params(jplain, mode)
    assert_same_params(tllama.quantize_params(tplain, mode), jq)
    assert_same_params(params_from_jax(jax.tree.map(np.asarray, jq), "cpu"),
                       jq)
    assert isinstance(jq["embed"], jfp8.QuantizedLinear)     # always fp8
    jinit = jllama.init_params(arch, jax.random.PRNGKey(1), jnp.float32,
                               quantization=mode)
    tinit = tllama.init_params(tllama.LlamaArch.from_hf_config(ARCH),
                               torch.Generator().manual_seed(1),
                               torch.float32, quantization=mode)
    for key, tv, jv in _walk(tinit, jinit):    # the same layout and types
        assert type(tv).__name__ in ("Tensor", type(jv).__name__), key
        assert tuple(tv.shape) == tuple(jv.shape), key
        if isinstance(jv, jfp8.QuantizedLinear):
            assert tv.weight.dtype == getattr(torch, str(jv.weight.dtype))
            assert tuple(tv.scale.shape) == tuple(jv.scale.shape), key


def _hf_state(rng, fp8_layers: bool):
    """A 2-layer HF Llama state dict as numpy arrays; with
    ``fp8_layers`` the layer weights are e4m3 (as numpy uint8 bytes)
    with ``weight_scale`` scalars."""
    d, li, hq, hkv, dh, v = 128, 256, 4, 2, 32, 96
    shapes = {"self_attn.q_proj": (hq * dh, d),
              "self_attn.k_proj": (hkv * dh, d),
              "self_attn.v_proj": (hkv * dh, d),
              "self_attn.o_proj": (d, hq * dh),
              "mlp.gate_proj": (li, d), "mlp.up_proj": (li, d),
              "mlp.down_proj": (d, li)}
    state = {"model.embed_tokens.weight": rng.standard_normal((v, d)),
             "model.norm.weight": np.ones(d),
             "lm_head.weight": rng.standard_normal((v, d)) * 0.1}
    for layer in range(2):
        pre = f"model.layers.{layer}."
        state[pre + "input_layernorm.weight"] = np.ones(d)
        state[pre + "post_attention_layernorm.weight"] = np.ones(d)
        for name, shape in shapes.items():
            w = rng.standard_normal(shape) * 0.1
            if fp8_layers:
                scale = np.float32(np.abs(w).max() / 448.0)
                q = torch.from_numpy((w / scale).astype(np.float32)).to(
                    torch.float8_e4m3fn)
                state[pre + name + ".weight"] = q.view(torch.uint8).numpy()
                state[pre + name + ".weight_scale"] = np.array(
                    scale, np.float32)
            else:
                state[pre + name + ".weight"] = w
    return {k: (a if a.dtype == np.uint8 else a.astype(np.float32))
            for k, a in state.items()}


@pytest.mark.parametrize("mode", ["prequantized_fp8", "int8", "int4"])
def test_load_hf_state_matches_jax(mode):
    prequantized = mode == "prequantized_fp8"
    state = _hf_state(np.random.default_rng(3), prequantized)
    fp8_np = jnp.dtype(jnp.float8_e4m3fn)
    jstate = {k: (a.view(fp8_np) if a.dtype == np.uint8 else a)
              for k, a in state.items()}
    tstate = {k: (torch.from_numpy(a).view(torch.float8_e4m3fn)
                  if a.dtype == np.uint8 else torch.from_numpy(a))
              for k, a in state.items()}
    quant = "fp8" if prequantized else mode
    arch = jllama.LlamaArch.from_hf_config(ARCH)
    jp = jllama.load_hf_state(arch, jstate, jnp.float32, quantization=quant)
    tp = tllama.load_hf_state(tllama.LlamaArch.from_hf_config(ARCH), tstate,
                              torch.float32, quantization=quant,
                              device="cpu")
    assert_same_params(tp, jp)
    assert isinstance(tp["embed"], tfp8.QuantizedLinear)
    assert isinstance(tp["layers"]["wq"], tfp8.QuantizedLinear)
    if prequantized:
        assert tp["layers"]["wq"].scale.shape == (2,)
        assert not isinstance(tp["lm_head"], tfp8.QuantizedLinear)
        np.testing.assert_array_equal(
            raw(tp["layers"]["wq"].weight[1]),
            state["model.layers.1.self_attn.q_proj.weight"].T)


# ---------------------------------------------------------------------------
# fp8-KV calibration
# ---------------------------------------------------------------------------

def test_kv_scale_computation_matches_jax():
    """Given the same fp8 cache contents and old scales, the port's scale
    computation equals the JAX method's exactly (the JAX method runs on a
    stand-in engine whose generate does nothing)."""
    rng = np.random.default_rng(4)
    kv32 = (rng.standard_normal((3, 5, 2, 32, 64)) *
            rng.uniform(0.1, 40, (3, 1, 2, 1, 1))).astype(np.float32)
    kv8 = torch.from_numpy(kv32).to(torch.float8_e4m3fn)
    old = rng.uniform(0.5, 2.0, (3, 2)).astype(np.float32)

    jkv = jnp.asarray(kv8.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)

    class Stand:
        FP8_MAX = KVCalibrationMixin.FP8_MAX

        def __init__(self):
            # The method replaces runner.kv_scale: a fresh runner each call.
            runner = type("Runner", (), {"kv": jkv,
                                         "kv_scale": jnp.asarray(old)})
            self.engine = type("Engine", (), {"runner": runner})

        def generate(self, **kw):
            return []

    for margin in (1.0, 1.25):
        want = KVCalibrationMixin.calibrate_kv_scales(Stand(), [[1]],
                                                      margin=margin)
        got = fp8_kv_scales(kv8, torch.from_numpy(old), margin)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    from tests.torch_shared import tiny_trained_checkpoint

    return tiny_trained_checkpoint(tmp_path_factory)


def _e4m3_step(v: np.ndarray) -> np.ndarray:
    """Spacing of e4m3 values at |v| (3 mantissa bits; subnormal below
    2^-6)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -6)))
    return 2.0 ** (e - 3)


def test_calibrate_kv_scales_matches_jax_engine(trained_ckpt):
    """End to end on a trained 2-layer model with an fp8 KV cache.  The
    two engines write K/V that differ in the float32 sums' order, so a
    value one rounding apart can land on the next e4m3 value; the amax,
    and so each scale, may then move by one e4m3 step at the amax
    (divided by 448).  Both engines run the synchronous step: the JAX
    package's pipelined step (its default) dispatches one step more
    before it sees a request finish, which writes one more token's K/V
    into the cache the scales are read from.  Later generation uses the
    calibrated scales."""
    path, heldout = trained_ckpt
    d = dict(model=dict(model=path, max_model_len=256, dtype="float32"),
             cache=dict(num_blocks=64, kv_cache_dtype="fp8"),
             scheduler=dict(max_num_seqs=4, max_num_batched_tokens=64,
                            async_scheduling=False))
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 30), (50, 45), (130, 20))]
    want = np.asarray(JaxLLM(jcfg.EngineConfig.from_dict(d))
                      .calibrate_kv_scales(prompts))
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    got = llm.calibrate_kv_scales(prompts)
    assert got.shape == (2, 2) and (got > 1e-6 / 448).all()
    bound = _e4m3_step(want * 448.0) / 448.0
    assert (np.abs(got - want) <= bound).all(), (got, want)
    np.testing.assert_array_equal(llm.engine.runner.kv_scale.numpy(), got)
    out = llm.generate(prompt_token_ids=prompts[:1])
    assert len(out[0].token_ids) > 0


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.source_digest("k.cu")
    assert build.source_digest("k.cu") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build.source_digest("k.cu")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.source_digest("k.cu") not in (first, second)
