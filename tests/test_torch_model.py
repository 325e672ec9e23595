"""The port's Llama forward + compute_logits against the JAX package's,
on the same weights (``params_from_jax``) and the same step inputs.

Float32 activations (the paged cache is bf16 in both, as both runners
allocate it), logits at atol 1e-4 against the JAX reference attention
(they are ~0.2 in size here, so the bound is ~5e-4 relative; a wrong
attention moves them by ~1e-1).  The port runs its plain attention (the
CPU path of the kernel wrappers).  One more case runs the JAX side
through its two Pallas kernels in interpret mode, at the bound their
bf16 rounding allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu.models import llama as jllama
from arcticinference_tpu.ops.kv_cache import (KVCacheSpec as JSpec,
                                              allocate_kv_cache as jalloc)
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    build_work_items)
from arcticinference_tpu_torch.ops.kv_cache import compute_slot_mapping
from arcticinference_tpu_torch.weights import params_from_jax

BS, B_SLOTS, MAX_BLK = 32, 4, 4


def step_inputs(reqs, block_tables, t_pad, attn_qb):
    """Host arrays of one step for requests [(ctx, qlen)], laid out as the
    runner lays them out (request-major tokens, padding -1)."""
    total = sum(q for _, q in reqs)
    b = B_SLOTS
    positions = np.zeros(t_pad, np.int32)
    req_idx = np.full(t_pad, -1, np.int32)
    seq_lens = np.zeros(b, np.int32)
    qlens = np.zeros(b, np.int64)
    last = np.zeros(b, np.int64)
    t = 0
    rows = []
    for r, (ctx, q) in enumerate(reqs):
        positions[t:t + q] = np.arange(ctx, ctx + q)
        req_idx[t:t + q] = r
        seq_lens[r], qlens[r], last[r] = ctx + q, q, ctx + q - 1
        t += q
        rows.append(t - 1)
    ctx = np.array([c for c, _ in reqs] + [0] * (b - len(reqs)))
    slots = compute_slot_mapping(block_tables, ctx, qlens, BS, t_pad)
    sched_qb = 8 if attn_qb == 1 else attn_qb
    sched = build_work_items(qlens, last, sched_qb, BS,
                             t_pad // sched_qb + b, t_pad)
    arrays = dict(positions=positions, req_idx=req_idx, slot_mapping=slots,
                  block_tables=block_tables, seq_lens=seq_lens)
    for key, a in zip(tllama._SCHEDULE_KEYS, sched):
        arrays[key] = a
    assert total <= t_pad
    return arrays, np.array(rows, np.int32)


def run_both(arch, jparams, tparams, steps, rng, kv_dtype="bfloat16",
             caches=None, jmod=jllama, tmod=tllama):
    """Run each step through both models (the JAX module ``jmod`` and the
    port's ``tmod``, Llama by default); return per-step logits.  The
    paged cache is bf16 by default, as both runners allocate it.  Each
    step's caches are held together unless ``caches`` is a list, which
    then receives each step's (port, JAX) caches as numpy arrays."""
    jkv = jalloc(JSpec(arch.num_layers, 16, arch.num_kv_heads, BS,
                       arch.head_dim, getattr(jnp, kv_dtype)))
    tkv = torch.zeros(tuple(jkv.shape), dtype=getattr(torch, kv_dtype))
    ks = np.ones((arch.num_layers, 2), np.float32)
    bt = np.zeros((B_SLOTS, MAX_BLK), np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :1] = [5]
    out = []
    # The MoE fields where the module has them (Mixtral).
    moe_fields = tuple(f for f in ("num_experts", "num_experts_per_tok")
                       if hasattr(arch, f))
    tarch = tmod.Arch(**{f: getattr(arch, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "rope_theta",
        "rope_scaling", "rms_norm_eps", "tie_word_embeddings")
        + moe_fields})
    for reqs, t_pad, attn_qb in steps:
        arrays, rows = step_inputs(reqs, bt, t_pad, attn_qb)
        ids = rng.integers(0, arch.vocab_size, t_pad).astype(np.int32)
        arrays["input_ids"] = ids
        jin = {k: jnp.asarray(v) for k, v in arrays.items()}
        jin["kv_scale"] = jnp.asarray(ks)
        jkv, h = jmod.forward(jparams, arch, jkv, jin,
                              attn_impl=jmod.make_attn_impl(attn_qb))
        jl = np.asarray(jmod.compute_logits(jparams, h[rows]))
        tin = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        tin["kv_scale"] = torch.from_numpy(ks)
        tkv, th = tmod.forward(tparams, tarch, tkv, tin,
                               attn_impl=tmod.make_attn_impl(attn_qb))
        tl = tmod.compute_logits(tparams, th[torch.from_numpy(rows).long()])
        jcache = np.asarray(jkv.astype(jnp.float32))
        if caches is not None:
            caches.append((tkv.float().numpy(), jcache))
        else:
            np.testing.assert_allclose(tkv.float().numpy()[:, 1:],
                                       jcache[:, 1:], rtol=1e-2, atol=1e-3)
        out.append((tl.numpy(), jl))
    return out


def make_models(head_dim, fused, quantization=None, hidden=64):
    cfg = dict(vocab_size=96, hidden_size=hidden, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=head_dim,
               rope_theta=500000.0)
    arch = jllama.LlamaArch.from_hf_config(cfg)
    jparams = jllama.init_params(arch, jax.random.PRNGKey(0), jnp.float32,
                                 quantization=quantization)
    if fused:
        jparams = jllama.fuse_params(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jparams, tparams


# Prefill (two requests, 20 and 7 tokens, qb 32) then decode (attn_qb 1:
# two live rows in a 16-token bucket over 4 request slots).
STEPS = [([(0, 20), (0, 7)], 32, 32), ([(20, 1), (7, 1)], 16, 1)]


def test_logits_match_jax_pallas_head_dim_128(monkeypatch):
    """Through both JAX Pallas kernels (interpret mode).  They round
    q*scale and the softmax weights to bf16 before their products
    (ops/pallas/ragged_attention.py:168-172,226), which moves these
    logits by up to ~5e-4; the bound here is 1e-3 for that reason.  The
    same model against the JAX reference attention is held to 1e-4
    below."""
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    arch, jparams, tparams = make_models(128, True)
    rng = np.random.default_rng(0)
    for tl, jl in run_both(arch, jparams, tparams, STEPS, rng):
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)


@pytest.mark.parametrize("head_dim,fused", [(128, False), (32, True)])
def test_logits_match_jax_reference(head_dim, fused):
    arch, jparams, tparams = make_models(head_dim, fused)
    rng = np.random.default_rng(1)
    for tl, jl in run_both(arch, jparams, tparams, STEPS, rng):
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quantization", ["fp8", "int8", "int4"])
def test_quantized_logits_match_jax(quantization, fused):
    """Weight-only quantized models from the JAX package's quantized
    parameters (``params_from_jax``: the same bytes).  Hidden 128 packs
    int4 wq..wo in one scale group and w_down in two; the LM head and
    the fp8 embedding quantize too.  fp8 and int8 agree to ~3e-8 on
    these logits (~0.2 in size; bound 1e-5).  int4: in the JAX decode
    step XLA's default excess precision (``xla_allow_excess_precision``)
    drops the bf16 rounding of the dequantized weight, which moves the
    logits by up to 2.6e-4 (3e-8 with the flag off, the port being the
    function as written): bound 1e-3."""
    arch, jparams, tparams = make_models(32, fused, quantization, hidden=128)
    assert isinstance(tparams["lm_head"], tfp8.QuantizedLinear)
    rng = np.random.default_rng(2)
    atol = 1e-3 if quantization == "int4" else 1e-5
    for tl, jl in run_both(arch, jparams, tparams, STEPS, rng):
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0)


@pytest.mark.parametrize("quant", [None, "fp8", "int8", "int4"])
def test_fused_weights_exact_parity(quant):
    """``fuse_params`` (wqkv / w_gateup) against the unfused layout, on
    the port's own random parameters: per-part scales are kept (as
    per-column scales), not re-derived, so every quantized mode is
    exact; plain float32 weights within 1e-5 (another matmul shape may
    sum in another order)."""
    arch = tllama.LlamaArch(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32)
    params = tllama.init_params(arch, torch.Generator().manual_seed(1),
                                torch.float32, quantization=quant)
    fused = tllama.fuse_params(params)
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    assert "w_gateup" in fused["layers"]
    if quant is not None:
        assert fused["layers"]["wqkv"].scale.shape[-1] == 256
    arrays, rows = step_inputs([(0, 20), (0, 7)], np.array(
        [[3, 7, 0, 0], [5, 0, 0, 0], [0] * 4, [0] * 4], np.int32), 32, 32)
    arrays["input_ids"] = np.random.default_rng(0).integers(
        0, 128, 32).astype(np.int32)
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    def run(p):
        kv = torch.zeros((2, 16, 2, BS, 2 * 32), dtype=torch.bfloat16)
        _, h = tllama.forward(p, arch, kv, inputs)
        return tllama.compute_logits(p, h[torch.from_numpy(rows).long()])

    a, b = run(params).numpy(), run(fused).numpy()
    assert np.abs(a).max() > 1e-2
    np.testing.assert_allclose(a, b, atol=1e-5 if quant is None else 0.0,
                               rtol=0)


def test_params_from_jax_keeps_keys_and_layout():
    arch, jparams, tparams = make_models(32, True)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_refuses_unported_variants():
    """The Qwen variants are ported: attention biases and qk-norm weights
    are drawn (they raised before); weight-only quantization leaves them
    unquantized.  Interleaved (sharded) fusion is ported too (it raised
    before): the first half of the fused columns is [q_0|k_0|v_0]."""
    gen = torch.Generator().manual_seed(0)
    small = dict(vocab_size=64, hidden_size=128, intermediate_size=256,
                 num_layers=1, num_heads=4, num_kv_heads=2, head_dim=32)
    arch = tllama.LlamaArch(attention_bias=True, qk_norm=True, **small)
    layers = tllama.init_params(arch, gen, torch.float32)["layers"]
    assert {k: tuple(layers[k].shape) for k in (
        "bq", "bk", "bv", "q_norm", "k_norm")} == dict(
        bq=(1, 128), bk=(1, 64), bv=(1, 64), q_norm=(1, 32), k_norm=(1, 32))
    params = tllama.init_params(tllama.LlamaArch(**small), gen,
                                quantization="fp8")
    assert isinstance(params["layers"]["wq"], tfp8.QuantizedLinear)
    assert params["layers"]["wq"].weight.dtype == torch.float8_e4m3fn
    assert "bq" not in params["layers"]
    lay = params["layers"]
    fused = tllama.fuse_params(params, interleave=2)["layers"]["wqkv"]
    first = torch.cat([lay[k].weight[..., :lay[k].shape[-1] // 2]
                       for k in ("wq", "wk", "wv")], dim=-1)
    assert torch.equal(fused.weight[..., :first.shape[-1]].view(torch.uint8),
                       first.view(torch.uint8))
