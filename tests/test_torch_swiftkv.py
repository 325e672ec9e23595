"""The port's SwiftKV model, runner and engine against the JAX package's.

Seeded inputs go through ``arcticinference_tpu.models.llama_swiftkv`` and
its port; the JAX parameters come across through
``weights.params_from_jax`` (the same bytes).  Tolerances, per test:

- float32 weights, activations and cache, the jnp / plain attention: the
  sample rows and the caches element for element within 1e-5 (the two
  differ only in the order of float32 sums);
- d = 128 through the JAX Pallas kernels in interpret mode (bf16 cache):
  logits within 1e-3, the bound ``tests/test_torch_model.py`` uses there
  (the kernels round q and the softmax weights to bf16);
- quantized weights: the stacked K / V projection within 4e-3 relative
  (norm of the difference over the norm), logits within 5e-3 (fp8, int8
  and int4 alike; the logits are up to ~0.7 in size).  The JAX package
  dequantizes the stacked projections to the activations' dtype (float32
  here) before a float32 einsum; the port runs them through the
  quantized matmul kernel's plain version, which rounds the activations
  to bf16 and scales the float32 sums, as it does for every other
  quantized weight.  That moves the projected K / V by one bf16 rounding
  (~2^-9 relative; 1.7e-3 measured) and these logits by up to ~3e-3.
  Every other quantized product is the same function in both, as
  ``tests/test_torch_model.py`` shows at 1e-5;
- the engines (bf16 paged cache in both): tokens equal where the JAX
  run's top-2 margin is clear, each token's top-2 logprobs within 2e-3
  (a float32 difference in the last bits flips a bf16 rounding of a
  cached K / V value now and then, which moves later logits);
- quantized bytes and scales, HF loading and the runner's ``swift_*``
  arrays: exactly equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu.models import llama_swiftkv as jsw
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu.ops.kv_cache import (KVCacheSpec as JSpec,
                                              allocate_kv_cache as jalloc)
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import Request, SamplingParams
from arcticinference_tpu_torch.engine.runner import (ModelRunner,
                                                     swift_schedule)
from arcticinference_tpu_torch.engine.scheduler import Scheduler
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.models import llama_swiftkv as tsw
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    build_work_items)
from arcticinference_tpu_torch.weights import params_from_jax

BS, B_SLOTS, N_BLOCKS = 4, 4, 24

# tests/test_swiftkv.py's tiny SwiftKV: 4 layers, the last 2 on the
# projected KV.
ARCH = jsw.LlamaSwiftKVArch(
    vocab_size=97, hidden_size=64, intermediate_size=128,
    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
    num_key_value_layers=2)
HF_TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
               num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, num_key_value_layers=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a step of these tiny models is hundreds of
    small ops, for which a thread pool only adds synchronisation (and,
    beside other test processes, contention)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def port_arch(arch):
    return tsw.LlamaSwiftKVArch(**{
        f.name: getattr(arch, f.name)
        for f in dataclasses.fields(tsw.LlamaSwiftKVArch)})


def both_params(arch, seed=3, quantization=None):
    jp = jsw.init_params(arch, jax.random.PRNGKey(seed), jnp.float32,
                         quantization=quantization)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tiny():
    return both_params(ARCH)


def step_arrays(reqs, block_tables, t_pad, attn_qb, rng, vocab):
    """One step's arrays for requests [(ctx, qlen, n_sample)] laid out
    as the runners lay them out: request-major tokens, the last
    ``n_sample`` rows of each request sampled, ``logits_indices`` padded
    with row 0 to its bucket, the ``attn_*`` schedule and the runner's
    ``swift_*`` schedule.  Returns (arrays, number of sample rows)."""
    b = B_SLOTS
    positions = np.zeros(t_pad, np.int32)
    req_idx = np.full(t_pad, -1, np.int32)
    slots = np.full(t_pad, -1, np.int32)
    seq_lens = np.zeros(b, np.int32)
    qlens = np.zeros(b, np.int64)
    last = np.zeros(b, np.int64)
    rows, counts = [], []
    t = 0
    for r, (ctx, q, ns) in enumerate(reqs):
        pos = np.arange(ctx, ctx + q)
        positions[t:t + q] = pos
        req_idx[t:t + q] = r
        slots[t:t + q] = block_tables[r, pos // BS] * BS + pos % BS
        seq_lens[r], qlens[r], last[r] = ctx + q, q, ctx + q - 1
        rows.extend(range(t + q - ns, t + q))
        counts.append(ns)
        t += q
    s_pad = 16 if len(rows) <= 16 else 32
    logits_indices = np.zeros(s_pad, np.int32)
    logits_indices[:len(rows)] = rows
    sched_qb = 8 if attn_qb == 1 else attn_qb
    sched = build_work_items(qlens, last, sched_qb, BS,
                             t_pad // sched_qb + b, t_pad)
    arrays = dict(input_ids=rng.integers(0, vocab, t_pad).astype(np.int32),
                  positions=positions, req_idx=req_idx, slot_mapping=slots,
                  block_tables=block_tables, seq_lens=seq_lens,
                  logits_indices=logits_indices)
    arrays.update(zip(tllama._SCHEDULE_KEYS, sched))
    arrays.update(swift_schedule(counts, last, s_pad, BS))
    return arrays, len(rows)


def block_tables():
    bt = np.zeros((B_SLOTS, 6), np.int32)
    bt[0, :5] = [3, 7, 1, 9, 11]
    bt[1, :4] = [5, 2, 13, 15]
    bt[2, :3] = [4, 17, 19]
    return bt


def run_both(arch, jparams, tparams, steps, kv_dtype="float32"):
    """Each step [(ctx, qlen, n_sample)], t_pad, attn_qb through both
    models on caches of ``kv_dtype``; yields (port rows, JAX rows, port
    cache, JAX cache) per step, the rows as float32 numpy arrays of the
    real sample rows."""
    rng = np.random.default_rng(0)
    jkv = jalloc(JSpec(arch.num_layers, N_BLOCKS, arch.num_kv_heads, BS,
                       arch.head_dim, getattr(jnp, kv_dtype)))
    tkv = torch.zeros(tuple(jkv.shape), dtype=getattr(torch, kv_dtype))
    ks = np.ones((arch.num_layers, 2), np.float32)
    tarch = port_arch(arch)
    tparams = tsw.fuse_params(tparams)
    bt = block_tables()
    for reqs, t_pad, attn_qb in steps:
        arrays, n = step_arrays(reqs, bt, t_pad, attn_qb, rng,
                                arch.vocab_size)
        jin = {k: jnp.asarray(v) for k, v in arrays.items()}
        jin["kv_scale"] = jnp.asarray(ks)
        jkv, jrows = jsw.forward(jparams, arch, jkv, jin,
                                 attn_impl=jsw.make_attn_impl(attn_qb))
        tin = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        tin["kv_scale"] = torch.from_numpy(ks)
        tkv, trows = tsw.forward(tparams, tarch, tkv, tin,
                                 attn_impl=tsw.make_attn_impl(attn_qb))
        yield (trows[:n], jnp.asarray(jrows[:n]), tkv,
               np.asarray(jkv.astype(jnp.float32)), tparams)


def logits_of(jparams, tparams, trows, jrows):
    return (tsw.compute_logits(tparams, trows).float().numpy(),
            np.asarray(jsw.compute_logits(jparams, jrows)))


# Steps: a one-shot prefill of three requests sampling a subset of rows
# (token drop, qb 32), then a chunked prefill continued by a mixed step
# with decode rows and 3-row verify chunks, then a pure decode step
# (grouped path, attn_qb 1).
ONE_SHOT = [([(0, 13, 1), (0, 6, 2), (0, 9, 1)], 32, 32)]
CHUNKED = [([(0, 8, 1), (0, 11, 1)], 32, 32),
           ([(8, 5, 1), (11, 3, 3), (0, 4, 1)], 16, 8),
           ([(13, 1, 1), (14, 1, 1), (4, 1, 1)], 16, 1)]


@pytest.mark.parametrize("steps", [ONE_SHOT, CHUNKED],
                         ids=["one_shot_drop", "chunked_then_decode"])
def test_forward_matches_jax(tiny, steps):
    jp, tp = tiny
    for trows, jrows, tkv, jkv, _ in run_both(ARCH, jp, tp, steps):
        assert np.abs(np.asarray(jrows)).max() > 1e-1
        np.testing.assert_allclose(trows.numpy(), np.asarray(jrows),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tkv.numpy()[:, 1:], jkv[:, 1:],
                                   atol=1e-5, rtol=0)


def test_degenerates_to_llama_bit_for_bit():
    """``num_key_value_layers == num_layers``: the port's Llama forward
    on the same weights, bit for bit (the same operations in the same
    order)."""
    arch = dataclasses.replace(ARCH, num_key_value_layers=4)
    _, tp = both_params(arch, seed=0)
    tarch = port_arch(arch)
    assert tarch.num_swift_layers == 0 and "layers_b" not in tp
    lp = tllama.fuse_params({"embed": tp["embed"],
                             "final_norm": tp["final_norm"],
                             "lm_head": tp["lm_head"],
                             "layers": tp["layers_a"]})
    arrays, n = step_arrays([(0, 13, 1), (0, 6, 2)], block_tables(), 32, 32,
                            np.random.default_rng(1), arch.vocab_size)
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    def cache():
        return torch.zeros((4, N_BLOCKS, 2, BS, 32))

    kv_s, rows = tsw.forward(tsw.fuse_params(tp), tarch, cache(), inputs)
    kv_l, h = tllama.forward(lp, tllama.LlamaArch(**{
        f.name: getattr(tarch, f.name)
        for f in dataclasses.fields(tllama.LlamaArch)}), cache(), inputs)
    assert torch.equal(rows, h[inputs["logits_indices"].long()])
    assert torch.equal(kv_s, kv_l)


def test_surviving_row_does_not_depend_on_the_others(tiny):
    """A sample row's output is the same whichever other rows of the step
    survive with it (the gather does not leak): within 1e-5, for sets
    of one, two and four surviving rows."""
    _, tp = tiny
    tp = tsw.fuse_params(tp)
    tarch = port_arch(ARCH)
    bt = block_tables()
    out = []
    for sample in ([10], [4, 10], [0, 3, 7, 10]):
        arrays, _ = step_arrays([(0, 11, 1)], bt, 16, 32,
                                np.random.default_rng(5), ARCH.vocab_size)
        li = np.zeros(16, np.int32)
        li[:len(sample)] = sample
        arrays["logits_indices"] = li
        # One request whose sample rows are ``sample``: one 8-row item
        # per run of rows, as the runner's schedule over them.
        arrays.update(swift_schedule([len(sample)], np.array(
            [10, 0, 0, 0]), 16, BS))
        inputs = {k: torch.from_numpy(np.array(v))
                  for k, v in arrays.items()}
        kv = torch.zeros((4, N_BLOCKS, 2, BS, 32))
        _, rows = tsw.forward(tp, tarch, kv, inputs)
        out.append(rows[len(sample) - 1])
    for row in out[1:]:
        np.testing.assert_allclose(row.numpy(), out[0].numpy(), atol=1e-5,
                                   rtol=0)


def test_padding_sample_rows_are_padding_tokens(tiny):
    """Padding entries of ``logits_indices`` (row 0 past the real rows)
    run the later layers as padding tokens: their attention output is
    zero, so no kernel leaves them unwritten."""
    _, tp = tiny
    rows = torch.tensor([2, 5, 9, 0, 0, 0])
    assert tsw._live_rows(rows).tolist() == [True] * 3 + [False] * 3
    assert tsw._live_rows(torch.tensor([0, 1, 0])).tolist() == [
        True, True, False]


def test_pallas_kernels_in_interpret_mode(monkeypatch):
    """d = 128 through the JAX Pallas kernels in interpret mode (as
    tests/test_kernels.py runs them): a mixed step through the ragged
    kernel on both halves, the swift half on its own 8-row items, then a
    pure decode step through the grouped kernel on both halves, against
    the port's plain versions.  bf16 cache; logits within 1e-3."""
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    arch = jsw.LlamaSwiftKVArch(
        vocab_size=97, hidden_size=128, intermediate_size=256,
        num_layers=4, num_heads=2, num_kv_heads=1, head_dim=128,
        num_key_value_layers=2)
    jp, tp = both_params(arch, seed=4)
    steps = [([(0, 12, 1), (0, 7, 3)], 32, 32),
             ([(12, 1, 1), (7, 1, 1)], 16, 1)]
    for trows, jrows, _, _, tpf in run_both(arch, jp, tp, steps,
                                            kv_dtype="bfloat16"):
        tl, jl = logits_of(jp, tpf, trows, jrows)
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# Quantized weights
# ---------------------------------------------------------------------------

QARCH = jsw.LlamaSwiftKVArch(
    vocab_size=96, hidden_size=128, intermediate_size=256,
    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
    num_key_value_layers=2)


def leaves(tree, prefix=""):
    """(path, leaf) of a parameter tree, quantized leaves as their
    weight and scale."""
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, p + ".")
        elif hasattr(v, "scale"):
            yield p + ".weight", v.weight
            yield p + ".scale", v.scale
        else:
            yield p, v


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.mark.parametrize("mode", ["fp8", "int8", "int4"])
def test_quantize_params_matches_jax(mode):
    """Both layer stacks and the stacked K / V projections: the JAX
    package's bytes and scales exactly (hidden 128: int4 packs)."""
    jp, tp = both_params(QARCH, seed=1)
    jq = dict(leaves(jax.tree.map(np.asarray,
                                  jsw.quantize_params(jp, mode))))
    tq = dict(leaves(tsw.quantize_params(tp, mode)))
    assert jq.keys() == tq.keys()
    assert isinstance(tsw.quantize_params(tp, mode)["wk_swift"],
                      tfp8.QuantizedLinear)
    for k, a in jq.items():
        np.testing.assert_array_equal(as_numpy(tq[k]), as_numpy(a),
                                      err_msg=k)


@pytest.mark.parametrize("mode", ["fp8", "int8", "int4"])
def test_fused_kv_operand_dequantizes_to_its_parts(mode):
    """``wkv_swift``'s dequantized columns are each layer's dequantized K
    and V parts bit for bit (per-layer / per-column / group scales kept
    as they are), and one matmul gives every layer's projection."""
    _, tp = both_params(QARCH, seed=2)
    q = tsw.quantize_params(tp, mode)
    fused = tsw.fuse_params(q)["wkv_swift"]
    kb, e = 2, 2 * 32
    assert fused.weight.shape[-1] == 2 * kb * e
    full = tfp8.fp8_dequantize(fused, torch.float32)
    for j, (key, i) in enumerate((k, i) for k in ("wk_swift", "wv_swift")
                                 for i in range(kb)):
        part = tfp8.fp8_dequantize(q[key][i], torch.float32)
        assert torch.equal(full[:, j * e:(j + 1) * e], part), (key, i)


@pytest.mark.parametrize("mode", ["fp8", "int8", "int4"])
def test_quantized_forward_matches_jax(mode):
    jp, tp = both_params(QARCH, seed=5, quantization=mode)
    assert isinstance(tp["wk_swift"], tfp8.QuantizedLinear)
    # The stacked projection alone: one bf16 rounding of x apart.
    x = np.random.default_rng(0).standard_normal((16, 128)).astype(
        np.float32)
    kb, e = 2, 64
    jy = np.concatenate([np.asarray(jsw._stacked_proj(
        jnp.asarray(x), jp[k])) for k in ("wk_swift", "wv_swift")])
    ty = tfp8.matmul(torch.from_numpy(x), tsw.fuse_params(tp)["wkv_swift"])
    ty = ty.numpy().reshape(16, 2 * kb, e).transpose(1, 0, 2)
    assert np.linalg.norm(ty - jy) / np.linalg.norm(jy) < 4e-3
    for trows, jrows, _, _, tpf in run_both(QARCH, jp, tp, CHUNKED,
                                            kv_dtype="bfloat16"):
        tl, jl = logits_of(jp, tpf, trows, jrows)
        assert np.abs(jl).max() > 1e-1
        np.testing.assert_allclose(tl, jl, atol=5e-3, rtol=0)


def test_params_from_jax_carries_the_swift_tree():
    """Nested ``layers_a`` / ``layers_b``, the stacked projections (plain
    and quantized) and ``norm_swiftkv`` come across with their keys,
    shapes and bytes."""
    for quant in (None, "fp8"):
        jp, tp = both_params(QARCH, seed=6, quantization=quant)
        jl = dict(leaves(jax.tree.map(np.asarray, jp)))
        tl = dict(leaves(tp))
        assert jl.keys() == tl.keys()
        assert "norm_swiftkv" in tl and any(
            k.startswith("layers_b.wq") for k in tl)
        for k, a in jl.items():
            np.testing.assert_array_equal(as_numpy(tl[k]), as_numpy(a),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def hf_state(rng, arch, scale=1.0, q_name="q_proj_swiftkv"):
    """A synthetic Llama-SwiftKV checkpoint (tests/test_swiftkv.py's
    layout): plain layers below ``num_key_value_layers``, then
    ``q_proj_swiftkv`` (or ``q_proj``) and the fused ``kv_proj_swiftkv``."""
    d, li = arch.hidden_size, arch.intermediate_size
    hq, e = arch.num_heads * arch.head_dim, arch.num_kv_heads * arch.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * scale / np.sqrt(shape[-1])
                ).astype(np.float32)

    def ones(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    state = {"model.embed_tokens.weight": w(arch.vocab_size, d) * 8,
             "model.norm.weight": ones(d),
             "model.norm_swiftkv.weight": ones(d),
             "lm_head.weight": w(arch.vocab_size, d) * 8}
    for layer in range(arch.num_layers):
        p = f"model.layers.{layer}."
        if layer < arch.num_key_value_layers:
            state[p + "self_attn.q_proj.weight"] = w(hq, d)
            state[p + "self_attn.k_proj.weight"] = w(e, d)
            state[p + "self_attn.v_proj.weight"] = w(e, d)
        else:
            state[p + f"self_attn.{q_name}.weight"] = w(hq, d)
            state[p + "self_attn.kv_proj_swiftkv.weight"] = w(2 * e, d)
        state[p + "self_attn.o_proj.weight"] = w(d, hq)
        state[p + "mlp.gate_proj.weight"] = w(li, d)
        state[p + "mlp.up_proj.weight"] = w(li, d)
        state[p + "mlp.down_proj.weight"] = w(d, li)
        state[p + "input_layernorm.weight"] = ones(d)
        state[p + "post_attention_layernorm.weight"] = ones(d)
    return state


@pytest.mark.parametrize("quantization,q_name", [
    (None, "q_proj_swiftkv"), (None, "q_proj"), ("fp8", "q_proj_swiftkv")])
def test_load_hf_state_matches_jax(quantization, q_name):
    arch = QARCH
    state = hf_state(np.random.default_rng(0), arch, q_name=q_name)
    jp = jsw.load_hf_state(arch, state, jnp.float32, quantization)
    tp = tsw.load_hf_state(port_arch(arch), {
        k: torch.from_numpy(v) for k, v in state.items()}, torch.float32,
        quantization, device="cpu")
    jl = dict(leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(leaves(tp))
    assert jl.keys() == tl.keys()
    assert tuple(tl["wk_swift" + (".weight" if quantization else "")]
                 .shape) == (2, 128, 64)
    for k, a in jl.items():
        np.testing.assert_array_equal(as_numpy(tl[k]), as_numpy(a),
                                      err_msg=k)


def test_load_hf_state_refuses_prequantized_swift_layers():
    state = {k: torch.from_numpy(v) for k, v in hf_state(
        np.random.default_rng(0), QARCH).items()}
    state["model.layers.3.mlp.up_proj.weight_scale"] = torch.ones(())
    with pytest.raises(NotImplementedError, match="pre-quantized"):
        tsw.load_hf_state(port_arch(QARCH), state, device="cpu")


# ---------------------------------------------------------------------------
# The runner and the engine
# ---------------------------------------------------------------------------

def config_dict(model="llama_swiftkv", hf=None, spec=None,
                max_batched=32):
    d = dict(model=dict(model=model, hf_overrides=hf or HF_TINY,
                        max_model_len=256, dtype="float32"),
             cache=dict(num_blocks=64),
             scheduler=dict(max_num_seqs=4,
                            max_num_batched_tokens=max_batched))
    if spec is not None:
        d["speculative"] = spec
    return d


def test_prepare_inputs_swift_arrays_match_jax_runner(monkeypatch):
    """Steps of chunked prefills, decode rows and linear verify rows
    (drafts on the running requests): both runners build the same
    arrays, the ``swift_*`` schedule over the sample rows included."""
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    d = config_dict()
    jconf, tconf = (jcfg.EngineConfig.from_dict(d),
                    tcfg.EngineConfig.from_dict(d))
    jrun = JaxRunner(jconf, *jax_load_model(jconf.model))
    trun = ModelRunner(tconf, *load_model(tconf.model, "cpu"),
                       torch.device("cpu"))
    assert trun.swift and jrun.swift and trun.returns_rows
    sched = Scheduler(tconf.scheduler, tconf.cache, trun.num_blocks)
    rng = np.random.default_rng(0)
    for i, n in enumerate((50, 7, 33, 12)):
        sched.add_request(Request(
            f"r{i}", [int(x) for x in rng.integers(1, 97, n)],
            SamplingParams(max_tokens=6)))
    kinds = set()
    step = 0
    while sched.num_unfinished:
        step += 1
        for req in sched.running:
            if step % 2 == 0 and req.num_computed_tokens == \
                    req.num_tokens - 1:
                # Linear drafts: 1-3 verify rows beside the bonus row.
                req.spec_token_ids = [int(x) for x in rng.integers(
                    1, 97, 1 + step % 3)]
        out = sched.schedule()
        ts, js = trun.prepare_inputs(out), jrun.prepare_inputs(out)
        assert (ts.t_pad, ts.s_pad, ts.attn_qb) == \
            (js.t_pad, js.s_pad, js.attn_qb)
        assert ts.arrays.keys() == js.arrays.keys()
        assert "swift_token_item" in ts.arrays
        for k, a in js.arrays.items():
            assert ts.arrays[k].dtype == a.dtype, k
            np.testing.assert_array_equal(ts.arrays[k], a, err_msg=k)
        kinds.add((ts.attn_qb, max(ts.sample_row_count) > 1))
        for s in out.scheduled:
            req = s.request
            done = req.num_computed_tokens + s.num_new_tokens >= \
                req.num_tokens
            sched.update_after_step(s, [5] if done else [], 0)
            if req.check_stop(None, 256) is not None:
                sched.finish_request(req, req.check_stop(None, 256))
    # Prefill chunks, pure decode and verify steps all came by.
    assert {(32, False), (1, False), (8, True)} <= kinds


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A synthetic Llama-SwiftKV checkpoint directory both engines load
    (the port's safetensors writer; embedding and LM head scaled up for
    clear argmax margins)."""
    path = tmp_path_factory.mktemp("swiftkv_ckpt")
    arch = jsw.LlamaSwiftKVArch.from_hf_config(HF_TINY)
    st_io.save_file(hf_state(np.random.default_rng(7), arch),
                    path / "model.safetensors")
    cfg = dict(HF_TINY, architectures=["LlamaSwiftKVForCausalLM"],
               rope_theta=10000.0, rms_norm_eps=1e-5,
               tie_word_embeddings=False)
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


PROMPTS = [[int(x) for x in np.random.default_rng(11).integers(1, 97, n)]
           for n in (12, 45, 25, 70, 8)]


def test_engine_matches_jax_engine(checkpoint):
    """Greedy ``LLM.generate`` on the synthetic checkpoint through both
    engines (chunked prefills, token drop, decode): the JAX run's top-2
    logprob margin is clear at every token (> 1e-2, five times the
    tolerance), the tokens are equal, and each token's top-2 logprobs
    agree within 2e-3."""
    d = config_dict(model=checkpoint, hf={})
    ref = JaxLLM(jcfg.EngineConfig.from_dict(d)).generate(
        prompt_token_ids=PROMPTS,
        sampling_params=JaxSamplingParams(max_tokens=10, logprobs=2))
    for o in ref:
        for top2 in o.logprobs:
            a, b = sorted(top2.values(), reverse=True)
            assert a - b > 1e-2, "near tie in the JAX run"
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    outs = llm.generate(prompt_token_ids=PROMPTS,
                        sampling_params=SamplingParams(max_tokens=10,
                                                       logprobs=2))
    for o, r in zip(outs, ref):
        assert o.token_ids == r.token_ids
        for lp, rlp in zip(o.logprobs, r.logprobs):
            assert lp.keys() == rlp.keys()
            np.testing.assert_allclose([lp[k] for k in rlp],
                                       list(rlp.values()), atol=2e-3)


def generate(checkpoint, spec=None, seed_cache=None, max_tokens=24):
    d = config_dict(model=checkpoint, hf={}, spec=spec)
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    if seed_cache is not None:
        for i, seq in enumerate(seed_cache):
            llm.engine._suffix_cache.update_response(f"warm-{i}", seq)
    outs = llm.generate(prompt_token_ids=PROMPTS,
                        sampling_params=SamplingParams(
                            max_tokens=max_tokens))
    llm.close()
    return [o.token_ids for o in outs], llm.engine


@pytest.fixture(scope="module")
def no_spec(checkpoint):
    return generate(checkpoint)[0]


@pytest.mark.parametrize("fused", [False, True], ids=["sync", "fused"])
def test_suffix_gives_the_tokens_without_it(checkpoint, no_spec, fused):
    """Suffix decoding on the synchronous step and on the fused loop,
    its cache seeded with the outputs: the same tokens, drafts
    accepted."""
    spec = dict(method="suffix", enable_fused_decode=fused)
    toks, eng = generate(checkpoint, spec,
                         seed_cache=[p[-4:] + t for p, t in zip(PROMPTS,
                                                                no_spec)])
    assert toks == no_spec
    assert eng.spec_stats.num_accepted_tokens > 0
    if fused:
        assert eng.width_stats["wide"] + eng.width_stats["narrow"] > 0


@pytest.mark.parametrize("suffix", [False, True],
                         ids=["mlp_fused", "all_combined"])
def test_drafter_on_the_fused_loop_gives_the_tokens_without_it(
        checkpoint, no_spec, suffix):
    """An MLP drafter on the fused loop, and the all-combined config
    (SwiftKV + MLP drafter + suffix decoding, fused): the tokens of the
    run without speculation, every fused step wide, drafts verified."""
    spec = dict(method="arctic", num_speculative_tokens=3,
                enable_suffix_decoding=suffix)
    toks, eng = generate(checkpoint, spec, seed_cache=[
        p[-4:] + t for p, t in zip(PROMPTS, no_spec)] if suffix else None)
    assert toks == no_spec
    ws = eng.width_stats
    assert ws["wide"] > 0 and ws["narrow"] == 0
    assert eng.spec_stats.num_drafts > 0
    if suffix:
        assert eng.spec_stats.num_accepted_tokens > 0


def test_hidden_capture_hands_over_sample_rows(checkpoint, no_spec):
    """The distillation hook gets each committed token with its hidden
    row (the sample row SwiftKV returns), as wide as the model."""
    d = config_dict(model=checkpoint, hf={})
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    seen = []
    llm.engine.hidden_capture = lambda rows, entries: seen.extend(
        (rows[row], tok) for _, row, tok in entries)
    outs = llm.generate(prompt_token_ids=PROMPTS[:2],
                        sampling_params=SamplingParams(max_tokens=5))
    assert sorted(t for _, t in seen) == sorted(
        t for o in outs for t in o.token_ids)
    assert all(r.shape == (64,) and torch.isfinite(r).all()
               for r, _ in seen)


def test_tree_speculation_with_swiftkv_raises():
    d = config_dict(spec=dict(method="suffix", use_tree_spec=True))
    with pytest.raises(NotImplementedError, match="SwiftKV"):
        LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
