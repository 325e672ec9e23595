"""The port's Qwen2 and Qwen3 against the JAX package's and HF's.

- Registry: ``get_model_module`` gives the port's Qwen2 / Qwen3 modules.
- ``forward`` logits against the JAX modules' on the same weights
  (``params_from_jax``), unquantized (float32 activations, as
  ``tests/test_torch_model.py``), fp8 and int4, at that file's bounds:
  head_dim 32 against the JAX reference attention (1e-4; fp8 1e-5; int4
  1e-3), head_dim 128 at group 7 (7 q heads over 1 kv head) against the
  JAX Pallas kernels in interpret mode (1e-3).  Biases and qk-norm
  weights are drawn away from 0 / 1 so that a missing or misplaced one
  shows.
- HF transformers: the port's Llama, Qwen2 and Qwen3 on the ``TINY``
  configs of ``tests/test_hf_parity.py``, at its bounds (rtol = atol =
  2e-4), skipped where ``transformers`` is absent.
- ``fuse_params``'s ``bqkv`` and ``load_hf_state``'s parameters (with and
  without the optional keys) equal the JAX package's bit for bit.
- Greedy tokens of a tiny Qwen2 and Qwen3 trained here (on
  ``tests/quality_utils.py``'s corpus and byte tokenizer) equal the JAX
  engine's, its top-2 margins checked first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.models import llama as jllama
from arcticinference_tpu.models import qwen2 as jqwen2
from arcticinference_tpu.models import qwen3 as jqwen3
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models import get_model_module
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.models import qwen2 as tqwen2
from arcticinference_tpu_torch.models import qwen3 as tqwen3
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.weights import params_from_jax

import tests.test_torch_model as tm

JAX_MODULES = {"qwen2": jqwen2, "qwen3": jqwen3}
PORT_MODULES = {"qwen2": tqwen2, "qwen3": tqwen3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side (hundreds of small ops a
    step)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name,module", [
    ("qwen2", tqwen2), ("Qwen2ForCausalLM", tqwen2),
    ("qwen3", tqwen3), ("Qwen3ForCausalLM", tqwen3)])
def test_registry_serves_qwen(name, module):
    assert get_model_module(name) is module
    arch = module.Arch.from_hf_config(dict(hidden_size=64,
                                           num_attention_heads=4))
    assert arch.rope_theta == 1e6
    assert arch.attention_bias == (module is tqwen2)
    assert arch.qk_norm == (module is tqwen3)


# ---------------------------------------------------------------------------
# forward against the JAX modules
# ---------------------------------------------------------------------------

def qwen_models(family, head_dim, heads, kv_heads, quantization=None,
                perturb=True):
    """A 2-layer model of ``family`` (hidden 128, so int4 packs) from the
    JAX package, fused, and the port's copy of its parameters; with
    ``perturb`` biases of O(q) and norm weights away from 1, so that a
    missing or misplaced one shows (else the JAX init's: biases of std
    0.02, norm weights 1)."""
    cfg = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=heads,
               num_key_value_heads=kv_heads, head_dim=head_dim)
    jmod = JAX_MODULES[family]
    arch = jmod.Arch.from_hf_config(cfg)
    jparams = jmod.init_params(arch, jax.random.PRNGKey(0), jnp.float32,
                               quantization=quantization)
    rng = np.random.default_rng(7)
    layers = jparams["layers"]
    for key in ("bq", "bk", "bv") if perturb else ():
        if key in layers:
            layers[key] = jnp.asarray(rng.normal(
                0, 0.3, layers[key].shape).astype(np.float32))
    for key in ("q_norm", "k_norm") if perturb else ():
        if key in layers:
            layers[key] = jnp.asarray(rng.uniform(
                0.5, 1.5, layers[key].shape).astype(np.float32))
    jparams = jmod.fuse_params(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jparams, tparams


def forward_pair(arch, jparams, tparams, rng):
    """``run_both`` of ``tests/test_torch_model.py`` on a float32 paged
    cache (as the JAX package's own Qwen tests allocate it).  Returns the
    steps' (port, JAX) logits and the last step's first cache layer of
    each: no attention has touched it yet, so it holds the projections,
    biases, qk-norm and RoPE alone.  (Layers past the first are not held
    element by element: Qwen3's qk-norm scales k to O(1), so the
    attention's rounding moves them by more than ``run_both``'s bound.)"""
    caches = []
    out = tm.run_both(arch, jparams, tparams, tm.STEPS, rng,
                      kv_dtype="float32", caches=caches)
    kv_t, kv_j = caches[-1]
    return out, (kv_t[0], kv_j[0])


@pytest.mark.parametrize("quantization", [None, "fp8", "int4"])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_logits_match_jax_reference(monkeypatch, family, quantization):
    """head_dim 32, 4 q heads over 2; the JAX side runs its reference
    attention.  The first layer's cache agrees to float32 rounding."""
    monkeypatch.setenv("ARCTIC_TPU_DISABLE_PALLAS", "1")
    arch, jparams, tparams = qwen_models(family, 32, 4, 2, quantization)
    assert ("bqkv" in tparams["layers"]) == (family == "qwen2")
    assert ("q_norm" in tparams["layers"]) == (family == "qwen3")
    if quantization:
        assert isinstance(tparams["layers"]["wqkv"], tfp8.QuantizedLinear)
        assert not isinstance(tparams["layers"].get("bqkv"),
                              tfp8.QuantizedLinear)
    atol = {None: 1e-4, "fp8": 1e-5, "int4": 1e-3}[quantization]
    out, (kv_t, kv_j) = forward_pair(arch, jparams, tparams,
                                     np.random.default_rng(1))
    np.testing.assert_allclose(kv_t[1:], kv_j[1:], atol=1e-5, rtol=1e-5)
    for tl, jl in out:
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=atol, rtol=0)


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_logits_match_jax_reference_group_7(monkeypatch, family):
    """head_dim 128 with 7 q heads over one kv head (Qwen2.5-7B's group),
    against the JAX reference attention, float32 weights: 1e-4."""
    monkeypatch.setenv("ARCTIC_TPU_DISABLE_PALLAS", "1")
    arch, jparams, tparams = qwen_models(family, 128, 7, 1)
    out, (kv_t, kv_j) = forward_pair(arch, jparams, tparams,
                                     np.random.default_rng(0))
    np.testing.assert_allclose(kv_t[1:], kv_j[1:], atol=1e-5, rtol=1e-5)
    for tl, jl in out:
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantization", [None, "fp8", "int4"])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_logits_match_jax_pallas_group_7(monkeypatch, family, quantization):
    """head_dim 128 with 7 q heads over one kv head, the JAX side through
    its two Pallas kernels in interpret mode (the prefill's ragged kernel
    and the decode step's grouped kernel).  They round q and the softmax
    weights to bf16 before their products; with qk-norm's O(1) q and k
    (and, quantized, the bf16 rounding of every product's input, which
    XLA's excess precision keeps or drops by fusion on the JAX side),
    that moves these logits by 0.3-3.4e-3, past the 1e-3 that
    ``tests/test_torch_model.py`` gives the Llama case.  The bound is
    therefore the JAX package's own: the port may be at most twice as far
    from the JAX kernels as the JAX reference attention is, on the same
    weights and steps (plus 1e-4), and its first cache layer agrees to
    float32 rounding."""
    arch, jparams, tparams = qwen_models(family, 128, 7, 1, quantization)
    monkeypatch.setenv("ARCTIC_TPU_DISABLE_PALLAS", "1")
    ref, _ = forward_pair(arch, jparams, tparams, np.random.default_rng(0))
    monkeypatch.delenv("ARCTIC_TPU_DISABLE_PALLAS")
    monkeypatch.setenv("ARCTIC_TPU_FORCE_PALLAS_INTERPRET", "1")
    out, (kv_t, kv_j) = forward_pair(arch, jparams, tparams,
                                     np.random.default_rng(0))
    np.testing.assert_allclose(kv_t[1:], kv_j[1:], atol=1e-5, rtol=1e-5)
    for (tl, jl), (_, jref) in zip(out, ref):
        assert np.abs(jl).max() > 1e-2
        gap = np.abs(jref - jl).max()
        assert 0 < gap < 1e-2            # the kernels ran, and agree
        assert np.abs(tl - jl).max() <= 2 * gap + 1e-4


def test_fused_bias_matches_jax():
    """``bqkv`` is q|k|v's biases concatenated, as the JAX package's; the
    unfused parts are gone."""
    arch, jparams, tparams = qwen_models("qwen2", 32, 4, 2)
    raw = jqwen2.init_params(arch, jax.random.PRNGKey(0), jnp.float32)
    traw = params_from_jax(jax.tree.map(np.asarray, raw), "cpu")
    fused = tqwen2.fuse_params(traw)
    want = np.asarray(jqwen2.fuse_params(raw)["layers"]["bqkv"])
    assert "bq" not in fused["layers"]
    np.testing.assert_array_equal(fused["layers"]["bqkv"].numpy(), want)
    assert want.shape == (2, (4 + 2 + 2) * 32)


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_init_params_draws_the_variant_keys(family):
    arch = PORT_MODULES[family].Arch.from_hf_config(dict(
        vocab_size=64, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32))
    params = PORT_MODULES[family].init_params(
        arch, torch.Generator().manual_seed(0), torch.float32,
        quantization="fp8")
    layers = params["layers"]
    if family == "qwen2":
        assert [tuple(layers[k].shape) for k in ("bq", "bk", "bv")] == \
            [(2, 128), (2, 64), (2, 64)]
        assert layers["bq"].dtype == torch.float32
        assert "q_norm" not in layers
    else:
        assert torch.equal(layers["q_norm"], torch.ones(2, 32))
        assert torch.equal(layers["k_norm"], torch.ones(2, 32))
        assert "bq" not in layers
    assert isinstance(layers["wq"], tfp8.QuantizedLinear)


# ---------------------------------------------------------------------------
# HF transformers
# ---------------------------------------------------------------------------

T = 13  # prompt length (odd, not a block multiple)
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=112,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            tie_word_embeddings=False)


def hf_tensors(model):
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def port_logits(module, arch, params, ids):
    """One sequence's paged forward over all T rows, blocks of 4 from
    block 1 (block 0 is the engine's padding sink), float32 cache, the
    plain attention."""
    bs, n = 4, len(ids)
    kv = torch.zeros((arch.num_layers, 8, 2, bs,
                      arch.num_kv_heads * arch.head_dim))
    inputs = dict(
        input_ids=torch.from_numpy(ids),
        positions=torch.arange(n, dtype=torch.int32),
        req_idx=torch.zeros(n, dtype=torch.int32),
        slot_mapping=torch.arange(bs, bs + n, dtype=torch.int32),
        block_tables=torch.arange(1, -(-n // bs) + 1,
                                  dtype=torch.int32)[None],
        seq_lens=torch.tensor([n], dtype=torch.int32))
    _, h = module.forward(params, arch, kv, inputs,
                          attn_impl=module.plain_attn)
    return module.compute_logits(params, h).numpy()


def hf_case(name):
    transformers = pytest.importorskip("transformers")
    seed, module, cfg = {
        "llama": (0, tllama, lambda: transformers.LlamaConfig(
            **TINY, rope_theta=500000.0)),
        "llama3 rope": (1, tllama, lambda: transformers.LlamaConfig(
            **TINY, rope_theta=500000.0,
            rope_scaling=dict(rope_type="llama3", factor=8.0,
                              low_freq_factor=1.0, high_freq_factor=4.0,
                              original_max_position_embeddings=32))),
        "llama tied": (2, tllama, lambda: transformers.LlamaConfig(
            **dict(TINY, tie_word_embeddings=True))),
        "qwen2": (3, tqwen2, lambda: transformers.Qwen2Config(
            **TINY, rope_theta=1000000.0)),
        "qwen3": (4, tqwen3, lambda: transformers.Qwen3Config(
            **TINY, head_dim=24, rope_theta=1000000.0)),
    }[name]
    torch.manual_seed(seed)
    cfg = cfg()
    cls = {"llama": transformers.LlamaForCausalLM,
           "qwen2": transformers.Qwen2ForCausalLM,
           "qwen3": transformers.Qwen3ForCausalLM}[name.split()[0][:5]]
    model = cls(cfg).eval()
    return module, cfg, model


@pytest.mark.parametrize("name", ["llama", "llama3 rope", "llama tied",
                                  "qwen2", "qwen3"])
def test_logits_match_hf(name):
    """Convention bugs no internal oracle sees: RoPE half-rotation and
    llama3 scaling, Qwen2's qkv biases, Qwen3's per-head q/k RMSNorm
    before RoPE and its decoupled head_dim (24, which the CPU's plain
    attention takes at any width), GQA grouping, the name mapping."""
    module, cfg, model = hf_case(name)
    arch = module.Arch.from_hf_config(cfg.to_dict())
    params = module.fuse_params(module.load_hf_state(
        arch, hf_tensors(model), torch.float32, device="cpu"))
    if name == "qwen2":
        assert "bqkv" in params["layers"]
    ids = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                            T).astype(np.int32)
    got = port_logits(module, arch, params, ids)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids[None].astype(
            np.int64))).logits[0].float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,quantization", [
    ("llama", None), ("qwen2", None), ("qwen3", None), ("qwen2", "fp8"),
    ("qwen3", "int4")])
def test_load_hf_state_matches_jax(name, quantization):
    """The port's ``load_hf_state`` gives the JAX package's parameters
    (carried across by ``params_from_jax``) bit for bit: the five
    optional keys where the checkpoint has them and none where it does
    not; biases and norms unquantized."""
    module, cfg, model = hf_case(name)
    jmod = {"llama": jllama, "qwen2": jqwen2, "qwen3": jqwen3}[name]
    tensors = hf_tensors(model)
    arch = jmod.Arch.from_hf_config(cfg.to_dict())
    jp = jmod.load_hf_state(arch, {k: v.numpy() for k, v in
                                   tensors.items()}, jnp.float32,
                            quantization=quantization)
    want = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = module.load_hf_state(module.Arch.from_hf_config(cfg.to_dict()),
                               tensors, torch.float32,
                               quantization=quantization, device="cpu")
    variant = {"llama": (), "qwen2": ("bq", "bk", "bv"),
               "qwen3": ("q_norm", "k_norm")}[name]
    optional = {"bq", "bk", "bv", "q_norm", "k_norm"}
    assert optional & set(got["layers"]) == set(variant)
    assert got.keys() == want.keys()
    assert got["layers"].keys() == want["layers"].keys()

    def flat(p):
        for k, v in p.items():
            if isinstance(v, dict):
                yield from ((f"{k}.{kk}", vv) for kk, vv in flat(v))
            elif isinstance(v, tfp8.QuantizedLinear):
                yield f"{k}.weight", v.weight
                yield f"{k}.scale", v.scale
            else:
                yield k, v

    w = dict(flat(want))
    for k, v in flat(got):
        assert v.dtype == w[k].dtype, k
        assert torch.equal(v.view(torch.uint8) if v.element_size() == 1
                           else v, w[k].view(torch.uint8)
                           if w[k].element_size() == 1 else w[k]), k
    for k in variant:
        assert not isinstance(got["layers"][k], tfp8.QuantizedLinear)


# ---------------------------------------------------------------------------
# Trained tiny Qwen2 / Qwen3: greedy tokens against the JAX engine
# ---------------------------------------------------------------------------

def train_tiny_qwen(save_dir, family, steps=60, seed=0, seq_len=64,
                    batch=16, lr=3e-3):
    """``tests/quality_utils.train_tiny_checkpoint`` with the family's HF
    config (Qwen3 with head_dim 32): a tiny model trained on the Markov
    corpus with the byte tokenizer; returns the held-out ids."""
    import transformers

    from tests.quality_utils import HIDDEN, make_byte_tokenizer, make_corpus

    make_byte_tokenizer(save_dir)
    tokenizer = transformers.AutoTokenizer.from_pretrained(str(save_dir))
    ids = np.asarray(tokenizer.encode(make_corpus(seed=seed)), np.int64)
    split = int(len(ids) * 0.9)
    train_ids, heldout_ids = ids[:split], ids[split:]
    torch.manual_seed(seed)
    dims = dict(vocab_size=256, hidden_size=HIDDEN, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=4096,
                tie_word_embeddings=False)
    if family == "qwen2":
        cfg = transformers.Qwen2Config(**dims, rope_theta=10000.0)
        model = transformers.Qwen2ForCausalLM(cfg)
    else:
        cfg = transformers.Qwen3Config(**dims, head_dim=32,
                                       rope_theta=10000.0)
        model = transformers.Qwen3ForCausalLM(cfg)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed + 1)
    model.train()
    with torch.enable_grad():
        for _ in range(steps):
            starts = rng.integers(0, len(train_ids) - seq_len - 1, batch)
            x = torch.tensor(np.stack([train_ids[s:s + seq_len]
                                       for s in starts]))
            loss = model(input_ids=x, labels=x).loss
            opt.zero_grad()
            loss.backward()
            opt.step()
    model.eval()
    model.save_pretrained(str(save_dir))
    return heldout_ids


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_trained_greedy_tokens_match_jax_engine(tmp_path, family):
    pytest.importorskip("transformers")
    heldout = train_tiny_qwen(tmp_path, family)
    d = dict(model=dict(model=str(tmp_path), max_model_len=256,
                        dtype="float32"),
             cache=dict(num_blocks=64),
             scheduler=dict(max_num_seqs=4, max_num_batched_tokens=32))
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 45), (120, 25), (200, 70))]
    jax_llm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    ref = jax_llm.generate(
        prompt_token_ids=prompts,
        sampling_params=JaxSamplingParams(max_tokens=12, logprobs=2))
    jax_llm.close()
    for o in ref:
        for top2 in o.logprobs:
            a, b = sorted(top2.values(), reverse=True)
            assert a - b > 1e-4, "near tie in the JAX run"
    llm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    assert llm.engine.arch.attention_bias == (family == "qwen2")
    assert llm.engine.arch.qk_norm == (family == "qwen3")
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=SamplingParams(max_tokens=12))
    llm.close()
    for o, r in zip(outs, ref):
        assert o.token_ids == r.token_ids
        assert o.text == r.text
    # Trained: the continuations are not one repeated token.
    assert len({t for o in outs for t in o.token_ids}) > 4
