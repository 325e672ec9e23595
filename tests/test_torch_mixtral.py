"""The port's Mixtral against the JAX package's and HF's.

- Registry: ``get_model_module`` gives the port's Mixtral module; the
  speculator checkpoints are still refused as targets.
- ``_moe_mlp`` against the JAX ``mixtral._moe_mlp`` (top-1 and top-2, 4
  and 8 experts, float32, at ``tests/test_moe.py``'s 2e-4) and against
  its per-token numpy loop (``moe_oracle``); quantized experts (fp8 with
  one scale a layer or one an expert, int8, int4) against the JAX block
  on the same bytes.
- ``forward`` logits against the JAX ``mixtral.forward`` on a paged
  bf16 cache through ``params_from_jax`` and
  ``tests/test_torch_model.py::run_both`` (float32 activations, head_dim
  32, the JAX reference attention): unquantized and fp8, at 1e-4.
- ``init_params`` gives the JAX package's keys, shapes, dtypes and scale
  layouts in every mode; ``load_hf_state`` the JAX loader's parameters
  bit for bit (unquantized, fp8, int8, int4 packed), and the same
  ``ValueError``s; ``from_hf_config`` reads Mixtral-8x7B's config.
- HF ``MixtralForCausalLM`` at ``tests/test_hf_parity.py``'s bounds
  (rtol = atol = 5e-4, argmax checked); skipped without ``transformers``.
- A tiny Mixtral (4 experts, top-2) trained here on
  ``tests/quality_utils.py``'s corpus: the port's greedy tokens equal
  the JAX engine's, its top-2 margins checked first, on the pipelined
  step (the default) and on the fused suffix loop, which also equals
  the port's run without speculation, with drafts verified.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.engine.request import (
    SamplingParams as JaxSamplingParams)
from arcticinference_tpu.models import mixtral as jmixtral
from arcticinference_tpu.ops import fp8 as jfp8
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models import get_model_module
from arcticinference_tpu_torch.models import mixtral as tmixtral
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.weights import params_from_jax

import tests.test_torch_model as tm
from tests.test_moe import make_moe_layer, moe_oracle


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side (hundreds of small ops a
    step)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_registry_serves_mixtral():
    assert get_model_module("MixtralForCausalLM") is tmixtral
    assert get_model_module("mixtral") is tmixtral
    with pytest.raises(NotImplementedError, match="speculator"):
        get_model_module("ArcticMLPSpeculatorPreTrainedModel")


def port_arch(jarch) -> tmixtral.MixtralArch:
    return tmixtral.MixtralArch(**{
        f.name: getattr(jarch, f.name)
        for f in dataclasses.fields(tmixtral.MixtralArch)})


def jax_layer(d, f, e, seed):
    lp = make_moe_layer(jax.random.PRNGKey(seed), d, f, e)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (13, d),
                          jnp.float32)
    return lp, x


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_moe_mlp_matches_jax_and_the_loop(e, k):
    d, f = 32, 48
    lp, x = jax_layer(d, f, e, seed=e + k)
    jarch = jmixtral.MixtralArch(
        vocab_size=64, hidden_size=d, intermediate_size=f, num_layers=1,
        num_heads=4, num_kv_heads=4, head_dim=8, num_experts=e,
        num_experts_per_tok=k)
    want = np.asarray(jmixtral._moe_mlp(x, lp, jarch, None))
    tlp = params_from_jax(jax.tree.map(np.asarray, lp), "cpu")
    got = tmixtral._moe_mlp(torch.from_numpy(np.array(x)), tlp,
                            port_arch(jarch)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, moe_oracle(x, lp, k), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("mode", ["fp8", "fp8 expert", "int8", "int4"])
def test_moe_mlp_quantized_experts_match_jax(mode):
    """Quantized experts, dequantized to bf16 before the products in both
    packages (int4 packed: the expert input dims are 128 and 256)."""
    d, f, e = 128, 256, 4
    lp, x = jax_layer(d, f, e, seed=11)
    for key in ("w_gate", "w_up", "w_down"):
        w = lp[key]
        if mode == "fp8":   # a layer of a quantized [L, E, in, out] stack
            q = jfp8.weight_quantize(w[None], "fp8")
            lp[key] = jfp8.QuantizedLinear(q.weight[0], q.scale[0])
        else:
            lp[key] = jfp8.weight_quantize(w, mode.split()[0])
    jarch = jmixtral.MixtralArch(
        vocab_size=64, hidden_size=d, intermediate_size=f, num_layers=1,
        num_heads=4, num_kv_heads=4, head_dim=32, num_experts=e,
        num_experts_per_tok=2)
    want = np.asarray(jmixtral._moe_mlp(x, lp, jarch, None))
    tlp = params_from_jax(jax.tree.map(np.asarray, lp), "cpu")
    assert isinstance(tlp["w_gate"], tfp8.QuantizedLinear)
    got = tmixtral._moe_mlp(torch.from_numpy(np.array(x)), tlp,
                            port_arch(jarch)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def make_models(quantization=None):
    cfg = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32, rope_theta=1e6,
               num_local_experts=4, num_experts_per_tok=2)
    arch = jmixtral.MixtralArch.from_hf_config(cfg)
    jparams = jmixtral.init_params(arch, jax.random.PRNGKey(0), jnp.float32,
                                   quantization=quantization)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jparams, tparams


@pytest.mark.parametrize("quantization", [None, "fp8"])
def test_logits_match_jax_reference(quantization):
    """Prefill and decode steps (``tests/test_torch_model.STEPS``) through
    both modules, the caches held together at each step."""
    arch, jparams, tparams = make_models(quantization)
    if quantization:
        assert isinstance(tparams["layers"]["w_gate"], tfp8.QuantizedLinear)
    rng = np.random.default_rng(0)
    for tl, jl in tm.run_both(arch, jparams, tparams, tm.STEPS, rng,
                              jmod=jmixtral, tmod=tmixtral):
        assert np.abs(jl).max() > 1e-2
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def flat(p, prefix=""):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        elif isinstance(v, tfp8.QuantizedLinear):
            yield f"{prefix}{k}.weight", v.weight
            yield f"{prefix}{k}.scale", v.scale
        else:
            yield f"{prefix}{k}", v


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("quantization", [None, "fp8", "int8", "int4"])
def test_init_params_layout_matches_jax(quantization):
    """Keys, shapes, dtypes and scale layouts of the JAX ``init_params``
    (experts drawn and quantized one layer at a time here)."""
    arch, _, want = make_models(quantization)
    gen = torch.Generator().manual_seed(0)
    got = tmixtral.init_params(port_arch(arch), gen, torch.float32,
                               quantization=quantization, device="cpu")
    w, g = dict(flat(want)), dict(flat(got))
    assert g.keys() == w.keys()
    for k, v in g.items():
        assert (v.shape, v.dtype) == (w[k].shape, w[k].dtype), k


def hf_state(d=128, f=256, e=4, layers=2, v=64, hq=128, hkv=64, seed=0):
    """A tiny HF Mixtral state dict (numpy float32)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tensors = {"model.embed_tokens.weight": a(v, d),
               "model.norm.weight": np.ones(d, np.float32),
               "lm_head.weight": a(v, d)}
    for li in range(layers):
        p = f"model.layers.{li}."
        tensors.update({
            p + "self_attn.q_proj.weight": a(hq, d),
            p + "self_attn.k_proj.weight": a(hkv, d),
            p + "self_attn.v_proj.weight": a(hkv, d),
            p + "self_attn.o_proj.weight": a(d, hq),
            p + "input_layernorm.weight": 1 + 0.1 * a(d),
            p + "post_attention_layernorm.weight": 1 + 0.1 * a(d),
            p + "block_sparse_moe.gate.weight": a(e, d)})
        for ei in range(e):
            ep = p + f"block_sparse_moe.experts.{ei}."
            tensors[ep + "w1.weight"] = a(f, d)
            tensors[ep + "w2.weight"] = a(d, f)
            tensors[ep + "w3.weight"] = a(f, d)
    return tensors


HF_ARCH = jmixtral.MixtralArch(
    vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, num_experts=4,
    num_experts_per_tok=2)


@pytest.mark.parametrize("quantization", [None, "fp8", "int8", "int4"])
def test_load_hf_state_matches_jax(quantization):
    tensors = hf_state()
    jp = jmixtral.load_hf_state(HF_ARCH, tensors, jnp.float32,
                                quantization=quantization)
    want = dict(flat(params_from_jax(jax.tree.map(np.asarray, jp), "cpu")))
    got = dict(flat(tmixtral.load_hf_state(
        port_arch(HF_ARCH), {k: torch.from_numpy(v)
                             for k, v in tensors.items()},
        torch.float32, quantization=quantization, device="cpu")))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(bits(v), bits(want[k])), k
    if quantization == "int4":
        assert got["layers.w_down.scale"].shape == (2, 4, 2, 128)


def test_load_hf_state_raises_as_jax():
    tensors = {k: torch.from_numpy(v) for k, v in hf_state().items()}
    arch = port_arch(HF_ARCH)
    for name, match in (
            ("model.layers.1.block_sparse_moe.experts.3.w1.weight",
             "layer 1 missing experts \\[3\\] for w_gate"),
            ("model.layers.0.self_attn.k_proj.weight",
             "missing layers \\[0\\] for wk"),
            ("model.layers.1.block_sparse_moe.gate.weight",
             "missing block_sparse_moe.gate")):
        broken = dict(tensors)
        broken.pop(name)
        with pytest.raises(ValueError, match=match):
            tmixtral.load_hf_state(arch, broken, torch.float32,
                                   device="cpu")
        with pytest.raises(ValueError, match=match):
            jmixtral.load_hf_state(HF_ARCH, {k: v.numpy() for k, v in
                                             broken.items()}, jnp.float32)


def test_hf_config_mixtral_8x7b():
    cfg = {"vocab_size": 32000, "hidden_size": 4096,
           "intermediate_size": 14336, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "num_local_experts": 8, "num_experts_per_tok": 2,
           "rope_theta": 1e6, "sliding_window": None}
    got = tmixtral.MixtralArch.from_hf_config(cfg)
    want = jmixtral.MixtralArch.from_hf_config(cfg)
    assert got == port_arch(want)
    assert (got.num_experts, got.num_experts_per_tok, got.head_dim,
            got.moe_capacity_factor) == (8, 2, 128, 0.0)


def test_logits_match_hf():
    """Mixtral's softmax-after-top-k router, the expert naming (w1 gate,
    w3 up, w2 down) and the Llama stack, against HF at its parity test's
    bounds."""
    transformers = pytest.importorskip("transformers")
    from tests.test_torch_qwen import TINY, hf_tensors, port_logits

    torch.manual_seed(5)
    cfg = transformers.MixtralConfig(**TINY, num_local_experts=4,
                                     num_experts_per_tok=2,
                                     rope_theta=1000000.0)
    model = transformers.MixtralForCausalLM(cfg).eval()
    arch = tmixtral.MixtralArch.from_hf_config(cfg.to_dict())
    params = tmixtral.load_hf_state(arch, hf_tensors(model), torch.float32,
                                    device="cpu")
    ids = np.random.default_rng(6).integers(1, cfg.vocab_size,
                                            13).astype(np.int32)
    got = port_logits(tmixtral, arch, params, ids)
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(ids[None].astype(
            np.int64))).logits[0].float().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_llm_defaults_to_the_card():
    cfg = tcfg.EngineConfig(model=tcfg.ModelConfig(
        model="mixtral", dtype="float32", max_model_len=64,
        hf_overrides=dict(vocab_size=64, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=1,
                          num_attention_heads=2, num_key_value_heads=1,
                          num_local_experts=4, num_experts_per_tok=2)),
        cache=tcfg.CacheConfig(num_blocks=16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda:0"):
            LLM(cfg)
    llm = LLM(cfg, device="cpu")
    assert llm.engine.runner.device == torch.device("cpu")
    assert "wq" in llm.engine.runner.params["layers"]   # not fused
    outs = llm.generate(prompt_token_ids=[[1, 2, 3]],
                        sampling_params=SamplingParams(max_tokens=4))
    assert len(outs[0].token_ids) == 4
    llm.close()


# ---------------------------------------------------------------------------
# A tiny Mixtral trained here: greedy tokens against the JAX engine
# ---------------------------------------------------------------------------

def train_tiny_mixtral(save_dir, steps=60, seed=0, seq_len=64, batch=16,
                       lr=3e-3):
    """``tests/test_torch_qwen.train_tiny_qwen`` with HF's
    ``MixtralConfig`` (4 experts, top-2, 4 heads of 32 over 2): a tiny
    model trained on the Markov corpus with the byte tokenizer; returns
    the held-out ids."""
    import transformers

    from tests.quality_utils import HIDDEN, make_byte_tokenizer, make_corpus

    make_byte_tokenizer(save_dir)
    tokenizer = transformers.AutoTokenizer.from_pretrained(str(save_dir))
    ids = np.asarray(tokenizer.encode(make_corpus(seed=seed)), np.int64)
    split = int(len(ids) * 0.9)
    train_ids, heldout_ids = ids[:split], ids[split:]
    torch.manual_seed(seed)
    cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=HIDDEN, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=4096, tie_word_embeddings=False,
        rope_theta=10000.0, num_local_experts=4, num_experts_per_tok=2)
    model = transformers.MixtralForCausalLM(cfg)
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


def test_trained_greedy_tokens_match_jax_engine(tmp_path):
    pytest.importorskip("transformers")
    heldout = train_tiny_mixtral(tmp_path)
    d = dict(model=dict(model=str(tmp_path), max_model_len=256,
                        dtype="float32"),
             cache=dict(num_blocks=64),
             scheduler=dict(max_num_seqs=4, max_num_batched_tokens=32))
    # The last prompt repeats a held-out stretch, so that the suffix
    # cache drafts from the prompt at once.
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 45), (120, 25))]
    prompts.append([int(t) for t in heldout[300:330]] * 2)
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
    assert llm.engine.arch.num_experts == 4
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=SamplingParams(max_tokens=12))
    assert set(llm.engine.step_times.summary()) == {"pipelined"}
    llm.close()
    for o, r in zip(outs, ref):
        assert o.token_ids == r.token_ids
        assert o.text == r.text
    # Trained: the continuations are not one repeated token.
    assert len({t for o in outs for t in o.token_ids}) > 4

    spec = LLM(tcfg.EngineConfig.from_dict(
        dict(d, speculative=dict(method="suffix"))), device="cpu")
    assert spec.engine._fused is not None
    fused = spec.generate(prompt_token_ids=prompts,
                          sampling_params=SamplingParams(max_tokens=12))
    assert spec.engine.step_times.summary().get("fused", {}).get(
        "count", 0) > 0
    assert spec.engine.spec_stats.num_drafts > 0
    spec.close()
    for f, o in zip(fused, outs):
        assert f.token_ids == o.token_ids
