"""The port's BERT encoders against the JAX package's.

Float32 on the CPU, a small arch (2 layers, hidden 64, 4 heads of 16,
vocab 97), the JAX parameters carried across with ``params_from_jax``
(the same bytes):

- ``forward`` within 1e-4 of ``bert.forward`` (a row partly padded and
  a row all padding, which stays finite: the ``-1e30`` mask);
- ``pool`` for cls / mean / max / last, with and without normalisation,
  within 1e-5 on the same hidden states;
- padding invariance of the real tokens' hidden states;
- ``load_hf_state`` with and without the ``bert.`` prefix gives the JAX
  loader's parameters;
- a Hugging Face ``BertModel`` within 2e-4 (skipped without
  ``transformers``);
- ``LLM.encode`` (the ``EncoderRunner``) against the JAX ``LLM.encode``
  within 1e-4 on a prompt list that splits into 6 device batches over 3
  token buckets, with the same batch shapes; ``generate`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.encoder import EncoderRunner as JaxRunner
from arcticinference_tpu.engine.encoder import _bucket as jax_bucket
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.models import bert as jbert
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.encoder import EncoderRunner
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.models import bert as tbert
from arcticinference_tpu_torch.weights import params_from_jax

HF = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, type_vocab_size=2, hidden_act="gelu")


def config_dict(hf=None):
    return dict(
        model=dict(model="bert", hf_overrides=hf or HF, max_model_len=64,
                   dtype="float32"),
        cache=dict(num_blocks=16),
        scheduler=dict(max_num_seqs=4, max_num_batched_tokens=64))


@pytest.fixture(scope="module")
def model():
    """(JAX arch, JAX params, port arch, port params): the same weights,
    with non-zero biases, LayerNorm gains and type embeddings."""
    jarch = jbert.BertArch.from_hf_config(HF)
    jp = jbert.init_params(jarch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    np_tree = jax.tree.map(np.asarray, jp)
    for tree in (np_tree, np_tree["layers"]):
        for k, v in tree.items():
            if isinstance(v, np.ndarray) and k != "word_emb":
                tree[k] = (v + rng.normal(0, 0.05, v.shape)) \
                    .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_tree)
    return (jarch, jp, tbert.BertArch.from_hf_config(HF),
            params_from_jax(np_tree, "cpu"))


def _batch(rng, b, t, lens):
    ids = rng.integers(1, HF["vocab_size"], (b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.asarray(lens)[:, None]) \
        .astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _both(model, ids, mask):
    jarch, jp, tarch, tp = model
    jh = np.asarray(jbert.forward(jp, jarch, {
        "input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}))
    th = tbert.forward(tp, tarch, {
        "input_ids": torch.from_numpy(ids),
        "attention_mask": torch.from_numpy(mask)}).numpy()
    return jh, th


def test_arch_from_hf_config_matches_jax():
    for cfg in (HF, dict(HF, hidden_act="gelu_new", pad_token_id=None,
                         layer_norm_eps=1e-5), {}):
        assert tbert.BertArch.from_hf_config(cfg).__dict__ == \
            jbert.BertArch.from_hf_config(cfg).__dict__


def test_forward_matches_jax(model):
    ids, mask = _batch(np.random.default_rng(1), 3, 24, [24, 9, 0])
    jh, th = _both(model, ids, mask)
    assert np.isfinite(th).all()
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-4)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("method", ["mean", "cls", "max", "last"])
def test_pool_matches_jax(model, method, normalize):
    ids, mask = _batch(np.random.default_rng(2), 3, 16, [16, 5, 11])
    jh, th = _both(model, ids, mask)
    want = np.asarray(jbert.pool(jnp.asarray(jh), jnp.asarray(mask),
                                 method, normalize))
    got = tbert.pool(torch.from_numpy(th), torch.from_numpy(mask), method,
                     normalize).numpy()
    assert got.shape == (3, HF["hidden_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)


def test_padding_invariance(model):
    _, _, tarch, tp = model
    ids, mask = _batch(np.random.default_rng(3), 1, 12, [12])
    ids_p = np.zeros((1, 32), np.int32)
    ids_p[:, :12] = ids
    mask_p = np.zeros((1, 32), np.int32)
    mask_p[:, :12] = 1

    def run(i, m):
        return tbert.forward(tp, tarch, {
            "input_ids": torch.from_numpy(i),
            "attention_mask": torch.from_numpy(m)}).numpy()

    np.testing.assert_allclose(run(ids_p, mask_p)[:, :12], run(ids, mask),
                               rtol=1e-5, atol=1e-5)


def _hf_tensors(np_tree, prefix=""):
    """The parameters under Hugging Face ``BertModel`` names ([out, in]
    Linear weights)."""
    out = {
        "embeddings.word_embeddings.weight": np_tree["word_emb"],
        "embeddings.position_embeddings.weight": np_tree["pos_emb"],
        "embeddings.token_type_embeddings.weight": np_tree["type_emb"],
        "embeddings.LayerNorm.weight": np_tree["emb_ln_g"],
        "embeddings.LayerNorm.bias": np_tree["emb_ln_b"],
    }
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w_in": "intermediate.dense", "w_out": "output.dense"}
    biases = {"bq": "wq", "bk": "wk", "bv": "wv", "bo": "wo",
              "b_in": "w_in", "b_out": "w_out"}
    norms = {"ln1_g": "attention.output.LayerNorm.weight",
             "ln1_b": "attention.output.LayerNorm.bias",
             "ln2_g": "output.LayerNorm.weight",
             "ln2_b": "output.LayerNorm.bias"}
    lay = np_tree["layers"]
    for i in range(lay["wq"].shape[0]):
        p = f"encoder.layer.{i}."
        for k, n in names.items():
            out[p + n + ".weight"] = np.ascontiguousarray(lay[k][i].T)
        for k, w in biases.items():
            out[p + names[w] + ".bias"] = lay[k][i]
        for k, n in norms.items():
            out[p + n] = lay[k][i]
    return {prefix + k: v for k, v in out.items()}


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_load_hf_state_matches_jax(model, prefix):
    jarch, jp, tarch, _ = model
    tensors = _hf_tensors(jax.tree.map(np.asarray, jp), prefix)
    want = jax.tree.map(np.asarray,
                        jbert.load_hf_state(jarch, tensors, jnp.float32))
    got = tbert.load_hf_state(
        tarch, {k: torch.from_numpy(v) for k, v in tensors.items()},
        torch.float32, device="cpu")
    assert got.keys() == want.keys()
    assert got["layers"].keys() == want["layers"].keys()
    for k in ("word_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), v)


def test_matches_hf_bert_model(model):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(**HF)).eval()
    tarch = tbert.BertArch.from_hf_config(HF)
    tp = tbert.load_hf_state(tarch, dict(hf.state_dict()), torch.float32,
                             device="cpu")
    ids, mask = _batch(np.random.default_rng(4), 3, 17, [17, 10, 13])
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask)).last_hidden_state
    got = tbert.forward(tp, tarch, {"input_ids": torch.from_numpy(ids),
                                    "attention_mask": torch.from_numpy(mask)})
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want.numpy()[real],
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# LLM.encode on the EncoderRunner
# ---------------------------------------------------------------------------

# 10 prompts of 3-40 tokens under a 64-token budget, batches of <= 4:
# six device batches, buckets of 16, 32 and 64 tokens.
LENGTHS = (3, 17, 40, 9, 33, 12, 5, 20, 30, 8)


@pytest.fixture(scope="module")
def llms(model):
    d = config_dict()
    jllm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    jllm.encoder.params = model[1]
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    tllm.encoder.params = model[3]
    return jllm, tllm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(5)
    return [[int(x) for x in rng.integers(1, HF["vocab_size"], n)]
            for n in LENGTHS]


@pytest.mark.parametrize("pooling,normalize", [
    ("mean", None), ("cls", None), ("max", False), ("last", False)])
def test_llm_encode_matches_jax(llms, prompts, pooling, normalize,
                                monkeypatch):
    jllm, tllm = llms
    assert tllm.engine is None and isinstance(tllm.encoder, EncoderRunner)
    shapes = {"jax": [], "port": []}
    run_batch = JaxRunner._run_batch
    pooled = EncoderRunner.pooled

    def jax_batch(self, batch, *a):
        shapes["jax"].append((
            jax_bucket(len(batch), 1, self.max_batch),
            jax_bucket(max(len(x) for x in batch), 16, self.max_len)))
        return run_batch(self, batch, *a)

    def port_pooled(self, ids, mask, *a):
        shapes["port"].append(tuple(ids.shape))
        return pooled(self, ids, mask, *a)

    monkeypatch.setattr(JaxRunner, "_run_batch", jax_batch)
    monkeypatch.setattr(EncoderRunner, "pooled", port_pooled)
    kw = {} if normalize is None else dict(normalize=normalize)
    want = jllm.encode(prompt_token_ids=prompts, pooling=pooling, **kw)
    got = tllm.encode(prompt_token_ids=prompts, pooling=pooling, **kw)
    assert shapes["port"] == shapes["jax"]
    assert len(shapes["port"]) >= 3
    assert len({t for _, t in shapes["port"]}) >= 2
    assert len(got) == len(prompts)
    for g, w in zip(got, want):
        assert g.shape == (HF["hidden_size"],) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    if normalize is None:       # an encoder normalizes by default
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)


def test_encode_truncates_to_max_len(llms):
    _, tllm = llms
    long = list(range(1, 90))          # max_len: the 64 positions
    a, b = tllm.encode(prompt_token_ids=[long, long[:64]])
    np.testing.assert_array_equal(a, b)


def test_generate_raises_on_an_encoder(llms):
    _, tllm = llms
    with pytest.raises(ValueError, match="encoder-only"):
        tllm.generate(prompt_token_ids=[[1, 2, 3]])
    tllm.close()        # no engine to close: a no-op
