"""The port's tiny trained checkpoint (``benchmarks/tiny_markov.py``) and
byte-level tokenizer (``byte_tokenizer.py``) against the JAX harness's
(``tests/quality_utils.py``) and Hugging Face.

- the Markov corpus equals the JAX harness's string;
- the tokenizer's ids and text equal HF's ``make_byte_tokenizer``
  tokenizer (on the corpus, all 256 single ids, random id runs and
  non-ASCII text), the written ``tokenizer.json`` equals the file
  ``tokenizers`` saves and loads through ``AutoTokenizer`` to the same
  ids, and ``load_tokenizer`` reads it without ``transformers``;
- the trainer's forward and loss equal ``transformers.
  LlamaForCausalLM`` on the same weights in float32 (atol 1e-5), for the
  port's head split (2 x 64 over 1) and the JAX harness's (4 x 32 over
  2); a short run lowers the loss;
- a written checkpoint gives the same logits through the JAX loader and
  module as through the port's (float32 weights over the runners' bf16
  KV cache, atol 1e-4 as ``tests/test_torch_model.py``), for both
  splits, and every parameter the port's loader builds from it is
  contiguous, quantized or not.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.benchmarks import quality_gate as qg
from arcticinference_tpu_torch.benchmarks import tiny_markov as tm
from arcticinference_tpu_torch.byte_tokenizer import (ByteLevelTokenizer,
                                                      write_tokenizer)
from arcticinference_tpu_torch.engine import llm as tllm
from tests import quality_utils as qu

SPLITS = [(2, 1), (4, 2)]
SPLIT_IDS = ["port 2x64/1", "jax 4x32/2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def hf_tokenizer(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    d = tmp_path_factory.mktemp("hf_byte_tok")
    qu.make_byte_tokenizer(d)
    return d, transformers.AutoTokenizer.from_pretrained(str(d))


@pytest.mark.parametrize("n_words", [4000, 16000])
def test_corpus_matches_jax(n_words):
    assert tm.make_corpus(n_words=n_words, seed=0) == \
        qu.make_corpus(n_words=n_words, seed=0)


def test_tokenizer_matches_hf(hf_tokenizer):
    _, hf = hf_tokenizer
    tok = ByteLevelTokenizer()
    text = tm.make_corpus()
    assert tok.encode(text) == hf.encode(text)
    assert tm.corpus_ids().tolist() == hf.encode(text)
    for s in ("héllo ✓ wörld", "a\tb\nc", "{\"count\": 12}", "日本語"):
        assert tok.encode(s) == hf.encode(s)
        assert tok.decode(tok.encode(s)) == s
    assert [tok.decode([i]) for i in range(256)] == \
        [hf.decode([i]) for i in range(256)]
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, 256, int(rng.integers(1, 40))).tolist()
        assert tok.decode(ids) == hf.decode(ids)
        assert tok.decode(ids, skip_special_tokens=True) == \
            hf.decode(ids, skip_special_tokens=True)
    assert tok.eos_token_id == hf.eos_token_id is None
    assert len(tok) == len(hf) == tok.vocab_size == hf.vocab_size == 256


def test_written_tokenizer_is_hfs_file(tmp_path, hf_tokenizer):
    import transformers

    hf_dir, hf = hf_tokenizer
    write_tokenizer(tmp_path)
    def doc(d):
        return json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))

    assert doc(tmp_path) == doc(hf_dir)
    loaded = transformers.AutoTokenizer.from_pretrained(str(tmp_path))
    text = tm.make_corpus(n_words=200)
    assert loaded.encode(text) == ByteLevelTokenizer().encode(text)


def test_load_tokenizer_reads_byte_level_without_transformers(
        tmp_path, monkeypatch):
    """Chosen by the file's form: with ``transformers`` blocked, the
    byte-level file loads, and the same file with one merge added falls
    to ``transformers`` and raises."""
    write_tokenizer(tmp_path)
    cfg = tcfg.EngineConfig.from_dict(dict(model=dict(model=str(tmp_path))))
    monkeypatch.setitem(sys.modules, "transformers", None)
    tok = tllm.load_tokenizer(cfg)
    assert isinstance(tok, ByteLevelTokenizer)
    assert tok.decode(tok.encode("moon star")) == "moon star"
    path = tmp_path / "tokenizer.json"
    doc = json.loads(path.read_text(encoding="utf-8"))
    doc["model"]["merges"] = [["s", "u"]]
    path.write_text(json.dumps(doc))
    with pytest.raises(RuntimeError, match="transformers package"):
        tllm.load_tokenizer(cfg)


@pytest.mark.parametrize("heads", SPLITS, ids=SPLIT_IDS)
def test_forward_and_loss_match_hf(heads):
    transformers = pytest.importorskip("transformers")
    model = tm.TinyLlama(*heads)
    model.init_weights(torch.Generator().manual_seed(0))
    cfg = {k: v for k, v in tm.hf_config(*heads).items()
           if k not in ("architectures", "torch_dtype")}
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**cfg))
    hf.load_state_dict(model.state_dict(), strict=True)
    hf.eval()
    x = torch.from_numpy(tm.corpus_ids()[:3 * 48].reshape(3, 48))
    with torch.no_grad():
        ref = hf(input_ids=x, labels=x)
        np.testing.assert_allclose(model(x).numpy(), ref.logits.numpy(),
                                   atol=1e-5, rtol=0)
        assert abs(float(model.loss(x)) - float(ref.loss)) < 1e-5


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A short training run per head split (40 steps)."""
    out = {}
    for heads in SPLITS:
        d = tmp_path_factory.mktemp(f"tiny_{heads[0]}x{heads[1]}")
        _, heldout = tm.train_tiny_checkpoint(
            d, steps=40, num_heads=heads[0], num_kv_heads=heads[1],
            device="cpu")
        out[heads] = (str(d), heldout)
    return out


def test_training_lowers_the_loss(checkpoints):
    d, heldout = checkpoints[SPLITS[0]]
    m = tm.read_train_metrics(d)
    assert m["steps"] == 40 and m["device"] == "cpu"
    assert m["final_loss"] < 0.6 * m["first_loss"], m
    assert len(heldout) == len(tm.corpus_ids()) - int(
        len(tm.corpus_ids()) * 0.9)
    cfg = json.loads(open(f"{d}/config.json").read())
    assert cfg["num_attention_heads"] == 2 and cfg["head_dim"] == 64


@pytest.mark.parametrize("heads", SPLITS, ids=SPLIT_IDS)
def test_checkpoint_logits_match_jax(checkpoints, heads):
    from arcticinference_tpu.config import ModelConfig as JModelConfig
    from arcticinference_tpu.models.loader import load_model
    from arcticinference_tpu.ops.kv_cache import (KVCacheSpec,
                                                  allocate_kv_cache)
    from arcticinference_tpu_torch.engine.llm import LLM

    d, heldout = checkpoints[heads]
    ids = np.asarray(heldout[:96], np.int32)
    module, arch, params = load_model(JModelConfig(
        model=d, dtype="float32", max_model_len=2048))
    assert (arch.num_heads, arch.num_kv_heads) == heads
    spec = KVCacheSpec(num_layers=arch.num_layers, num_blocks=8,
                       num_kv_heads=arch.num_kv_heads, block_size=16,
                       head_dim=arch.head_dim, dtype=jnp.bfloat16)
    inputs = dict(
        input_ids=jnp.asarray(ids),
        positions=jnp.arange(len(ids), dtype=jnp.int32),
        req_idx=jnp.zeros(len(ids), jnp.int32),
        slot_mapping=jnp.arange(len(ids), dtype=jnp.int32),
        block_tables=jnp.arange(len(ids) // 16, dtype=jnp.int32)[None],
        seq_lens=jnp.asarray([len(ids)], jnp.int32))
    _, h = module.forward(params, arch, allocate_kv_cache(spec), inputs)
    ref = np.asarray(module.compute_logits(params, h), np.float64)
    with LLM(qg.engine_config(d, dtype="float32", block_size=16),
             device="cpu") as llm:
        got = llm.engine.prompt_logits(ids)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantization", [None, "fp8", "int8", "int4"])
def test_loaded_checkpoint_is_contiguous(checkpoints, quantization):
    """Every parameter the loader builds from the checkpoint is
    contiguous: the card's matmul kernels refuse strided operands (the
    LM head, transposed from HF's [vocab, hidden], once reached kernel 5
    as a strided view)."""
    from arcticinference_tpu_torch.models.loader import load_model
    from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

    d, _ = checkpoints[SPLITS[0]]
    _, _, params = load_model(tcfg.ModelConfig(
        model=d, quantization=quantization), device="cpu")
    leaves = [params["lm_head"], params["embed"],
              *params["layers"].values()]
    for leaf in leaves:
        for t in ((leaf.weight, leaf.scale)
                  if isinstance(leaf, QuantizedLinear) else (leaf,)):
            assert t.is_contiguous(), (t.shape, t.stride())
