"""``LLM.score`` of the port against the JAX package's, and the ``LLM``
context manager.

On the trained tiny checkpoint (float32), teacher-forced per-token
logprobs agree with the JAX ``LLM.score`` to 1e-4: sequences batched
whole, a batch split by ``max_num_batched_tokens`` (and by
``max_num_seqs``), and a sequence over the token budget raising in both.
The LM head's 256-row chunks give the same logprobs as chunks of 8
rows.  The bare engine scores too (the server's echo path), and
borrows no cache block for good.
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine import llm as tllm
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.runner import ModelRunner

from tests.test_torch_engine import TINY, config_dict, trained  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def llms(trained):  # noqa: F811
    path, heldout = trained
    d = config_dict(model=path)
    jax_llm = JaxLLM(jcfg.EngineConfig.from_dict(d))
    with LLM(tcfg.EngineConfig.from_dict(d), device="cpu") as llm:
        yield jax_llm, llm, heldout
    jax_llm.close()


def _seqs(heldout, spans):
    return [[int(t) for t in heldout[s:s + n]] for s, n in spans]


@pytest.mark.parametrize("spans", [
    ((0, 12), (40, 9), (90, 7)),                  # one batch (28 tokens)
    ((0, 20), (30, 15), (60, 30), (100, 2)),      # split by the budget
    ((0, 3), (5, 4), (10, 5), (20, 3), (30, 6)),  # split by max_num_seqs
], ids=["one batch", "token budget", "max_num_seqs"])
def test_score_matches_jax(llms, spans):
    jax_llm, llm, heldout = llms
    seqs = _seqs(heldout, spans)
    ref = jax_llm.score(seqs)
    out = llm.score(seqs)
    assert len(out) == len(ref) == len(seqs)
    for o, r, s in zip(out, ref, seqs):
        assert o.dtype == np.float64 and o.shape == (len(s) - 1,)
        np.testing.assert_allclose(o, r, atol=1e-4)
        assert np.all(o <= 0)


def test_sequence_over_budget_raises(llms):
    jax_llm, llm, heldout = llms
    seq = _seqs(heldout, [(0, 33)])       # max_num_batched_tokens = 32
    for scorer in (jax_llm, llm):
        with pytest.raises(ValueError, match="max_num_batched_tokens"):
            scorer.score(seq)


def test_engine_scores_and_frees_its_blocks(llms, monkeypatch):
    """``LLMEngine.score`` (the server's echo path) equals ``LLM.score``;
    8-row LM-head chunks give the 256-row chunks' logprobs; every
    borrowed block is free afterwards."""
    _, llm, heldout = llms
    seqs = _seqs(heldout, [(7, 30)])
    bm = llm.engine.scheduler.block_manager
    free = bm.num_free_blocks
    whole = llm.engine.score(seqs)[0]
    monkeypatch.setattr(ModelRunner, "SCORE_CHUNK", 8)
    chunked = llm.score(seqs)[0]
    np.testing.assert_allclose(chunked, whole, atol=1e-6)
    assert bm.num_free_blocks == free


def test_context_manager_closes_the_engine(monkeypatch):
    closed = []
    with LLM(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
             device="cpu") as llm:
        monkeypatch.setattr(llm.engine, "close", lambda: closed.append(1))
        assert llm.score([[1, 2, 3]])[0].shape == (2,)
    assert closed == [1]


def test_tokenizer_files_without_transformers_raise(tmp_path, monkeypatch):
    """Tokenizer files but no ``transformers`` (the card's machine): a
    clear error, never a silent ``None``.  Without the files: None."""
    cfg = tcfg.EngineConfig.from_dict(config_dict(model=str(tmp_path)))
    assert tllm.load_tokenizer(cfg) is None
    (tmp_path / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers package"):
        tllm.load_tokenizer(cfg)


@pytest.mark.parametrize("call", ["score", "encode"])
def test_failed_batch_returns_every_borrowed_block(call):
    """Two 24-token prompts in one batch against 5 free 8-token blocks:
    the first borrows 3, the second finds 2 and raises.  The port
    borrows inside its ``try`` / ``finally``, so the first prompt's
    blocks come back and the free count is what it was (the JAX engine
    borrows before its ``try`` and keeps them)."""
    from arcticinference_tpu_torch.engine.block_manager import (
        NoFreeBlocksError)

    d = config_dict(hf=TINY)
    d["cache"] = dict(block_size=8, num_blocks=6)
    d["scheduler"] = dict(max_num_seqs=4, max_num_batched_tokens=64)
    with LLM(tcfg.EngineConfig.from_dict(d), device="cpu") as llm:
        bm = llm.engine.scheduler.block_manager
        assert bm.num_free_blocks == 5
        prompts = [list(range(1, 25)), list(range(30, 54))]
        run = (llm.score if call == "score" else
               lambda p: llm.encode(prompt_token_ids=p, pooling="last"))
        with pytest.raises(NoFreeBlocksError):
            run(prompts)
        assert bm.num_free_blocks == 5
        assert len(run(prompts[:1])) == 1      # the engine still serves
        assert bm.num_free_blocks == 5
