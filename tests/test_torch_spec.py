"""The port's suffix tree and cache against the JAX package's.

- The native tree (``csrc/suffix_tree.cc``, built by ``spec/build.py``)
  and the pure-Python twin each against their JAX counterpart, on the
  same random token sequences and knobs: ``speculate`` (linear and
  ``use_tree_spec``) and ``SuffixCache.speculate_batch`` give equal
  tokens, parents, match lengths, scores and probabilities.
- A native build that fails raises with the compiler's output; the twin
  is used only on request.
- Engine refusals and the prompt-tree pool's release on ``abort_request``
  and ``close``.
"""

import dataclasses

import numpy as np
import pytest

from arcticinference_tpu.spec.suffix_cache import SuffixCache as JaxCache
from arcticinference_tpu.spec.suffix_tree import SuffixTree as JaxTree
from arcticinference_tpu.spec.suffix_tree import _load_native
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.spec import build as sbuild
from arcticinference_tpu_torch.spec import suffix_tree as stree
from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache

from tests.test_torch_engine import TINY, config_dict


@pytest.fixture(params=["native", "python"])
def impl(request):
    """force_python for both packages' trees."""
    if request.param == "native" and _load_native() is None:
        pytest.fail("the JAX package's native suffix tree did not build")
    return request.param == "python"


def corpus(rng, n_seqs, vocab=6):
    return [rng.integers(0, vocab, int(rng.integers(5, 120))).tolist()
            for _ in range(n_seqs)]


def knobs(rng):
    return dict(max_spec_tokens=int(rng.choice([4, 8, 30])),
                max_spec_factor=float(rng.choice([0.5, 1.0, 2.0, 10.0])),
                max_spec_offset=float(rng.choice([0.0, 1.0, 8.0])),
                min_token_prob=float(rng.choice([0.0, 0.05, 0.1])))


def as_dict(c):
    return dataclasses.asdict(c)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculate_matches_jax(impl, seed):
    rng = np.random.default_rng(seed)
    depth = int(rng.choice([4, 8, 16, 64]))
    port = stree.SuffixTree(depth, force_python=impl)
    ref = JaxTree(depth, force_python=impl)
    assert isinstance(port, stree.PySuffixTree if impl
                      else stree.NativeSuffixTree)
    for sid, seq in enumerate(corpus(rng, 5)):
        port.extend(sid, seq)
        ref.extend(sid, seq)
    assert port.num_seqs() == ref.num_seqs() == 5
    n_tree = 0
    for i in range(60):
        pat = rng.integers(0, 6, int(rng.integers(1, 20))).tolist()
        kw = dict(knobs(rng), use_tree_spec=bool(i % 2))
        a, b = port.speculate(pat, **kw), ref.speculate(pat, **kw)
        assert as_dict(a) == as_dict(b), (pat, kw)
        n_tree += any(p != j - 1 for j, p in enumerate(a.parents))
    assert n_tree > 0               # some trees branch


def _caches(rng, impl, depth=16, n_req=6):
    port = SuffixCache(depth, force_python=impl)
    ref = JaxCache(depth, force_python=impl)
    prompts = corpus(rng, n_req)
    for i, p in enumerate(prompts):
        if i % 3:                          # some requests have no prompt
            port.cache_prompt(f"r{i}", p)
            ref.cache_prompt(f"r{i}", p)
    for i, seq in enumerate(corpus(rng, n_req)):
        port.update_response(f"r{i}", seq)
        ref.update_response(f"r{i}", seq)
    return port, ref, prompts


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_speculate_batch_matches_jax(impl, tree, seed):
    rng = np.random.default_rng(10 + seed)
    port, ref, _ = _caches(rng, impl)
    assert port.is_native() == ref.is_native() == (not impl)
    kw = dict(knobs(rng), use_tree_spec=tree)
    items = []
    for i in range(6):
        pat = rng.integers(0, 6, int(rng.integers(1, 30))).tolist()
        items.append((f"k{i}", dict(
            kw, req_id=f"r{i}", pattern=pat,
            max_spec_tokens=int(rng.integers(1, 31)),
            use_cached_prompt=port.has_cached_prompt(f"r{i}"))))
    a, b = port.speculate_batch(items), ref.speculate_batch(items)
    assert a.keys() == b.keys()
    for k in a:
        assert as_dict(a[k]) == as_dict(b[k]), k
        # The batch walk is the serial walk.
        assert as_dict(a[k]) == as_dict(port.speculate(**dict(items)[k]))


def test_prompt_tree_lifecycle_matches_jax(impl):
    rng = np.random.default_rng(5)
    port, ref, prompts = _caches(rng, impl)
    assert port.cached_prompt_ids() == ref.cached_prompt_ids()
    tree = port.build_prompt_tree(prompts[0])
    port.install_prompt_tree("r0", tree)
    ref.cache_prompt("r0", prompts[0])
    pat = prompts[0][-5:]
    assert as_dict(port.speculate("r0", pat)) == \
        as_dict(ref.speculate("r0", pat))
    with pytest.raises(ValueError):
        port.install_prompt_tree("r0", tree)
    port.evict_prompt("r0")
    with pytest.raises(ValueError):
        port.speculate("r0", pat)
    with pytest.raises(ValueError):
        port.speculate("r1", [])


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output; nothing
    falls back to the Python twin."""
    (tmp_path / sbuild.SOURCE).write_text("this is not C++;\n")
    monkeypatch.setattr(sbuild, "CSRC", tmp_path)
    monkeypatch.setattr(sbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(stree, "_lib", None)
    monkeypatch.delenv(stree.PURE_PYTHON_ENV, raising=False)
    with pytest.raises(sbuild.NativeBuildError, match="error"):
        stree.SuffixTree(8)
    with pytest.raises(sbuild.NativeBuildError):
        SuffixCache(8)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_twin_only_on_request(monkeypatch):
    assert isinstance(stree.SuffixTree(8), stree.NativeSuffixTree)
    assert sbuild.library_path().exists()
    assert sbuild.library_path().parent.name == "_build"
    assert isinstance(stree.SuffixTree(8, force_python=True),
                      stree.PySuffixTree)
    monkeypatch.setenv(stree.PURE_PYTHON_ENV, "1")
    assert isinstance(stree.SuffixTree(8), stree.PySuffixTree)
    assert not SuffixCache(8).is_native()


# ---------------------------------------------------------------------------
# Engine: refusals and the prompt-tree pool
# ---------------------------------------------------------------------------

def spec_config(**spec):
    d = config_dict(hf=TINY)
    d["speculative"] = spec
    return tcfg.EngineConfig.from_dict(d)


@pytest.mark.parametrize("method", ["arctic", "mlp_speculator",
                                    "lstm_speculator"])
def test_draft_model_methods_raise(method, tmp_path):
    """Each draft-model method builds an Arctic drafter (MLP without a
    config.json that says LSTM, as in the JAX package) and no suffix
    cache; a distilled drafter (``distilled_tied``, spec/distill.py)
    takes its embedding and LM head from the target, and raises without
    its weights file."""
    from arcticinference_tpu_torch.spec.distill import (init_tied_drafter,
                                                        save_distilled)

    llm = LLM(spec_config(method=method), device="cpu")
    assert llm.engine._drafter.kind == "mlp"
    assert llm.engine._suffix_cache is None
    (tmp_path / "config.json").write_text('{"distilled_tied": true}')
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        LLM(spec_config(method=method, model=str(tmp_path)), device="cpu")
    params = llm.engine.runner.params
    save_distilled(tmp_path, *init_tied_drafter(params, n_predict=2))
    tied = LLM(spec_config(method=method, model=str(tmp_path)),
               device="cpu").engine
    drafter = tied._drafter
    assert drafter.kind == "mlp" and drafter.arch.n_predict == 2
    assert drafter.params["head"][0] is tied.runner.params["lm_head"]
    assert drafter.params["emb"][0] is tied.runner.params["embed"]


def test_abort_and_close_release_prompt_trees():
    llm = LLM(spec_config(method="suffix"), device="cpu")
    eng = llm.engine
    for i in range(3):
        eng.add_request(f"r{i}", [1, 2, 3, 4, 5] * (i + 1))
    assert set(eng._prompt_tree_futs) == {"r0", "r1", "r2"}
    assert eng.abort_request("r1") is not None
    assert set(eng._prompt_tree_futs) == {"r0", "r2"}
    assert not eng._suffix_cache.has_cached_prompt("r1")
    pool = eng._prompt_tree_pool
    llm.close()
    assert eng._prompt_tree_futs == {} and eng._prompt_tree_pool is None
    assert pool._shutdown
    llm.close()                                   # idempotent


def test_prompt_trees_are_evicted_when_requests_finish():
    llm = LLM(spec_config(method="suffix", use_tree_spec=True),
              device="cpu")
    outs = llm.generate(prompt_token_ids=[[3, 4, 5, 6] * 6, [9, 8] * 5],
                        sampling_params=SamplingParams(max_tokens=6))
    assert all(len(o.token_ids) == 6 for o in outs)
    eng = llm.engine
    assert eng._suffix_cache.cached_prompt_ids() == []
    assert eng._prompt_tree_futs == {}
    llm.close()
