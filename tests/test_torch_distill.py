"""Drafter distillation in the port against the JAX package's.

On the trained tiny checkpoint of tests/test_torch_engine.py (float32):

- ``capture_pairs`` gives the JAX engine's pairs: the same tokens
  (``tok0``, targets, mask exactly) and hidden states within 1e-4, on
  the synchronous step (no speculation) and on the spec-shaped capture
  (the fused loop with a seed drafter of the distilled architecture,
  written by the JAX package and read by both);
- the teacher-forced chain's logits, the loss and its gradients agree
  with JAX's on the same parameters (1e-5 on logits and loss, 1e-4 on
  gradients: float32 in both, summed in another order);
- the port's ``distill_mlp`` learns the target's next-token map (head 1
  above 0.9, head 2 above 0.5, as ``tests/test_distill.py`` asserts for
  JAX), and its drafter reproduces greedy tokens with acceptance above
  0.5 on the fused loop and the synchronous step; from the spec-shaped
  capture it replays its prompts at acceptance above 0.8;
- checkpoints: the port reads a JAX-written ``distilled_tied`` checkpoint
  exactly, ``safetensors`` and the JAX package read the port's writes
  exactly, the LSTM drafter round-trips exactly, and the port never
  imports ``safetensors``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.models import speculators as jspec
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu.spec import distill as jdistill
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models import speculators as tspec
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.spec import distill as tdistill
from arcticinference_tpu_torch.spec.proposer import ArcticProposer

from tests.test_torch_engine import config_dict, trained  # noqa: F401

SPANS = ((0, 12), (40, 20), (120, 16), (200, 24))
GEN = 24
K = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side (hundreds of small ops per
    step, beside other test processes)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def engine_dict(path, drafter=None, fused=True) -> dict:
    d = config_dict(model=path)
    d["scheduler"]["async_scheduling"] = False
    if drafter is not None:
        d["speculative"] = dict(method="arctic", model=str(drafter),
                                num_speculative_tokens=K,
                                enable_fused_decode=fused)
        d["cache"]["enable_prefix_caching"] = False
    return d


def prompts_of(heldout):
    return [[int(t) for t in heldout[s:s + n]] for s, n in SPANS]


@pytest.fixture(scope="module")
def seed_drafter(trained, tmp_path_factory):  # noqa: F811
    """A random tied drafter written by the JAX package (both engines
    load the same bytes)."""
    out = tmp_path_factory.mktemp("seed_drafter")
    sp, sa = jdistill.init_tied_drafter((128, 256), n_predict=K, seed=3)
    jdistill.save_distilled(out, sp, sa, metrics={"seed_drafter": True})
    return out


def capture_both(trained, drafter):  # noqa: F811
    """The JAX engine's and the port's pairs on the same prompts and
    config, and the port's ``width_stats``."""
    path, heldout = trained
    prompts = prompts_of(heldout)
    d = engine_dict(path, drafter)
    jpairs = jdistill.capture_pairs(JaxLLM(jcfg.EngineConfig.from_dict(d)),
                                    prompts, gen_len=GEN, n_predict=K)
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    tpairs = tdistill.capture_pairs(tllm, prompts, gen_len=GEN, n_predict=K)
    stats = tllm.engine.width_stats
    tllm.engine.close()
    return jpairs, tpairs, stats


@pytest.fixture(scope="module")
def sync_capture(trained):  # noqa: F811
    return capture_both(trained, None)


@pytest.fixture(scope="module")
def fused_capture(trained, seed_drafter):  # noqa: F811
    return capture_both(trained, seed_drafter)


@pytest.mark.parametrize("mode", ["sync", "fused"])
def test_capture_pairs_match_jax(mode, request):
    (jh, jt0, jtg, jm), (th, tt0, ttg, tm), width = \
        request.getfixturevalue(f"{mode}_capture")
    assert th.dtype == np.float32 and th.shape == jh.shape
    assert th.shape[0] >= len(SPANS) * (GEN - 2)
    np.testing.assert_array_equal(tt0, jt0)
    np.testing.assert_array_equal(ttg, jtg)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(th, np.asarray(jh, np.float32), rtol=1e-4,
                               atol=1e-4)
    if mode == "fused":
        assert width["wide"] > 0      # the fused loop's rows were captured
    else:
        assert width is None


# ---------------------------------------------------------------------------
# The teacher-forced chain and its loss
# ---------------------------------------------------------------------------

def test_chain_logits_loss_and_grads_match_jax(trained):  # noqa: F811
    path, _ = trained
    d = engine_dict(path)
    jcfg_model = jcfg.EngineConfig.from_dict(d).model
    _, _, jparams = jax_load_model(jcfg_model)
    _, _, tparams = load_model(tcfg.EngineConfig.from_dict(d).model, "cpu")
    rng = np.random.default_rng(0)
    n, dim, vocab = 48, 128, 256
    train_np = {
        "proj": [rng.standard_normal((dim, dim)).astype(np.float32)
                 / np.sqrt(dim) for _ in range(K)],
        "ln_w": [1 + 0.1 * rng.standard_normal(dim).astype(np.float32)
                 for _ in range(K)],
        "ln_b": [0.1 * rng.standard_normal(dim).astype(np.float32)
                 for _ in range(K)],
    }
    h = rng.standard_normal((n, dim)).astype(np.float32)
    t0 = rng.integers(0, vocab, n).astype(np.int32)
    tgt = rng.integers(0, vocab, (n, K)).astype(np.int32)
    m = (rng.random((n, K)) > 0.2).astype(np.float32)
    arch = jspec.MLPSpecArch(vocab_size=vocab, emb_dim=dim, inner_dim=dim,
                             n_predict=K, tie_weights=False,
                             scale_input=True)
    tarch = tspec.MLPSpecArch(vocab_size=vocab, emb_dim=dim, inner_dim=dim,
                              n_predict=K, tie_weights=False,
                              scale_input=True)

    def jloss(train):
        # spec/distill.py distill_mlp's loss_fn.
        params = {"emb": [jparams["embed"]] * K,
                  "head": [jparams["lm_head"]] * K, **train}
        logits = jdistill._chain_logits(params, arch, jnp.asarray(h),
                                        jnp.asarray(t0), jnp.asarray(tgt))
        total = 0.0
        for i, lg in enumerate(logits):
            lse = jax.scipy.special.logsumexp(lg, axis=-1)
            ce = lse - jnp.take_along_axis(
                lg, jnp.asarray(tgt)[:, i][:, None], axis=1)[:, 0]
            total = total + jnp.sum(ce * m[:, i]) / jnp.maximum(
                jnp.sum(m[:, i]), 1.0)
        return total, logits

    jtrain = jax.tree.map(jnp.asarray, train_np)
    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jtrain)

    ttrain = {k: [torch.tensor(a, requires_grad=True) for a in v]
              for k, v in train_np.items()}
    params = {"emb": [tparams["embed"]] * K,
              "head": [tparams["lm_head"]] * K, **ttrain}
    tlogits = tdistill._chain_logits(params, tarch, torch.from_numpy(h),
                                     torch.from_numpy(t0),
                                     torch.from_numpy(tgt))
    tl = tdistill._chain_loss(tlogits, torch.from_numpy(tgt),
                              torch.from_numpy(m))
    tl.backward()
    for a, b in zip(tlogits, jlogits):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for key in train_np:
        for a, b in zip(ttrain[key], jgrads[key]):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# Training and replay in the port's engine
# ---------------------------------------------------------------------------

def distilled_from(path, pairs, out):
    """Train on ``pairs`` against the checkpoint's tables (the JAX test's
    600 steps at lr 3e-3) and save to ``out``."""
    _, _, params = load_model(
        tcfg.EngineConfig.from_dict(engine_dict(path)).model, "cpu")
    p, arch, acc = tdistill.distill_mlp(params, *pairs, n_predict=K,
                                        steps=600, lr=3e-3, log_every=0)
    tdistill.save_distilled(out, p, arch,
                            metrics={"train_acc": [float(a) for a in acc]})
    return acc


def generate(path, prompts, drafter=None, fused=True):
    llm = LLM(tcfg.EngineConfig.from_dict(engine_dict(path, drafter, fused)),
              device="cpu")
    outs = llm.generate(prompt_token_ids=prompts,
                        sampling_params=SamplingParams(max_tokens=GEN,
                                                       ignore_eos=True))
    stats = llm.engine.spec_stats
    llm.engine.close()
    return [o.token_ids for o in outs], stats


@pytest.fixture(scope="module")
def distilled(trained, sync_capture, tmp_path_factory):  # noqa: F811
    """A drafter distilled by the port from its synchronous capture."""
    path, heldout = trained
    out = tmp_path_factory.mktemp("distilled")
    acc = distilled_from(path, sync_capture[1], out)
    return path, prompts_of(heldout), out, acc


def test_distill_learns_the_next_token_map(distilled):
    *_, acc = distilled
    assert acc[0] > 0.9, acc
    assert acc[1] > 0.5, acc


@pytest.mark.parametrize("fused", [True, False])
def test_distilled_drafter_reproduces_greedy(distilled, fused):
    path, prompts, out, _ = distilled
    want, _ = generate(path, prompts)
    got, stats = generate(path, prompts, out, fused=fused)
    assert got == want
    assert stats.num_drafts > 0
    assert stats.acceptance_rate > 0.5, stats.acceptance_rate


def test_spec_shaped_capture_transfers(trained, fused_capture,  # noqa: F811
                                       tmp_path):
    """The bench's recipe: capture on the fused loop with the seed
    drafter, train, replay the same prompts with the trained drafter in
    the same configuration."""
    path, heldout = trained
    distilled_from(path, fused_capture[1], tmp_path)
    got, stats = generate(path, prompts_of(heldout), tmp_path)
    assert all(len(g) == GEN for g in got)
    assert stats.num_drafts > 0
    assert stats.acceptance_rate > 0.8, stats.acceptance_rate
    assert stats.mean_accepted_per_draft > 1.5


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_port_reads_a_jax_distilled_checkpoint_exactly(trained,  # noqa: F811
                                                      seed_drafter):
    path, _ = trained
    _, _, params = load_model(
        tcfg.EngineConfig.from_dict(engine_dict(path)).model, "cpu")
    cfg = json.loads((seed_drafter / "config.json").read_text())
    got, arch = tdistill.load_distilled(seed_drafter, cfg, params)
    want, jarch = jdistill.init_tied_drafter((128, 256), n_predict=K,
                                             seed=3)
    assert arch.__dict__ == jarch.__dict__
    for key in ("proj", "ln_w", "ln_b"):
        for a, b in zip(got[key], want[key]):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(e is params["embed"] for e in got["emb"])
    assert all(h is params["lm_head"] for h in got["head"])
    # The engine's proposer takes the tables live from the target.
    spec = tcfg.SpeculativeConfig(method="arctic", model=str(seed_drafter),
                                  num_speculative_tokens=2)
    prop = ArcticProposer(spec, type("A", (), dict(hidden_size=128,
                                                   vocab_size=256))(),
                          torch.device("cpu"), target_params=params)
    assert (prop.kind, prop.n_predict) == ("mlp", 2)
    assert prop.params["head"][0] is params["lm_head"]


def test_jax_distilled_params_carry_across(trained):  # noqa: F811
    """A JAX distilled drafter's parameters (after JAX training steps) in
    the port through ``weights.distilled_params_from_jax``: the trained
    leaves exactly, the tables the port target's own, and the chain's
    logits within 1e-5 of JAX's."""
    from arcticinference_tpu_torch.weights import distilled_params_from_jax

    path, _ = trained
    d = engine_dict(path)
    _, _, jparams = jax_load_model(jcfg.EngineConfig.from_dict(d).model)
    _, _, tparams = load_model(tcfg.EngineConfig.from_dict(d).model, "cpu")
    rng = np.random.default_rng(2)
    n = 64
    h = rng.standard_normal((n, 128)).astype(np.float32)
    t0 = rng.integers(0, 256, n).astype(np.int32)
    tgt = rng.integers(0, 256, (n, K)).astype(np.int32)
    m = np.ones((n, K), np.float32)
    jp, jarch, _ = jdistill.distill_mlp(jparams, h, t0, tgt, m,
                                        n_predict=K, steps=2,
                                        batch_size=32, log_every=0)
    np_tree = jax.tree.map(np.asarray, {k: jp[k] for k in
                                        ("proj", "ln_w", "ln_b")})
    tp = distilled_params_from_jax(np_tree, tparams, "cpu")
    for key in ("proj", "ln_w", "ln_b"):
        for a, b in zip(tp[key], np_tree[key]):
            np.testing.assert_array_equal(a.numpy(), b)
    assert all(e is tparams["embed"] for e in tp["emb"])
    assert all(x is tparams["lm_head"] for x in tp["head"])
    tarch = tspec.MLPSpecArch(**jarch.__dict__)
    want = jdistill._chain_logits(jp, jarch, jnp.asarray(h),
                                  jnp.asarray(t0), jnp.asarray(tgt))
    got = tdistill._chain_logits(tp, tarch, torch.from_numpy(h),
                                 torch.from_numpy(t0), torch.from_numpy(tgt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_port_writes_read_exactly_elsewhere(trained, tmp_path):  # noqa: F811
    from safetensors.numpy import load_file

    path, _ = trained
    _, _, jparams = jax_load_model(
        jcfg.EngineConfig.from_dict(engine_dict(path)).model)
    p, arch = tdistill.init_tied_drafter((128, 256), n_predict=K, seed=5)
    tdistill.save_distilled(tmp_path, p, arch, metrics={"x": [1.0]})
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["distilled_tied"] and cfg["distill_metrics"] == {"x": [1.0]}
    raw = load_file(str(tmp_path / "model.safetensors"))
    jp, jarch = jdistill.load_distilled(tmp_path, cfg, jparams)
    assert jarch.__dict__ == arch.__dict__
    for i in range(K):
        for key, name in (("proj", "proj"), ("ln_w", "ln"),
                          ("ln_b", "ln")):
            suffix = "bias" if key == "ln_b" else "weight"
            want = p[key][i].numpy()
            np.testing.assert_array_equal(raw[f"{name}.{i}.{suffix}"], want)
            np.testing.assert_array_equal(np.asarray(jp[key][i]), want)


def test_st_io_round_trips_with_safetensors(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import load_file

    rng = np.random.default_rng(1)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "i8": rng.integers(-128, 127, (4, 7)).astype(np.int8),
              "i64": rng.integers(0, 9, (2,)).astype(np.int64),
              "f16": rng.standard_normal(6).astype(np.float16),
              "empty": np.zeros((0, 3), np.float32),
              "scalar": np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"))
    got = st_io.load_file(tmp_path / "a.safetensors")
    for k, a in arrays.items():
        assert tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(got[k].numpy(), a)
    tensors = {"bf16": torch.randn(4, 6).to(torch.bfloat16),
               "e4m3": torch.randn(33).to(torch.float8_e4m3fn),
               "view": torch.randn(5, 3).T}
    st_io.save_file(tensors, tmp_path / "b.safetensors")
    back = load_file(str(tmp_path / "b.safetensors"))
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert torch.equal(back[k].view(torch.uint8).flatten(),
                           t.contiguous().view(torch.uint8).flatten())


def test_lstm_round_trip_exact(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((256, 32)).astype(np.float32)
    tok0 = rng.integers(0, 64, 256).astype(np.int32)
    targets = rng.integers(0, 64, (256, 3)).astype(np.int32)
    mask = np.ones((256, 3), np.float32)
    params, arch, acc = tdistill.distill_lstm(32, 64, hidden, tok0, targets,
                                              mask, steps=3, log_every=0,
                                              device="cpu")
    assert acc.shape == (3,)
    tdistill.save_lstm(tmp_path / "d", params, arch)
    cfg = json.loads((tmp_path / "d" / "config.json").read_text())
    arch2 = tspec.LSTMSpecArch.from_hf_config(cfg)
    assert arch2 == arch
    f = tmp_path / "d" / "model.safetensors"
    p2 = tspec.load_lstm_state(arch2, st_io.load_file(f),
                               dtype=torch.float32)
    for k in params:
        assert torch.equal(params[k], p2[k]), k
    # The JAX package reads the same parameters from the port's file.
    j2 = jspec.load_lstm_state(jspec.LSTMSpecArch.from_hf_config(cfg),
                               load_file(str(f)), dtype=jnp.float32)
    for k in params:
        np.testing.assert_array_equal(np.asarray(j2[k]), params[k].numpy())


def test_port_never_imports_safetensors():
    code = (
        "import importlib, pkgutil, sys\n"
        "import arcticinference_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'safetensors' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stderr
