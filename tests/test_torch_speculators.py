"""The port's Arctic MLP / LSTM speculators against the JAX package's.

Parameters are the JAX package's (``mlp_init_params`` /
``lstm_init_params`` in float32), carried across by
``weights.params_from_jax``; last tokens and hidden rows are drawn with
numpy.  Both sides run on the CPU.

- Per-head logits of the greedy chain within atol 1e-4 (float32), on
  the rows whose chains agree on the earlier heads: the JAX chain's
  logits are read by wrapping its ``_mm`` (every second call is an LM
  head).
- Draft tokens: equal wherever the JAX head's top-2 logit margin exceeds
  1e-3, walking each row's chain up to its first smaller margin (a later
  head depends on the earlier tokens); the test asserts that most of the
  chain is compared.
- ``quantize_spec_params`` in fp8 and int8: bytes and scales equal to
  JAX's; the quantized chains' drafts on the same margin rule.
- The ``load_*_state`` name remaps from a numpy dict; int4 refused.
- ``ArcticProposer``: the safetensors checkpoint gives JAX's parameters,
  and without a checkpoint ``safetensors`` is never imported.
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

from arcticinference_tpu.models import speculators as JS
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.models import speculators as TS
from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear
from arcticinference_tpu_torch.weights import params_from_jax

MARGIN = 1e-3
B = 16


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def arch_pair(kind: str):
    if kind == "lstm":
        kw = dict(vocab_size=96, input_hidden_dim=64, emb_dim=(64,),
                  inner_dim=(64,), proj_dim=(64,), n_predict=3)
        return JS.LSTMSpecArch(**kw), TS.LSTMSpecArch(**kw)
    kw = dict(vocab_size=96, emb_dim=64, inner_dim=64, n_predict=3,
              tie_weights=kind == "mlp_tied")
    return JS.MLPSpecArch(**kw), TS.MLPSpecArch(**kw)


def jax_params(kind, jarch, seed=0):
    init = JS.lstm_init_params if kind == "lstm" else JS.mlp_init_params
    return init(jarch, jax.random.PRNGKey(seed), jnp.float32)


def inputs(hidden_dim, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, B).astype(np.int32),
            rng.standard_normal((B, hidden_dim)).astype(np.float32))


def jax_chain(monkeypatch, kind, jparams, jarch, tok, hid):
    """(drafts [B, n], per-head logits) of the JAX chain."""
    seen = []
    mm = JS._mm

    def spy(x, w):
        out = mm(x, w)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(JS, "_mm", spy)
    gen = (JS.lstm_generate_proposals if kind == "lstm"
           else JS.mlp_generate_proposals)
    drafts = np.asarray(gen(jparams, jarch, jnp.asarray(tok),
                            jnp.asarray(hid), jarch.n_predict))
    monkeypatch.setattr(JS, "_mm", mm)
    return drafts, seen[1::2]


def port_chain(kind, tparams, tarch, tok, hid):
    chain = TS.lstm_chain if kind == "lstm" else TS.mlp_chain
    drafts, logits = chain(tparams, tarch, torch.from_numpy(tok),
                           torch.from_numpy(hid), tarch.n_predict)
    gen = (TS.lstm_generate_proposals if kind == "lstm"
           else TS.mlp_generate_proposals)
    assert torch.equal(gen(tparams, tarch, torch.from_numpy(tok),
                           torch.from_numpy(hid), tarch.n_predict), drafts)
    return drafts.numpy(), [lg.numpy() for lg in logits]


def assert_logits_match(jd, td, jlogits, tlogits, atol, rtol):
    """Head i's logits on the rows whose chains agree on heads 0..i-1
    (those rows feed both heads the same token)."""
    for i in range(jd.shape[1]):
        rows = (jd[:, :i] == td[:, :i]).all(axis=1)
        assert rows.sum() >= 0.75 * len(rows)
        np.testing.assert_allclose(tlogits[i][rows], jlogits[i][rows],
                                   atol=atol, rtol=rtol)


def assert_drafts_match(jd, td, jlogits):
    """Equal drafts along each row's chain while the JAX head's top-2
    margin exceeds MARGIN; most of the chain must be compared."""
    compared = 0
    for b in range(jd.shape[0]):
        for i in range(jd.shape[1]):
            top2 = np.sort(jlogits[i][b])[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert td[b, i] == jd[b, i], (b, i)
            compared += 1
    assert compared >= 0.75 * jd.size, (compared, jd.size)


@pytest.mark.parametrize("kind", ["mlp_tied", "mlp_untied", "lstm"])
def test_chain_logits_and_drafts_match_jax(monkeypatch, kind):
    jarch, tarch = arch_pair(kind)
    jp = jax_params(kind, jarch)
    tp = params_from_jax(to_np(jp), "cpu")
    dim = 64
    tok, hid = inputs(dim, 96)
    jd, jlog = jax_chain(monkeypatch, kind, jp, jarch, tok, hid)
    td, tlog = port_chain(kind, tp, tarch, tok, hid)
    assert td.dtype == np.int32 and td.shape == jd.shape == (B, 3)
    assert_logits_match(jd, td, jlog, tlog, atol=1e-4, rtol=0)
    assert_drafts_match(jd, td, jlog)


def test_arch_configs_match_jax():
    for cfg in ({"vocab_size": 100, "input_hidden_dim": 64, "emb_dim": "32",
                 "inner_dim": "32.64", "proj_dim": "48", "n_predict": 3,
                 "method": "sum_lstm"},
                {"vocab_size": 50, "input_hidden_dim": 32, "proj_dim": 16}):
        j, t = JS.LSTMSpecArch.from_hf_config(cfg), \
            TS.LSTMSpecArch.from_hf_config(cfg)
        assert j.__dict__ == t.__dict__
        assert (j.state_weight, j.emb_weight) == (t.state_weight,
                                                  t.emb_weight)
    for cfg in ({"emb_dim": "4096", "inner_dim": "1.2048", "n_predict": 4},
                {"vocab_size": 64, "tie_weights": False}):
        j, t = JS.MLPSpecArch.from_hf_config(cfg), \
            TS.MLPSpecArch.from_hf_config(cfg)
        assert j.__dict__ == t.__dict__
        assert (j.state_weight, j.emb_weight) == (t.state_weight,
                                                  t.emb_weight)


def test_init_shapes_match_jax():
    """The port's random init has JAX's keys, list lengths, shapes and
    dtype (its numbers come from a torch generator)."""
    gen = torch.Generator().manual_seed(0)
    for kind in ("mlp_tied", "mlp_untied", "lstm"):
        jarch, tarch = arch_pair(kind)
        jp = to_np(jax_params(kind, jarch))
        init = (TS.lstm_init_params if kind == "lstm"
                else TS.mlp_init_params)
        tp = init(tarch, gen)
        assert tp.keys() == jp.keys()
        for k, v in jp.items():
            tv = tp[k]
            if isinstance(v, list):
                assert isinstance(tv, list) and len(tv) == len(v), k
            for a, b in (zip(v, tv) if isinstance(v, list) else [(v, tv)]):
                assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Quantized drafters
# ---------------------------------------------------------------------------

def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8).tobytes()


@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("kind", ["mlp_tied", "lstm"])
def test_quantize_spec_params_byte_exact(kind, mode):
    jarch, _ = arch_pair(kind)
    jp = jax_params(kind, jarch)
    jq = to_np(JS.quantize_spec_params(jp, mode))
    tq = TS.quantize_spec_params(params_from_jax(to_np(jp), "cpu"), mode)
    n = 0
    for k, v in jq.items():
        pairs = zip(v, tq[k]) if isinstance(v, list) else [(v, tq[k])]
        for a, b in pairs:
            if isinstance(b, QuantizedLinear):
                assert _raw(b.weight) == _raw(a.weight), k
                assert _raw(b.scale) == _raw(a.scale), k
                assert tuple(b.scale.shape) == a.scale.shape, k
                n += 1
            else:
                assert _raw(b) == _raw(a), k
    assert n == 4


@pytest.mark.parametrize("mode", ["fp8", "int8"])
@pytest.mark.parametrize("kind", ["mlp_tied", "lstm"])
def test_quantized_chain_drafts_match_jax(monkeypatch, kind, mode):
    """Both sides run the quantized products of their ``matmul`` (the port
    through ``fp8_matmul_kernel``'s plain version) and dequantize only the
    gathered embedding rows."""
    jarch, tarch = arch_pair(kind)
    jq = JS.quantize_spec_params(jax_params(kind, jarch), mode)
    tq = params_from_jax(to_np(jq), "cpu")
    tok, hid = inputs(64, 96, seed=2)
    jd, jlog = jax_chain(monkeypatch, kind, jq, jarch, tok, hid)
    td, tlog = port_chain(kind, tq, tarch, tok, hid)
    assert_logits_match(jd, td, jlog, tlog, atol=1e-4, rtol=1e-5)
    assert_drafts_match(jd, td, jlog)


def test_int4_rejected():
    _, tarch = arch_pair("mlp_tied")
    tp = TS.mlp_init_params(tarch, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        TS.quantize_spec_params(tp, "int4")
    with pytest.raises(ValueError):
        tcfg.SpeculativeConfig(method="arctic", quantization="int4")


# ---------------------------------------------------------------------------
# Checkpoint loading
# ---------------------------------------------------------------------------

def mlp_tensors(rng, n_uniq=1, n_proj=2, v=96, d=64):
    t = {}
    for i in range(n_uniq):
        t[f"speculator.emb.{i}.weight"] = rng.standard_normal((v, d))
        t[f"speculator.head.{i}.weight"] = rng.standard_normal((v, d))
        t[f"speculator.ln.{i}.weight"] = rng.standard_normal(d)
        t[f"speculator.ln.{i}.bias"] = rng.standard_normal(d)
    for i in range(n_proj):
        t[f"speculator.proj.{i}.weight"] = rng.standard_normal((d, d))
    return {k: a.astype(np.float32) for k, a in t.items()}


def lstm_tensors(rng, v=96, d=64):
    t = {"forget_emb.0.weight": rng.standard_normal((v, d)),
         "projs.0.weight": rng.standard_normal((4 * d, d)),
         "projs.1.weight": rng.standard_normal((4 * d, d)),
         "head.0.weight": rng.standard_normal((v, d))}
    for n in ("cell_ln", "state_ln"):
        t[f"{n}.0.weight"] = rng.standard_normal(d)
        t[f"{n}.0.bias"] = rng.standard_normal(d)
    return {k: a.astype(np.float32) for k, a in t.items()}


def assert_same_tree(jtree, ttree):
    assert jtree.keys() == ttree.keys()
    for k, v in jtree.items():
        pairs = zip(v, ttree[k]) if isinstance(v, list) else [(v, ttree[k])]
        for a, b in pairs:
            assert tuple(b.shape) == a.shape, k
            assert _raw(b) == _raw(a), k


@pytest.mark.parametrize("kind", ["mlp_tied", "mlp_untied", "lstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_state_remaps_match_jax(kind, dtype):
    rng = np.random.default_rng(4)
    jarch, tarch = arch_pair(kind)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "lstm":
        t = lstm_tensors(rng)
        j = JS.load_lstm_state(jarch, t, jdt)
        p = TS.load_lstm_state(tarch, t, tdt)
    else:
        n = 1 if kind == "mlp_tied" else 3
        t = mlp_tensors(rng, n_uniq=n, n_proj=2 if n == 1 else 3)
        j = JS.load_mlp_state(jarch, t, jdt)
        p = TS.load_mlp_state(tarch, t, tdt)
    assert_same_tree(to_np(j), p)
    # A missing tensor names itself.
    t.pop(next(iter(t)))
    load = TS.load_lstm_state if kind == "lstm" else TS.load_mlp_state
    with pytest.raises(KeyError):
        load(tarch, t, tdt)


class _Base:
    hidden_size = 64
    vocab_size = 96


def test_proposer_reads_a_checkpoint_like_jax(tmp_path):
    """An LSTM checkpoint directory (config.json + one safetensors
    shard): the port's proposer holds JAX's parameters, bf16 bytes."""
    from safetensors.numpy import save_file

    from arcticinference_tpu import config as jcfg
    from arcticinference_tpu.spec.proposer import ArcticProposer as JProp
    from arcticinference_tpu_torch.spec.proposer import ArcticProposer

    (tmp_path / "config.json").write_text(json.dumps(
        {"method": "sum_lstm", "n_predict": 3, "vocab_size": 96,
         "input_hidden_dim": 64}))
    save_file(lstm_tensors(np.random.default_rng(5)),
              str(tmp_path / "model.safetensors"))
    kw = dict(method="arctic", model=str(tmp_path), num_speculative_tokens=2)
    jp = JProp(jcfg.SpeculativeConfig(**kw), _Base())
    tp = ArcticProposer(tcfg.SpeculativeConfig(**kw), _Base(),
                        torch.device("cpu"))
    assert (tp.kind, tp.n_predict) == (jp.kind, jp.n_predict) == ("lstm", 2)
    assert tp.arch.__dict__ == jp.arch.__dict__
    assert_same_tree(to_np(jp.params), tp.params)


def test_proposer_without_checkpoint_never_imports_safetensors():
    code = (
        "import sys, torch\n"
        "from arcticinference_tpu_torch.config import SpeculativeConfig\n"
        "from arcticinference_tpu_torch.spec.proposer import ArcticProposer\n"
        "class A: hidden_size = 64; vocab_size = 96\n"
        "for q in (None, 'fp8'):\n"
        "    p = ArcticProposer(SpeculativeConfig(method='arctic',"
        " quantization=q), A(), torch.device('cpu'))\n"
        "    assert p.kind == 'mlp' and p.n_predict == 3\n"
        "assert 'safetensors' not in sys.modules\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in"
        " sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stderr


def test_distilled_tied_drafter_raises(tmp_path):
    """A distilled drafter's tables are the target's own: without the
    target's parameters it raises, as in the JAX package."""
    from arcticinference_tpu_torch.spec.proposer import ArcticProposer

    (tmp_path / "config.json").write_text(json.dumps(
        {"distilled_tied": True}))
    with pytest.raises(ValueError, match="target params"):
        ArcticProposer(tcfg.SpeculativeConfig(method="arctic",
                                              model=str(tmp_path)),
                       _Base(), torch.device("cpu"))
