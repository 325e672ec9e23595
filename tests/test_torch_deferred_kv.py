"""Deferred KV writes (kernel 3's path) in the port against the JAX package.

- The port's plain version of the grouped decode kernel with injected
  rows (``grouped_decode_attention_kernel(knew=, vnew=, slot_mapping=)`` on
  CPU tensors) against the JAX kernel with ``knew=`` in Pallas interpret
  mode (the oracle of tests/test_kernels.py:436-489), at head dim 128,
  qlen 1, 4 and 8, with a dead slot and slot -1 tails, in bf16 and with an
  fp8 cache and per-layer scales: atol = rtol = 0.05, that test's
  tolerance (the Pallas kernel rounds q and P to bf16).
- The plain version against the port's own scatter-then-attend in float32
  (the rows written into the cache, the causal grouped path): 1e-5.
- ``_quantize_kv_rows`` and ``_bulk_write_kv`` byte-identical to JAX's.
- A 2-layer float32 forward of a uniform decode step with and without
  ``ARCTIC_TPU_DEFERRED_KV=1``: logits within 1e-5, caches identical.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu.models import llama as jllama
from arcticinference_tpu.ops.pallas.ragged_attention import (
    grouped_decode_attention_kernel as jax_grouped)
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.config import ModelConfig
from arcticinference_tpu_torch.ops.cuda.ragged_attention import (
    grouped_decode_attention_kernel)

HQ, HKV, D, BS = 8, 2, 128, 16
FP8_SCALE = (2.0, 0.5)


def case(qlen, kv_fp8, seed=0, d=D, np_dtype=np.float32):
    """Four sequences (slot 1 dead, slot 2 with a tail of min(2, qlen-1)
    slot -1 rows) on a 2-layer cache with scattered pages; the new rows
    drawn as the cache's values are (so under layer 1's fp8 scales a new
    row weighs as much as a cached one)."""
    rng = np.random.default_rng(seed)
    ctx = [int(c) for c in rng.integers(5, 40, 4)]
    ctx[1] = 0
    seq = np.array([0 if i == 1 else c + qlen for i, c in enumerate(ctx)],
                   np.int32)
    pages = [-(-s // BS) for s in seq]
    n_blocks = sum(pages) + 2
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((4, max(pages)), np.int32)
    k = 0
    for r, n in enumerate(pages):
        bt[r, :n] = perm[k:k + n]
        k += n
    cache = rng.standard_normal((2, n_blocks, 2, BS, HKV * d)) * 0.5
    q = rng.standard_normal((4 * qlen, HQ, d)) * 2.0
    kn = rng.standard_normal((4 * qlen, HKV * d)) * 0.5
    vn = rng.standard_normal((4 * qlen, HKV * d)) * 0.5
    scale = np.ones((2, 2), np.float32)
    if kv_fp8:
        scale[1] = FP8_SCALE
    slot = np.full(4 * qlen, -1, np.int32)
    tails = {2: min(2, qlen - 1)}
    for s in (0, 2, 3):
        for j in range(qlen - tails.get(s, 0)):
            pos = ctx[s] + j
            slot[s * qlen + j] = bt[s, pos // BS] * BS + pos % BS
    return dict(q=q.astype(np_dtype), cache=cache, kn=kn, vn=vn, bt=bt,
                seq=seq, pos_base=np.array(ctx, np.int32), slot=slot,
                scale=scale)


def torch_kernel3(c, qlen, kv_dtype, q_dtype):
    return grouped_decode_attention_kernel(
        torch.from_numpy(c["q"]).to(q_dtype),
        torch.from_numpy(c["cache"]).to(kv_dtype),
        torch.from_numpy(c["pos_base"]), torch.from_numpy(c["bt"]),
        torch.from_numpy(c["seq"]), qlen=qlen,
        kv_scale=torch.from_numpy(c["scale"]), layer=1,
        knew=torch.from_numpy(c["kn"]).to(kv_dtype),
        vnew=torch.from_numpy(c["vn"]).to(kv_dtype),
        slot_mapping=torch.from_numpy(c["slot"]))


@pytest.mark.parametrize("kv_fp8", [False, True])
@pytest.mark.parametrize("qlen", [1, 4, 8])
def test_plain_kernel3_matches_jax_interpret(qlen, kv_fp8):
    c = case(qlen, kv_fp8)
    jdt = jnp.float8_e4m3fn if kv_fp8 else jnp.bfloat16
    tdt = torch.float8_e4m3fn if kv_fp8 else torch.bfloat16
    # gsz=1: one sequence per grid program, so interpret mode compiles
    # the kernel body once instead of unrolled over 8 sequences.
    with pltpu.force_tpu_interpret_mode():
        ref = jax_grouped(
            jnp.asarray(c["q"], jnp.bfloat16), jnp.asarray(c["cache"], jdt),
            jnp.asarray(c["pos_base"]), jnp.asarray(c["bt"]),
            jnp.asarray(c["seq"]), qlen=qlen, gsz=1,
            kv_scale=jnp.asarray(c["scale"]),
            layer=jnp.asarray(1, jnp.int32),
            knew=jnp.asarray(c["kn"], jdt), vnew=jnp.asarray(c["vn"], jdt),
            slot_mapping=jnp.asarray(c["slot"]))
    out = torch_kernel3(c, qlen, tdt, torch.bfloat16)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05,
                               rtol=0.05)
    assert not ref[qlen:2 * qlen].any()       # the dead slot
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("qlen", [1, 4, 8])
def test_plain_kernel3_matches_scatter_then_attend(qlen):
    """float32 cache: the rows written at their slots, then the causal
    grouped path; the sequences' real rows (j < new_len) agree within
    1e-5, and padding / dead rows of the injection path are finite."""
    c = case(qlen, False, seed=1)
    out = torch_kernel3(c, qlen, torch.float32, torch.float32)
    cache = torch.from_numpy(c["cache"]).float()
    slot = torch.from_numpy(c["slot"]).long()
    real = slot >= 0
    blk, off = slot[real] // BS, slot[real] % BS
    cache[1, blk, 0, off] = torch.from_numpy(c["kn"]).float()[real]
    cache[1, blk, 1, off] = torch.from_numpy(c["vn"]).float()[real]
    ref = grouped_decode_attention_kernel(
        torch.from_numpy(c["q"]), cache, torch.from_numpy(c["pos_base"]),
        torch.from_numpy(c["bt"]), torch.from_numpy(c["seq"]), qlen=qlen,
        layer=1)
    torch.testing.assert_close(out[real], ref[real], atol=1e-5, rtol=1e-5)
    assert torch.isfinite(out).all()
    assert not out[qlen:2 * qlen].any()


def _np(x):
    """A torch tensor's bytes as numpy (fp8 viewed as uint8)."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy()
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def _jnp_bytes(x):
    a = np.asarray(x)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return a.view(np.uint8)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("kv_fp8", [False, True])
def test_quantize_and_bulk_write_match_jax_bytes(kv_fp8):
    rng = np.random.default_rng(5)
    layers, nblk, kvd, t = 3, 9, 32, 12
    k = rng.standard_normal((t, 2, 16)).astype(np.float32) * 3
    v = rng.standard_normal((t, 2, 16)).astype(np.float32) * 3
    jdt = jnp.float8_e4m3fn if kv_fp8 else jnp.bfloat16
    tdt = torch.float8_e4m3fn if kv_fp8 else torch.bfloat16
    ks = np.array([1.7, 0.3], np.float32)
    jk, jv = jllama._quantize_kv_rows(jnp.asarray(k), jnp.asarray(v), jdt,
                                      jnp.asarray(ks))
    tk, tv = tllama._quantize_kv_rows(torch.from_numpy(k),
                                      torch.from_numpy(v), tdt,
                                      torch.from_numpy(ks))
    np.testing.assert_array_equal(_np(tk), _jnp_bytes(jk))
    np.testing.assert_array_equal(_np(tv), _jnp_bytes(jv))

    cache = rng.standard_normal((layers, nblk, 2, BS, kvd)).astype(
        np.float32)
    rows_k = rng.standard_normal((layers, t, kvd)).astype(np.float32)
    rows_v = rng.standard_normal((layers, t, kvd)).astype(np.float32)
    slots = rng.permutation(np.arange(BS, nblk * BS))[:t].astype(np.int32)
    slots[[3, 7, 11]] = -1                   # padding rows: the sink
    jout = jllama._bulk_write_kv(
        jnp.asarray(cache, jdt), jnp.asarray(rows_k, jdt),
        jnp.asarray(rows_v, jdt), jnp.asarray(slots))
    tcache = torch.from_numpy(cache).to(tdt)
    tout = tllama._bulk_write_kv(
        tcache, torch.from_numpy(rows_k).to(tdt),
        torch.from_numpy(rows_v).to(tdt), torch.from_numpy(slots))
    assert tout.data_ptr() == tcache.data_ptr()      # in place
    # Block 0 is the sink of the slot -1 rows (which of them lands last
    # is unspecified in both packages).
    np.testing.assert_array_equal(_np(tout)[:, 1:], _jnp_bytes(jout)[:, 1:])
    assert (_np(tout)[:, 1:] != _np(torch.from_numpy(cache).to(tdt))[:, 1:]
            ).any()


def test_forward_with_and_without_deferral(monkeypatch):
    """A 2-layer float32 model with head dim 64: a prefill through the
    ragged path, then one uniform decode step of qlen 4 (slot 1 dead,
    slot 2 with a slot -1 tail) through the grouped path, deferred and
    not, on copies of the cache."""
    hf = dict(vocab_size=97, hidden_size=128, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, head_dim=64)
    module, arch, params = load_model(ModelConfig(
        model="llama", dtype="float32", hf_overrides=hf), "cpu")
    params = module.fuse_params(params)
    bs, qlen, b = 32, 4, 3
    ctx = [20, 0, 45]
    bt = torch.tensor([[1, 2], [0, 0], [3, 4]], dtype=torch.int32)
    kv = torch.zeros((2, 6, 2, bs, 64), dtype=torch.bfloat16)
    rng = np.random.default_rng(3)

    def slot_of(s, pos):
        return int(bt[s, pos // bs]) * bs + pos % bs

    # Prefill both live sequences (ragged path, per-layer writes).
    ids, pos, req, slot = [], [], [], []
    for s in (0, 2):
        ids += [int(x) for x in rng.integers(1, 97, ctx[s])]
        pos += list(range(ctx[s]))
        req += [s] * ctx[s]
        slot += [slot_of(s, p) for p in range(ctx[s])]
    t32 = lambda x: torch.tensor(x, dtype=torch.int32)   # noqa: E731
    pre = dict(input_ids=t32(ids), positions=t32(pos), req_idx=t32(req),
               slot_mapping=t32(slot), block_tables=bt,
               seq_lens=t32([ctx[0], 0, ctx[2]]))
    monkeypatch.setenv("ARCTIC_TPU_DEFERRED_KV", "1")
    kv, _ = module.forward(params, arch, kv, pre,
                           attn_impl=module.plain_attn)

    ids, pos, req, slot = [], [], [], []
    for s in range(b):
        for j in range(qlen):
            p = ctx[s] + j
            real = s != 1 and not (s == 2 and j >= 2)
            ids.append(int(rng.integers(1, 97)))
            pos.append(p)
            req.append(s if real else -1)
            slot.append(slot_of(s, p) if real else -1)
    dec = dict(input_ids=t32(ids), positions=t32(pos), req_idx=t32(req),
               slot_mapping=t32(slot), block_tables=bt,
               seq_lens=t32([c + qlen for c in ctx]))
    seen = {"deferred": 0}
    kernel = tllama.grouped_decode_attention_kernel

    def spy(*a, **k):
        seen["deferred"] += k.get("knew") is not None
        return kernel(*a, **k)

    monkeypatch.setattr(tllama, "grouped_decode_attention_kernel", spy)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("ARCTIC_TPU_DEFERRED_KV", flag)
        attn = module.make_attn_impl(1, decode_qlen=qlen)
        kv2, h = module.forward(params, arch, kv.clone(), dict(dec),
                                attn_impl=attn)
        out[flag] = (kv2, module.compute_logits(params, h))
    assert seen["deferred"] == arch.num_layers
    real = torch.tensor(req) >= 0
    torch.testing.assert_close(out["1"][1][real], out["0"][1][real],
                               atol=1e-5, rtol=1e-5)
    # Identical caches (block 0 is the padding rows' sink).
    assert torch.equal(out["1"][0][:, 1:], out["0"][0][:, 1:])
    assert not torch.equal(out["1"][0][:, 1:], kv[:, 1:])
