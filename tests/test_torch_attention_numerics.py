"""The rounding scheme of the attention kernels' tensor-core products,
pinned on the CPU: the ragged kernel (kernel 1) and the grouped decode
kernel (kernels 2 and 3; :func:`grouped_mma_model`, below).

The CUDA kernel (``csrc/ragged_attention.cu``, kernel 1) multiplies
16-bit operands with float32 sums.  :func:`mma_model` repeats its
rounding in plain torch: q scaled by ``scale * k_scale * log2(e)``;
pages of 32 slots folded into a base-2 online softmax; q and P each
split into a high part and the rounded remainder before their products.
bf16 pages keep K and V as they are and split in bf16; fp8 pages become
fp16 (exactly) and split in fp16.

The model is held against

- the port's plain version (float32 throughout; what the kernel is held
  against on the card) within the card check's relative-norm bound,
  ``||model - plain|| <= 1e-3 ||plain||`` over the valid rows, on the
  card check's inputs (q std 1 and 5, K and V std 0.5); and
- the JAX Pallas kernel in interpret mode (head dim 128, the TPU
  kernel's tiling) within atol = rtol = 2e-2, the bound
  tests/test_kernels.py uses.

Rounding q and P to bf16 once, as the TPU kernel does, misses the 1e-3
bound on the card check's inputs: a test shows it, so the split is
needed.

The grouped kernel's model adds its page streams (16-slot chunk c folded
into stream c % 4, the streams merged in order) and its m16 row tiles, and
shows a row's output bit for bit independent of its row index and of
qlen, as the card check does for the kernel.

Kernel 4's model (:func:`range_mma_model`) runs the grouped kernel's CTA
on each range of R pages (``range_plan``) and merges the ranges' float32
states in range order, skipping a range a row does not attend; it is held
to the same bounds against the plain version and against the JAX
``decode_paged_attention_kernel`` in interpret mode at qlen 1, 4 and 8,
bf16 and fp8, at 2-page ranges (every context here spans several) and at
the wrapper's range size, and its rows are shown independent of qlen bit
for bit.  Rounding only q or only P once (the cheaper splits) misses the
1e-3 bound with bf16 pages and outputs
(``test_one_sided_split_misses_the_card_bound``), so kernel 4 keeps the
hi + lo split of both.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from arcticinference_tpu.ops.pallas import ragged_attention as jra
from arcticinference_tpu_torch.ops.attention import (
    grouped_decode_deferred_reference, ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops.cuda import ragged_attention as tra

from tests.test_torch_attention import to_torch
from tests.test_torch_tree_attention import random_tree, tree_case, \
    tree_schedule

REL_TOL = 1e-3
TOL = 2e-2
PAGE = 32
LOG2E = 1.0 / math.log(2.0)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _split(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _round(x, dtype)
    return hi, _round(x - hi, dtype)


def mma_model(q, kv, positions, req_idx, block_tables, seq_lens, kv_scale,
              tree_start=None, row_tree_mask=None, scheme="kernel"):
    """The kernel's arithmetic on one cache layer ``kv`` [N, 2, 32,
    Hkv*D]; float32 out [T, Hq, D], padding rows zero.

    ``scheme="kernel"``: the rounding above.  ``scheme="single"``: q and
    P each rounded to bf16 once (the TPU kernel's rounding);
    ``"q_single"`` / ``"p_single"``: only q / only P rounded once, the
    other split."""
    t, hq, d = q.shape
    hkv = kv.shape[-1] // d
    group = hq // hkv
    fp8 = kv.dtype == torch.float8_e4m3fn
    dt = torch.float16 if fp8 and scheme == "kernel" else torch.bfloat16
    split_q = scheme in ("kernel", "p_single")
    split_p = scheme in ("kernel", "q_single")
    k_scale, v_scale = (float(x) for x in kv_scale)
    out = torch.zeros((t, hq, d))
    for r in torch.unique(req_idx[req_idx >= 0]).tolist():
        rows = torch.nonzero(req_idx == r).flatten()
        s_len = int(seq_lens[r])
        pages = block_tables[r, :-(-s_len // PAGE)].long()
        # K and V as the MMAs see them: bf16 as stored, fp8 as fp16 (exact).
        k = kv[pages, 0].reshape(-1, hkv, d)[:s_len].float()
        v = kv[pages, 1].reshape(-1, hkv, d)[:s_len].float()
        qs = q[rows].float() * (d ** -0.5 * k_scale * LOG2E)
        qg = qs.reshape(-1, hkv, group, d)
        if split_q:
            q_hi, q_lo = _split(qg, dt)
            s = (torch.einsum("thgd,shd->thgs", q_hi, k)
                 + torch.einsum("thgd,shd->thgs", q_lo, k))
        else:
            s = torch.einsum("thgd,shd->thgs", _round(qg, dt), k)
        kv_pos = torch.arange(s_len)
        pos = positions[rows].long()
        valid = kv_pos[None, :] <= pos[:, None]
        if tree_start is not None:
            m = row_tree_mask[rows].long()[:, None]
            rel = kv_pos[None, :] - int(tree_start[r])
            bit = (m >> rel.clamp(0, 31)) & 1
            override = (m != 0) & (rel >= 1)
            valid = torch.where(override, (rel < 32) & (bit > 0), valid)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        # The online softmax, one page at a time.
        m_run = torch.full(s.shape[:-1], float("-inf"))
        l_run = torch.zeros(s.shape[:-1])
        acc = torch.zeros(s.shape[:-1] + (d,))
        for lo in range(0, s_len, PAGE):
            sc = s[..., lo:lo + PAGE]
            m_new = torch.maximum(m_run, sc.amax(-1))
            m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
            alpha = torch.exp2(m_run - m_use)
            p = torch.exp2(sc - m_use[..., None])
            l_run = l_run * alpha + p.sum(-1)
            vc = v[lo:lo + PAGE]
            if split_p:
                p_hi, p_lo = _split(p, dt)
                pv = (torch.einsum("thgs,shd->thgd", p_hi, vc)
                      + torch.einsum("thgs,shd->thgd", p_lo, vc))
            else:
                pv = torch.einsum("thgs,shd->thgd", _round(p, dt), vc)
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        o = acc * (v_scale / l_run.clamp(min=1e-20))[..., None]
        out[rows] = o.reshape(-1, hq, d)
    return out


def numerics_case(q_std, kv_dtype, d, tree, seed=0):
    """A step with a prefill chunk, decode rows and (with ``tree``) two
    token trees, on a 2-layer cache (layer 1 read; fp8 with scales 2 and
    0.5); K and V std 0.5, q std ``q_std``.  Returns the numpy arrays,
    the torch cache and scales, and the 9-tuple schedule at qb 32 (7-tuple
    without trees)."""
    rng = np.random.default_rng(seed)
    trees = ([(200, 1, random_tree(rng, 30)), (90, 3, random_tree(rng, 9))]
             if tree else [(200, 1, None), (90, 3, None)])
    reqs = [(0, 45, None), (300, 1, None)] + trees
    case = tree_case(reqs, Hq=8, Hkv=2, D=d, seed=seed + 1, layers=2)
    q = (rng.standard_normal(case["q"].shape) * q_std).astype(np.float32)
    case["q"] = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    kv = case["kv"] * 0.5
    scale = np.ones((2, 2), np.float32)
    if kv_dtype == "fp8":
        kj = jnp.asarray(kv, jnp.float32).astype(jnp.float8_e4m3fn)
        scale[1] = [2.0, 0.5]
    else:
        kj = jnp.asarray(kv, jnp.bfloat16)
    sched = tree_schedule(case, 32)
    return case, kj, to_torch(kj), scale, (sched if tree else sched[:7])


def _torch_args(case):
    return [torch.from_numpy(case[k]) for k in
            ("positions", "req_idx", "block_tables", "seq_lens")]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("q_std", [1.0, 5.0])
def test_kernel_rounding_meets_the_card_bound(q_std, kv_dtype, d, tree):
    case, kj, kt, scale, sched = numerics_case(q_std, kv_dtype, d, tree)
    pos, req, bt, sl = _torch_args(case)
    live = req >= 0
    q = torch.from_numpy(case["q"])
    tree_kw = dict(tree_start=torch.from_numpy(case["tree_start"]),
                   row_tree_mask=torch.from_numpy(case["row_mask"])) \
        if tree else {}
    model = mma_model(q, kt[1], pos, req, bt, sl, scale[1], **tree_kw)
    plain32 = ragged_paged_attention_reference(
        q, kt[1], pos, req, bt, sl, kv_scale=scale[1], **tree_kw)
    assert _rel(model[live], plain32[live]) <= REL_TOL / 100
    # The kernel's output and the plain version's are both bf16.
    plain = ragged_paged_attention_reference(
        q.to(torch.bfloat16), kt[1], pos, req, bt, sl, kv_scale=scale[1],
        **tree_kw)
    assert _rel(model.to(torch.bfloat16)[live].float(),
                plain[live].float()) <= REL_TOL
    assert not model[~live].any()
    if d != 128:
        return
    # The TPU kernel in interpret mode, through the same schedule.
    names = ("positions", "req_idx", "block_tables", "seq_lens")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.ragged_paged_attention_kernel(
            jnp.asarray(case["q"]), kj,
            *(jnp.asarray(case[k]) for k in names), qb=32,
            schedule=tuple(jnp.asarray(a) for a in sched),
            kv_scale=jnp.asarray(scale), layer=jnp.asarray(1, jnp.int32)))
    np.testing.assert_allclose(model[live].numpy(), ref[live.numpy()],
                               atol=TOL, rtol=TOL)
    # The wrapper's CPU route with the same schedule is the plain version.
    out = tra.ragged_paged_attention_kernel(
        q, kt, pos, req, bt, sl, qb=32,
        schedule=tuple(torch.from_numpy(a) for a in sched),
        kv_scale=torch.from_numpy(scale), layer=1)
    assert _rel(model[live], out[live]) <= REL_TOL


def test_single_bf16_rounding_misses_the_card_bound():
    """q and P rounded to bf16 once, at q std 5 over contexts ~3000 (the
    card check's inputs): the relative error exceeds the bound the
    kernel is held to, while the kernel's scheme stays well inside it."""
    rng = np.random.default_rng(9)
    reqs = [(int(c), 1, None) for c in rng.integers(2800, 3200, 16)] + [
        (2900, 64, None)]
    case = tree_case(reqs, Hq=8, Hkv=2, D=128, seed=10)
    q = torch.from_numpy(rng.standard_normal(case["q"].shape).astype(
        np.float32) * 5.0).to(torch.bfloat16)
    kt = torch.from_numpy(case["kv"] * 0.5).to(torch.bfloat16)
    pos, req, bt, sl = _torch_args(case)
    scale = np.ones(2, np.float32)
    plain = ragged_paged_attention_reference(
        q.float(), kt, pos, req, bt, sl, kv_scale=scale)
    single = mma_model(q, kt, pos, req, bt, sl, scale, scheme="single")
    kernel = mma_model(q, kt, pos, req, bt, sl, scale)
    assert _rel(single, plain) > REL_TOL
    assert _rel(kernel, plain) < REL_TOL / 10


@pytest.mark.parametrize("scheme", ["q_single", "p_single"])
def test_one_sided_split_misses_the_card_bound(scheme):
    """Splitting only one of q and P (half the extra MMAs) also misses
    the bound on the same inputs with bf16 pages and outputs: both
    splits are needed (kernels 1-4)."""
    rng = np.random.default_rng(9)
    reqs = [(int(c), 1, None) for c in rng.integers(2800, 3200, 16)] + [
        (2900, 64, None)]
    case = tree_case(reqs, Hq=8, Hkv=2, D=128, seed=10)
    q = torch.from_numpy(rng.standard_normal(case["q"].shape).astype(
        np.float32) * 5.0).to(torch.bfloat16)
    kt = torch.from_numpy(case["kv"] * 0.5).to(torch.bfloat16)
    pos, req, bt, sl = _torch_args(case)
    scale = np.ones(2, np.float32)
    plain = ragged_paged_attention_reference(
        q.float(), kt, pos, req, bt, sl, kv_scale=scale)
    one = mma_model(q, kt, pos, req, bt, sl, scale, scheme=scheme)
    assert _rel(one.to(torch.bfloat16).float(),
                plain.to(torch.bfloat16).float()) > REL_TOL


# ---- kernels 2 and 3: the grouped decode kernel -----------------------------

STREAMS = 4      # page streams of the grouped kernel: chunk c -> stream c % 4
CHUNK = 16       # slots per chunk (half a page)
MTILE = 16       # rows per m-tile
NEG = float("-inf")


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 product of 16-bit operands, rounded once to float32 (the
    tensor cores' float32 sums, to within their order)."""
    return x.to(torch.float32)


def _fold(state, s, v, dt):
    """One 16-slot chunk into a stream's state (m, l, o) of a 16-row tile:
    s [16, 16] float32 scores (masked to -inf), v [16, D] float32.  A row
    whose max does not move keeps alpha = 1, as the kernel does."""
    m, l, o = state
    m_new = torch.maximum(m, s.amax(-1))
    m_use = torch.where(m_new == NEG, 0.0, m_new)
    alpha = torch.where(m_new == m, 1.0, torch.exp2(m - m_use))
    p = torch.exp2(s - m_use[:, None])
    l = l * alpha + _f32(p.double().sum(-1))
    p_hi, p_lo = _split(p, dt)
    pv = _f32(p_hi.double() @ v.double() + p_lo.double() @ v.double())
    return m_new, l, o * alpha[:, None] + pv


def _merge(a, b):
    """Stream b's state into stream a's, as the kernel's stream 0 does."""
    m0, l0, o0 = a
    m1, l1, o1 = b
    mx = torch.maximum(m0, m1)
    mu = torch.where(mx == NEG, 0.0, mx)
    f0 = torch.where(m0 == mx, 1.0, torch.exp2(m0 - mu))
    f1 = torch.where(m1 == mx, 1.0, torch.exp2(m1 - mu))
    return mx, l0 * f0 + l1 * f1, o0 * f0[:, None] + o1 * f1[:, None]


def grouped_mma_model(q, kv, pos_base, block_tables, seq_lens, qlen,
                      kv_scale, knew=None, vnew=None, slot_mapping=None):
    """The grouped kernel's arithmetic (kernels 2 and 3) on one cache layer
    ``kv`` [N, 2, 32, Hkv*D]; float32 out [T, Hq, D], padding rows zero.

    Per (sequence, kv head), rows i = token i // group under q head
    h * group + i % group, in 16-row m-tiles (padding rows zero).  Each
    tile folds every 16-slot chunk (half a page) up to its last row's
    position: chunk c into page stream c % 4, a base-2 online softmax in
    float32 per stream, q and P split into a 16-bit value and the
    remainder (bf16 for bf16 pages, fp16 for fp8 pages); the streams
    merge in stream order.  With ``knew`` / ``vnew`` the cache is read
    below pos_base and the new rows follow as one or two more chunks (row
    i attends new row j iff j <= its token index and j < new_len)."""
    t, hq, d = q.shape
    hkv = kv.shape[-1] // d
    group = hq // hkv
    b = block_tables.shape[0]
    dt = torch.float16 if kv.dtype == torch.float8_e4m3fn else torch.bfloat16
    k_scale, v_scale = (torch.tensor(float(x)) for x in kv_scale)
    qs = (torch.tensor(d ** -0.5) * k_scale) * torch.tensor(LOG2E)
    deferred = knew is not None
    out = torch.zeros((t, hq, d))
    for s in range(b):
        tok0 = s * qlen
        ntok = min(qlen, t - tok0)
        if ntok <= 0 or int(seq_lens[s]) <= 0:
            continue
        npages = min(-(-int(seq_lens[s]) // PAGE), block_tables.shape[1])
        pos0 = int(pos_base[s])
        new_len = sum(int(slot_mapping[tok0 + j]) >= 0
                      for j in range(qlen) if tok0 + j < t) if deferred else 0
        last = min(pos0 - 1 if deferred else pos0 + ntok - 1,
                   npages * PAGE - 1)
        ncc = last // CHUNK + 1 if last >= 0 else 0
        slots = torch.arange(CHUNK)
        for h in range(hkv):
            # K and V as the MMAs see them: bf16 as stored, fp8 as fp16;
            # slots past ``last`` and new rows past new_len as zeros.
            chunks = []
            for c in range(ncc):
                page = int(block_tables[s, c // 2])
                rows = slice((c % 2) * CHUNK, (c % 2 + 1) * CHUNK)
                ok = (c * CHUNK + slots <= last)[:, None]
                chunks.append(tuple(
                    torch.where(ok, kv[page, x, rows, h * d:(h + 1) * d]
                                .float(), 0.0) for x in (0, 1)))
            for j0 in range(0, new_len, CHUNK):
                rows = slice(tok0 + j0, tok0 + min(new_len, j0 + CHUNK))
                chunks.append(tuple(torch.nn.functional.pad(
                    x[rows, h * d:(h + 1) * d].float(),
                    (0, 0, 0, CHUNK - rows.stop + rows.start))
                    for x in (knew, vnew)))
            for r0 in range(0, ntok * group, MTILE):
                i = torch.arange(r0, r0 + MTILE)
                live = i < ntok * group
                tok = torch.where(live, i // group, 0)
                x = torch.where(live[:, None],
                                q[tok0 + tok, h * group + i % group].float(),
                                0.0) * qs
                q_hi, q_lo = _split(x, dt)
                lim = torch.where(live, pos0 - 1 if deferred else pos0 + tok,
                                  -1)
                nlim = torch.where(live, torch.clamp(tok, max=new_len - 1),
                                   -1)
                states = [(torch.full((MTILE,), NEG), torch.zeros(MTILE),
                           torch.zeros((MTILE, d)))] * STREAMS
                for c, (k, v) in enumerate(chunks):
                    base = c * CHUNK if c < ncc else (c - ncc) * CHUNK
                    row_lim = lim if c < ncc else nlim
                    if base > int(row_lim.max()):
                        continue
                    ok = base + slots[None, :] <= row_lim[:, None]
                    sc = _f32(q_hi.double() @ k.double().T
                              + q_lo.double() @ k.double().T)
                    sc = sc.masked_fill(~ok, NEG)
                    states[c % STREAMS] = _fold(states[c % STREAMS], sc, v,
                                                dt)
                m, l, o = states[0]
                for st in states[1:]:
                    m, l, o = _merge((m, l, o), st)
                o = o * (v_scale / l.clamp(min=1e-20))[:, None]
                out[tok0 + tok[live], h * group + i[live] % group] = o[live]
    return out


# Contexts of the grouped steps: a dead slot, rows on both sides of page
# boundaries, and enough pages for every page stream.
GROUPED_CTX = [45, 0, 300, 95, 130]
GROUPED_CASES = [(False, 1), (False, 4), (False, 8),
                 (True, 1), (True, 8), (True, 32)]


def grouped_case(ctx, qlen, q_std, kv_dtype, d, seed=0):
    """A grouped step on a 2-layer cache (layer 1 read; fp8 with scales 2
    and 0.5), Hq 8 over Hkv 2 (group 4): sequence s at ``ctx[s]`` cached
    tokens (0 = dead) with ``qlen`` rows at positions ctx + j; K, V and
    the new rows std 0.5, q std ``q_std`` (bf16 values).  The new rows'
    slot_mapping ends sequence 2 in a tail of min(2, qlen - 1) slot -1
    rows.  Returns numpy arrays, the JAX and torch caches and the
    scales."""
    rng = np.random.default_rng(seed)
    b = len(ctx)
    seq = np.array([c + qlen if c else 0 for c in ctx], np.int32)
    pages = [-(-int(x) // PAGE) for x in seq]
    n_blocks = sum(pages) + 2
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((b, max(pages)), np.int32)
    k = 0
    for s, n in enumerate(pages):
        bt[s, :n] = perm[k:k + n]
        k += n
    hq, hkv = 8, 2
    kv = rng.standard_normal((2, n_blocks, 2, PAGE, hkv * d)) * 0.5
    q = rng.standard_normal((b * qlen, hq, d)) * q_std
    q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    new = [rng.standard_normal((b * qlen, hkv * d)) * 0.5 for _ in range(2)]
    scale = np.ones((2, 2), np.float32)
    jdt = jnp.bfloat16
    if kv_dtype == "fp8":
        scale[1] = [2.0, 0.5]
        jdt = jnp.float8_e4m3fn
    kj = jnp.asarray(kv, jnp.float32).astype(jdt)
    nj = [jnp.asarray(x, jnp.float32).astype(jdt) for x in new]
    slot = np.full(b * qlen, -1, np.int32)
    for s in range(b):
        n_real = qlen - (min(2, qlen - 1) if s == 2 else 0)
        for j in range(n_real if seq[s] else 0):
            p = ctx[s] + j
            slot[s * qlen + j] = bt[s, p // PAGE] * PAGE + p % PAGE
    return dict(q=q, bt=bt, seq=seq, pos_base=np.array(ctx, np.int32),
                slot=slot, scale=scale), kj, nj


@pytest.mark.parametrize("deferred,qlen", GROUPED_CASES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("q_std", [1.0, 5.0])
def test_grouped_rounding_meets_the_card_bound(q_std, kv_dtype, d, deferred,
                                               qlen):
    """The grouped kernel's rounding (kernels 2 and 3) against the port's
    float32 plain versions (``_plain_uniform``,
    ``grouped_decode_deferred_reference``) within the card's 1e-3
    relative norm, and against the JAX kernel in Pallas interpret mode
    within atol = rtol = 2e-2."""
    c, kj, nj = grouped_case(GROUPED_CTX, qlen, q_std, kv_dtype, d)
    kt = to_torch(kj)
    q = torch.from_numpy(c["q"])
    pb, bt, sl = (torch.from_numpy(c[k]) for k in ("pos_base", "bt", "seq"))
    scale = torch.from_numpy(c["scale"])
    extra = {}
    if deferred:
        extra = dict(knew=to_torch(nj[0]), vnew=to_torch(nj[1]),
                     slot_mapping=torch.from_numpy(c["slot"]))
    else:
        pb = torch.clamp(sl - qlen, min=0)
    model = grouped_mma_model(q, kt[1], pb, bt, sl, qlen, scale[1], **extra)
    live = torch.repeat_interleave(sl > 0, qlen)
    assert not model[~live].any()

    def plain(qq):
        if deferred:
            return grouped_decode_deferred_reference(
                qq, kt[1], pb, bt, sl, qlen, kv_scale=scale[1], **extra)
        return tra._plain_uniform(qq, kt, 1, scale, pb, bt, sl, qlen,
                                  d ** -0.5)

    assert _rel(model[live], plain(q)[live]) <= REL_TOL / 100
    # The kernel's output and the plain version's, as the card compares
    # them: both bf16.
    assert _rel(model.to(torch.bfloat16)[live].float(),
                plain(q.to(torch.bfloat16))[live].float()) <= REL_TOL
    # The TPU kernel in interpret mode (gsz 1: its body compiled once).
    jextra = {}
    if deferred:
        jextra = dict(knew=nj[0], vnew=nj[1],
                      slot_mapping=jnp.asarray(c["slot"]))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.grouped_decode_attention_kernel(
            jnp.asarray(c["q"], jnp.bfloat16), kj, jnp.asarray(pb.numpy()),
            jnp.asarray(c["bt"]), jnp.asarray(c["seq"]), qlen=qlen, gsz=1,
            kv_scale=jnp.asarray(c["scale"]),
            layer=jnp.asarray(1, jnp.int32), **jextra), np.float32)
    np.testing.assert_allclose(model[live].numpy(), ref[live.numpy()],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_grouped_model_rows_do_not_depend_on_qlen(kv_dtype):
    """In the model of the grouped kernel a row's output is bit for bit
    the same at qlen 8, at qlen 4 and as the single row of a qlen-1 step
    that attends the same slots: chunks go to streams by slot index and
    a chunk a row does not attend leaves its state as it was.  The rows sit
    at other row indices of their m-tiles (and other tiles) in each."""
    ctx = [30, 62, 95, 200]
    outs = {}
    for qlen in (8, 4, 1):
        c, kj, _ = grouped_case(ctx, 8, 5.0, kv_dtype, 128, seed=3)
        q = torch.from_numpy(c["q"]).reshape(len(ctx), 8, 8, 128)
        kt = to_torch(kj)
        scale = torch.from_numpy(c["scale"])
        bt = torch.from_numpy(c["bt"])
        pb0 = torch.tensor(ctx, dtype=torch.int32)
        for j0 in range(0, 8, qlen):
            qq = q[:, j0:j0 + qlen].reshape(-1, 8, 128)
            pb = pb0 + j0
            o = grouped_mma_model(qq, kt[1], pb, bt, pb + qlen, qlen,
                                  scale[1])
            for j in range(qlen):
                outs.setdefault(j0 + j, []).append(
                    o.reshape(len(ctx), qlen, 8, 128)[:, j])
    for j, rows in outs.items():
        assert len(rows) == 3
        for other in rows[1:]:
            assert torch.equal(rows[0], other), f"position {j}"


# ---- kernel 4: the grouped kernel's CTA over fixed page ranges --------------

def range_mma_model(q, kv, pos_base, block_tables, seq_lens, qlen, kv_scale,
                    range_pages):
    """Kernel 4's arithmetic on one cache layer ``kv`` [N, 2, 32, Hkv*D];
    float32 out [T, Hq, D], padding rows zero.

    Per (sequence, kv head, range r of ``range_pages`` pages, as
    ``range_plan`` cuts the rows' last attended slot), the grouped
    kernel's CTA: 16-row m-tiles, 16-slot chunk c of the range into page
    stream c % 4, q and P split hi + lo, the streams merged in stream
    order.  One range: its state is the output.  Several: each range's
    float32 state (o, m, l) per row, merged in range order 0, 1, ...,
    a range the row does not attend (m = -inf) skipped."""
    t, hq, d = q.shape
    hkv = kv.shape[-1] // d
    group = hq // hkv
    b = block_tables.shape[0]
    dt = torch.float16 if kv.dtype == torch.float8_e4m3fn else torch.bfloat16
    k_scale, v_scale = (torch.tensor(float(x)) for x in kv_scale)
    qs = (torch.tensor(d ** -0.5) * k_scale) * torch.tensor(LOG2E)
    out = torch.zeros((t, hq, d))
    slots = torch.arange(CHUNK)
    for s in range(b):
        tok0 = s * qlen
        ntok = min(qlen, t - tok0)
        if ntok <= 0 or int(seq_lens[s]) <= 0:
            continue
        npages = min(-(-int(seq_lens[s]) // PAGE), block_tables.shape[1])
        pos0 = int(pos_base[s])
        last = min(pos0 + ntok - 1, npages * PAGE - 1)
        ranges = tra.range_plan(last + 1, range_pages)
        for h in range(hkv):
            for r0 in range(0, ntok * group, MTILE):
                i = torch.arange(r0, r0 + MTILE)
                live = i < ntok * group
                tok = torch.where(live, i // group, 0)
                x = torch.where(live[:, None],
                                q[tok0 + tok, h * group + i % group].float(),
                                0.0) * qs
                q_hi, q_lo = _split(x, dt)
                lim = torch.where(live, pos0 + tok, -1)
                parts = []
                for p0, p1 in ranges:
                    states = [(torch.full((MTILE,), NEG), torch.zeros(MTILE),
                               torch.zeros((MTILE, d)))] * STREAMS
                    c_first = p0 * PAGE // CHUNK
                    for c in range(c_first, min(p1 * PAGE // CHUNK,
                                                last // CHUNK + 1)):
                        base = c * CHUNK
                        if base > int(lim.max()):
                            continue
                        page = int(block_tables[s, c // 2])
                        rows = slice((c % 2) * CHUNK, (c % 2 + 1) * CHUNK)
                        ok = (base + slots <= last)[:, None]
                        k, v = (torch.where(
                            ok, kv[page, y, rows, h * d:(h + 1) * d].float(),
                            0.0) for y in (0, 1))
                        sc = _f32(q_hi.double() @ k.double().T
                                  + q_lo.double() @ k.double().T)
                        sc = sc.masked_fill(
                            ~(base + slots[None, :] <= lim[:, None]), NEG)
                        st = (c - c_first) % STREAMS
                        states[st] = _fold(states[st], sc, v, dt)
                    m, l, o = states[0]
                    for st in states[1:]:
                        m, l, o = _merge((m, l, o), st)
                    parts.append((m, l, o))
                m, l, o = parts[0]
                for pm, pl_, po in parts[1:]:
                    use = pm != NEG
                    mm, ll, oo = _merge((m, l, o), (pm, pl_, po))
                    m = torch.where(use, mm, m)
                    l = torch.where(use, ll, l)
                    o = torch.where(use[:, None], oo, o)
                o = o * (v_scale / l.clamp(min=1e-20))[:, None]
                out[tok0 + tok[live], h * group + i[live] % group] = o[live]
    return out


# Contexts of kernel 4's steps: a dead slot, one range, rows on both sides
# of a range boundary at 2-page ranges, and four ranges.
RANGE_CTX = [45, 0, 60, 95, 250]


@pytest.mark.parametrize("range_pages", [2, tra.RANGE_PAGES])
@pytest.mark.parametrize("qlen", [1, 4, 8])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_range_rounding_meets_the_card_bound(kv_dtype, qlen, range_pages):
    """Kernel 4's rounding against the port's float32 plain version
    within the card's 1e-3 relative norm (1e-5 in float32), and against
    the JAX ``decode_paged_attention_kernel`` in Pallas interpret mode at
    head dim 128 within atol = rtol = 2e-2; q std 5."""
    c, kj, _ = grouped_case(RANGE_CTX, qlen, 5.0, kv_dtype, 128, seed=4)
    kt = to_torch(kj)
    q = torch.from_numpy(c["q"])
    bt, sl = torch.from_numpy(c["bt"]), torch.from_numpy(c["seq"])
    pb = torch.clamp(sl - qlen, min=0)
    scale = torch.from_numpy(c["scale"])
    model = range_mma_model(q, kt[1], pb, bt, sl, qlen, scale[1],
                            range_pages)
    live = torch.repeat_interleave(sl > 0, qlen)
    assert not model[~live].any()

    def plain(qq):
        return tra._plain_uniform(qq, kt, 1, scale, pb, bt, sl, qlen,
                                  128 ** -0.5)

    assert _rel(model[live], plain(q)[live]) <= REL_TOL / 100
    assert _rel(model.to(torch.bfloat16)[live].float(),
                plain(q.to(torch.bfloat16))[live].float()) <= REL_TOL
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jra.decode_paged_attention_kernel(
            jnp.asarray(c["q"], jnp.bfloat16), kj, jnp.asarray(pb.numpy()),
            jnp.asarray(c["bt"]), jnp.asarray(c["seq"]), qlen,
            kv_scale=jnp.asarray(c["scale"]),
            layer=jnp.asarray(1, jnp.int32)), np.float32)
    np.testing.assert_allclose(model[live].numpy(), ref[live.numpy()],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"])
def test_range_model_rows_do_not_depend_on_qlen(kv_dtype):
    """In the model of kernel 4 (2-page ranges) a row's output is bit for
    bit the same at qlen 8, at qlen 4 and as the single row of a qlen-1
    step: rows whose slots end in one range are written from it at qlen
    1 and merged with later, empty ranges at qlen 8."""
    ctx = [30, 60, 95, 200]
    outs = {}
    for qlen in (8, 4, 1):
        c, kj, _ = grouped_case(ctx, 8, 5.0, kv_dtype, 128, seed=3)
        q = torch.from_numpy(c["q"]).reshape(len(ctx), 8, 8, 128)
        kt = to_torch(kj)
        scale = torch.from_numpy(c["scale"])
        bt = torch.from_numpy(c["bt"])
        pb0 = torch.tensor(ctx, dtype=torch.int32)
        for j0 in range(0, 8, qlen):
            qq = q[:, j0:j0 + qlen].reshape(-1, 8, 128)
            pb = pb0 + j0
            o = range_mma_model(qq, kt[1], pb, bt, pb + qlen, qlen, scale[1],
                                2)
            for j in range(qlen):
                outs.setdefault(j0 + j, []).append(
                    o.reshape(len(ctx), qlen, 8, 128)[:, j])
    for j, rows in outs.items():
        assert len(rows) == 3
        for other in rows[1:]:
            assert torch.equal(rows[0], other), f"position {j}"
