"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU (a
CUDA kernel has no CPU mode; the CPU tests hold the plain versions
against the JAX package instead).  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerance: bf16 outputs at atol = rtol = 2e-2 (tests/test_kernels.py),
and ||out - plain|| <= 1e-3 ||plain|| over the valid rows.  q is drawn
with std 5 against K of std 0.5, so the softmax is peaked and outputs are
O(|V|): a mask or page off by one token moves them far past both bounds.
The quantized matmuls draw x and the weights (before quantization) from
N(0, 1), so outputs are O(sqrt(K)); kernel and plain version multiply
the same bf16 values and differ only in the order of the float32 sums,
and so by rare one-ulp flips of the bf16 output: the same bounds hold.
The weight-stream variants (kernel 8) draw weights as the JAX
microbench's ``gen_ws`` does and are held to the same bounds; the HBM
read probe (kernel 7) sums float32 values in another order than its
plain version, within 1e-6 of the sum of their magnitudes.
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.ops.attention import (
    ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda import fp8_matmul as tfm
from arcticinference_tpu_torch.ops.cuda import hbm_probe as thp
from arcticinference_tpu_torch.ops.cuda import int4_matmul as tim
from arcticinference_tpu_torch.ops.cuda import ragged_attention as tra
from arcticinference_tpu_torch.ops.cuda import stream_matmul as tsm

TOL = 2e-2
REL_TOL = 1e-3
Q_STD = 5.0
HQ, HKV, D, BS = 8, 2, 128, 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def paged_case(reqs, kv_dtype, device, t_pad, layers=2, seed=0, d=D):
    """Requests [(ctx, qlen)] on a stacked cache with scattered pages;
    layer 1 carries fp8 scales (2.0, 0.5)."""
    rng = np.random.default_rng(seed)
    pages = [-(-(c + q) // BS) if q else 0 for c, q in reqs]
    n_blocks = sum(pages) + 1
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((len(reqs), max(pages)), np.int32)
    k = 0
    for r, n in enumerate(pages):
        bt[r, :n] = perm[k:k + n]
        k += n
    kv = torch.from_numpy(rng.standard_normal(
        (layers, n_blocks, 2, BS, HKV * d)).astype(np.float32) * 0.5)
    scale = torch.ones((layers, 2))
    if kv_dtype == torch.float8_e4m3fn:
        scale[1] = torch.tensor([2.0, 0.5])
    q = torch.from_numpy(rng.standard_normal((t_pad, HQ, d)).astype(
        np.float32) * Q_STD)
    seq = np.array([c + q_ if q_ else 0 for c, q_ in reqs], np.int32)
    return (q.to(device, torch.bfloat16), kv.to(device, kv_dtype),
            scale.to(device), torch.from_numpy(bt).to(device),
            torch.from_numpy(seq).to(device))


def assert_matches(out, ref):
    out, ref = out.float().cpu(), ref.float().cpu()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    assert (out - ref).norm() <= REL_TOL * ref.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qb", [8, 32])
@pytest.mark.parametrize("d", [128, 64])
def test_ragged_kernel_matches_plain(cuda_device, d, qb, kv_dtype):
    reqs = [(0, 40), (37, 1), (64, 9), (300, 70)]
    t_pad = 128
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_pad,
                                      d=d)
    pos = np.zeros(t_pad, np.int32)
    req = np.full(t_pad, -1, np.int32)
    t = 0
    for r, (c, n) in enumerate(reqs):
        pos[t:t + n], req[t:t + n] = np.arange(c, c + n), r
        t += n
    pos_t = torch.from_numpy(pos).to(cuda_device)
    req_t = torch.from_numpy(req).to(cuda_device)
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(q, kv, pos_t, req_t, bt, sl,
                                            qb=qb, kv_scale=scale, layer=1)
    ref = ragged_paged_attention_reference(q, kv[1], pos_t, req_t, bt, sl,
                                           kv_scale=scale[1])
    torch.cuda.synchronize()
    assert tra.ragged_attention_launches == 1
    live = req_t >= 0
    assert_matches(out[live], ref[live])
    assert not out[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen,t_rows", [(1, 16), (1, 2), (3, 12), (4, 16),
                                         (8, 32), (8, 40)])
@pytest.mark.parametrize("d", [128, 64])
def test_grouped_kernel_matches_plain(cuda_device, d, qlen, t_rows,
                                      kv_dtype):
    """Dead slot 1; the token bucket wider (16 rows for 4 slots) and
    narrower (2 rows) than B * qlen; qlen 8 (32 rows per kv head: two m16
    tiles in one pass)."""
    reqs = [(17, qlen), (0, 0), (70, qlen), (500, qlen)]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_rows,
                                      d=d)
    pos_base = torch.clamp(sl - qlen, min=0)
    tra.reset_launch_counts()
    out = tra.grouped_decode_attention_kernel(q, kv, pos_base, bt, sl,
                                              qlen=qlen, kv_scale=scale,
                                              layer=1)
    # The wrappers' CPU path is the plain version with the same row map.
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pos_base.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
        kv_scale=scale.cpu(), layer=1)
    torch.cuda.synchronize()
    assert tra.grouped_decode_launches == 1
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen,t_rows", [(1, 4), (1, 16), (4, 16), (8, 32),
                                         (32, 128)])
@pytest.mark.parametrize("d", [128, 64])
def test_decode_paged_kernel_matches_plain(cuda_device, d, qlen, t_rows,
                                           kv_dtype):
    """Kernel 4 (one CTA per sequence): dead slot 1, a context of 500 (16
    pages), the token bucket wider than B * qlen once, 4 to 32 rows per kv
    head (qlen 32: two passes of the CTA's warps over the pages)."""
    reqs = [(17, qlen), (0, 0), (70, qlen), (500, qlen)]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_rows,
                                      d=d)
    pos_base = torch.clamp(sl - qlen, min=0)
    tra.reset_launch_counts()
    out = tra.decode_paged_attention_kernel(q, kv, pos_base, bt, sl, qlen,
                                            kv_scale=scale, layer=1)
    ref = tra.decode_paged_attention_kernel(
        q.cpu(), kv.cpu(), pos_base.cpu(), bt.cpu(), sl.cpu(), qlen,
        kv_scale=scale.cpu(), layer=1)
    torch.cuda.synchronize()
    assert tra.decode_paged_launches == 1
    assert tra.grouped_decode_launches == 0
    assert_matches(out, ref)
    live = torch.repeat_interleave(sl.cpu() > 0, qlen)
    live = torch.nn.functional.pad(live, (0, t_rows - live.numel()))
    assert not out.cpu()[~live].any()


@pytest.mark.cuda
def test_decode_paged_refuses_wide_rows(cuda_device):
    """Kernel 4 stages whole token rows: more than 2 KiB a row raises."""
    kv = torch.zeros((1, 2, 2, BS, 16 * 128), device=cuda_device,
                     dtype=torch.bfloat16)
    q = torch.zeros((1, 16, 128), device=cuda_device, dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        tra.decode_paged_attention_kernel(q, kv, one - 1, one[:, None], one,
                                          1, layer=0)


def deferred_rows(reqs, qlen, tails, kv_dtype, scale, t_rows, device,
                  seed=1, d=D):
    """The step's new rows of a deferred-write grouped step: knew / vnew
    [t_rows, Hkv*D] in the cache dtype, drawn as the cache's values are
    (so a new row weighs as much as a cached one under layer 1's scales),
    and slot_mapping [t_rows], -1 on dead slots, on the last
    ``tails[s]`` rows of sequence s and on bucket padding."""
    del scale
    rng = np.random.default_rng(seed)
    kn, vn = (torch.from_numpy(rng.standard_normal(
        (t_rows, HKV * d)).astype(np.float32) * 0.5) for _ in range(2))
    slot = np.full(t_rows, -1, np.int32)
    for s, (ctx, ql) in enumerate(reqs):
        for j in range(ql - tails.get(s, 0)):
            if s * qlen + j < t_rows:
                slot[s * qlen + j] = 1000 + s * qlen + j
    return (kn.to(device, kv_dtype), vn.to(device, kv_dtype),
            torch.from_numpy(slot).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen,t_rows", [(1, 16), (1, 2), (4, 16), (8, 24),
                                         (8, 40), (32, 128)])
@pytest.mark.parametrize("d", [128, 64])
def test_deferred_kernel_matches_plain(cuda_device, d, qlen, t_rows,
                                       kv_dtype):
    """Kernel 3 (deferred writes): dead slot 1, a slot -1 tail on slot 2
    (new_len < qlen), the bucket wider and narrower than B * qlen; the
    kernel against the wrapper's CPU path (the plain version), and
    against attention without the injected rows, which must differ."""
    reqs = [(17, qlen), (0, 0), (70, qlen), (500, qlen)]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_rows,
                                      d=d)
    pos_base = torch.tensor([c for c, _ in reqs], dtype=torch.int32,
                            device=cuda_device)
    kn, vn, slot = deferred_rows(reqs, qlen, {2: min(2, qlen - 1)},
                                 kv_dtype, scale, t_rows, cuda_device, d=d)
    tra.reset_launch_counts()
    out = tra.grouped_decode_attention_kernel(
        q, kv, pos_base, bt, sl, qlen=qlen, kv_scale=scale, layer=1,
        knew=kn, vnew=vn, slot_mapping=slot)
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pos_base.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
        kv_scale=scale.cpu(), layer=1, knew=kn.cpu(), vnew=vn.cpu(),
        slot_mapping=slot.cpu())
    torch.cuda.synchronize()
    assert tra.deferred_decode_launches == 1
    assert tra.grouped_decode_launches == 0
    assert_matches(out, ref)
    cache_only = tra.grouped_decode_attention_kernel(
        q, kv, pos_base, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
    assert (cache_only.float() - ref.float().to(cuda_device)).abs().max() \
        > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [1, 8])
def test_deferred_kernel_at_smoke_shapes(cuda_device, qlen, kv_dtype):
    """B = 64 sequences at contexts 128-2048, 6 dead, 8 with a slot -1
    tail of 1-3 rows (the fused loop's wide and narrow steps)."""
    rng = np.random.default_rng(7)
    ctx = rng.integers(128, 2049, 64)
    dead = set(rng.choice(64, 6, replace=False).tolist())
    reqs = [(0, 0) if s in dead else (int(ctx[s]), qlen) for s in range(64)]
    t_rows = 64 * qlen
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_rows)
    pos_base = torch.tensor([c for c, _ in reqs], dtype=torch.int32,
                            device=cuda_device)
    live = [s for s in range(64) if s not in dead]
    tails = {s: int(rng.integers(1, 4)) % qlen for s in live[:8]}
    kn, vn, slot = deferred_rows(reqs, qlen, tails, kv_dtype, scale, t_rows,
                                 cuda_device)
    out = tra.grouped_decode_attention_kernel(
        q, kv, pos_base, bt, sl, qlen=qlen, kv_scale=scale, layer=1,
        knew=kn, vnew=vn, slot_mapping=slot)
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pos_base.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
        kv_scale=scale.cpu(), layer=1, knew=kn.cpu(), vnew=vn.cpu(),
        slot_mapping=slot.cpu())
    torch.cuda.synchronize()
    assert_matches(out, ref)


@pytest.mark.cuda
def test_deferred_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    reqs = [(5, 3)]
    q, kv, scale, bt, sl = paged_case(reqs, torch.bfloat16, cuda_device, 3)
    pb = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    kn, vn, slot = deferred_rows(reqs, 3, {}, torch.bfloat16, scale, 3,
                                 cuda_device)
    tra.reset_launch_counts()
    with pytest.raises(ValueError):              # knew without vnew
        tra.grouped_decode_attention_kernel(q, kv, pb, bt, sl, qlen=3,
                                            layer=1, knew=kn,
                                            slot_mapping=slot)
    with pytest.raises(TypeError):               # rows not in cache dtype
        tra.grouped_decode_attention_kernel(
            q, kv, pb, bt, sl, qlen=3, layer=1, knew=kn.float(),
            vnew=vn.float(), slot_mapping=slot)
    with pytest.raises(ValueError):              # rows of another count
        tra.grouped_decode_attention_kernel(
            q, kv, pb, bt, sl, qlen=3, layer=1, knew=kn[:2], vnew=vn[:2],
            slot_mapping=slot[:2])
    assert tra.deferred_decode_launches == 0


def uniform_step(ctx, qlen, kv_dtype, device, d=D, hq=HQ, seed=0):
    """A grouped decode step: sequence s at ``ctx[s]`` cached tokens (0 =
    dead) with ``qlen`` rows at positions ctx + j; returns q, the cache,
    scales, block tables, seq_lens and pos_base."""
    reqs = [(c, qlen if c else 0) for c in ctx]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, device,
                                      len(ctx) * qlen, d=d, seed=seed)
    if hq != HQ:
        q = torch.cat([q, q.flip(0)], dim=1)[:, :hq].contiguous()
    return q, kv, scale, bt, sl, torch.tensor(ctx, dtype=torch.int32,
                                              device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [1, 4, 8])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("deferred", [False, True])
def test_grouped_kernel_ignores_poisoned_slots(cuda_device, deferred, d,
                                               qlen, kv_dtype):
    """Kernels 2 and 3 on a cache with NaN (fp8: 0x7f) in every block no
    block table references and in every slot at or past seq_len (kernel
    3: at or past pos_base, the new rows' slots not written yet): the
    kernel equals the plain version on the clean cache."""
    ctx = [30, 0, 1000, 4000, 67, 500]
    q, kv, scale, bt, sl, pb = uniform_step(ctx, qlen, kv_dtype,
                                            cuda_device, d=d)
    extra = {}
    if deferred:
        reqs = [(c, qlen if c else 0) for c in ctx]
        kn, vn, slot = deferred_rows(reqs, qlen, {2: min(2, qlen - 1)},
                                     kv_dtype, scale, q.shape[0],
                                     cuda_device, d=d)
        extra = dict(knew=kn, vnew=vn, slot_mapping=slot)
        bad = poisoned(kv, bt, torch.where(sl > 0, pb, 0))
    else:
        pb = torch.clamp(sl - qlen, min=0)
        bad = poisoned(kv, bt, sl)
    out = tra.grouped_decode_attention_kernel(
        q, bad, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1, **extra)
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pb.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
        kv_scale=scale.cpu(), layer=1,
        **{k: v.cpu() for k, v in extra.items()})
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [4, 8])
@pytest.mark.parametrize("d", [128, 64])
def test_grouped_rows_do_not_depend_on_qlen(cuda_device, d, qlen, kv_dtype):
    """Row j of a qlen-``qlen`` launch is bit for bit the single row of a
    qlen-1 launch that attends the same slots (position ctx + j): the
    target's replay of a captured trajectory rests on it.  Contexts put
    the rows on both sides of page boundaries and over all four page
    streams."""
    ctx = [30, 62, 95, 1000, 4093, 31, 0, 700]
    q, kv, scale, bt, sl, pb = uniform_step(ctx, qlen, kv_dtype,
                                            cuda_device, d=d)
    out = tra.grouped_decode_attention_kernel(
        q, kv, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
    live = sl > 0
    for j in range(qlen):
        one = tra.grouped_decode_attention_kernel(
            q[j::qlen].contiguous(), kv, pb + j,
            bt, torch.where(live, pb + j + 1, 0), qlen=1, kv_scale=scale,
            layer=1)
        assert torch.equal(out[j::qlen].view(torch.int16),
                           one.view(torch.int16)), f"row {j}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [1, 4, 8])
@pytest.mark.parametrize("deferred", [False, True])
def test_grouped_kernel_at_group_8(cuda_device, deferred, qlen, kv_dtype):
    """Group 8 (16 q heads over 2 kv heads): qlen 4 fills two m16 tiles,
    qlen 8 (64 rows) takes two passes over the pages."""
    ctx = [30, 0, 1000, 300]
    q, kv, scale, bt, sl, pb = uniform_step(ctx, qlen, kv_dtype,
                                            cuda_device, hq=16)
    extra = {}
    if deferred:
        reqs = [(c, qlen if c else 0) for c in ctx]
        extra = dict(zip(("knew", "vnew", "slot_mapping"), deferred_rows(
            reqs, qlen, {3: min(2, qlen - 1)}, kv_dtype, scale, q.shape[0],
            cuda_device)))
    else:
        pb = torch.clamp(sl - qlen, min=0)
    out = tra.grouped_decode_attention_kernel(
        q, kv, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1, **extra)
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pb.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
        kv_scale=scale.cpu(), layer=1,
        **{k: v.cpu() for k, v in extra.items()})
    torch.cuda.synchronize()
    assert_matches(out, ref)


def random_tree(rng, n):
    """Parents of a best-first tree of ``n`` nodes: node i hangs off the
    frontier (-1) or an earlier node."""
    return [int(rng.integers(-1, i)) if i else -1 for i in range(n)]


def tree_step(reqs, device, qb):
    """A verify step over ``reqs`` [(ctx, real tokens fed, tree parents
    or None)]: positions (depth-based on tree rows), request ids, per-row
    tree masks and frontier slots, and the 9-tuple schedule the runner
    builds."""
    n_new = [c + len(p or ()) for _, c, p in reqs]
    t = sum(n_new)
    pos = np.zeros(t, np.int32)
    req = np.zeros(t, np.int32)
    rmask = np.zeros(t, np.int32)
    ts = np.full(len(reqs), -1, np.int32)
    i = 0
    for r, ((ctx, chunk, parents), n) in enumerate(zip(reqs, n_new)):
        pos[i:i + chunk] = np.arange(ctx, ctx + chunk)
        req[i:i + n] = r
        if parents:
            depth, mask = tra.tree_masks(parents)
            ts[r] = ctx + chunk - 1
            pos[i + chunk:i + n] = ts[r] + 1 + depth
            rmask[i + chunk:i + n] = mask
        i += n
    last = np.array([c + n - 1 for (c, _, _), n in zip(reqs, n_new)])
    sched = tra.build_work_items(np.array(n_new), last, qb, BS,
                                 t // qb + len(reqs), t)
    sched += tra.tree_work_items(rmask, ts, sched[0], sched[5], sched[6], qb)
    dev = [torch.from_numpy(a).to(device) for a in (pos, req, ts, rmask)]
    return dev, tuple(torch.from_numpy(a).to(device) for a in sched), n_new


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qb", [8, 32])
def test_tree_kernel_matches_plain(cuda_device, qb, kv_dtype):
    """The tree-mask path: a prefill chunk beside trees of 5, 12 and 30
    nodes (a 30-node tree reads bit 30 of its masks), against the plain
    version with the per-row masks."""
    rng = np.random.default_rng(4)
    reqs = [(0, 40, None), (37, 1, random_tree(rng, 12)),
            (300, 1, random_tree(rng, 30)), (64, 9, random_tree(rng, 5))]
    (pos, req, ts, rmask), sched, n_new = tree_step(reqs, cuda_device, qb)
    q, kv, scale, bt, sl = paged_case(
        [(c, n) for (c, _, _), n in zip(reqs, n_new)], kv_dtype,
        cuda_device, int(sum(n_new)))
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(
        q, kv, pos, req, bt, sl, qb=qb, schedule=sched, kv_scale=scale,
        layer=1)
    ref = ragged_paged_attention_reference(
        q, kv[1], pos, req, bt, sl, kv_scale=scale[1], tree_start=ts,
        row_tree_mask=rmask)
    causal = ragged_paged_attention_reference(
        q, kv[1], pos, req, bt, sl, kv_scale=scale[1])
    torch.cuda.synchronize()
    assert tra.tree_attention_launches == 1
    assert tra.ragged_attention_launches == 0
    assert_matches(out, ref)
    assert (causal.float() - ref.float()).abs().max() > 0.5


def ragged_rows(reqs, t_pad, device):
    """Positions and request ids of a ragged step: each request's new
    tokens in turn, then padding rows (request -1)."""
    pos = np.zeros(t_pad, np.int32)
    req = np.full(t_pad, -1, np.int32)
    t = 0
    for r, (c, n) in enumerate(reqs):
        pos[t:t + n], req[t:t + n] = np.arange(c, c + n), r
        t += n
    return torch.from_numpy(pos).to(device), torch.from_numpy(req).to(device)


def poisoned(kv, bt, sl):
    """A copy of the cache with NaN (bf16) or 0x7f (fp8 e4m3's NaN) in
    every block that no block table references and in every slot at or
    past its request's seq_len, in every layer."""
    bad = kv.clone()
    raw = bad.view(torch.uint8) if bad.dtype == torch.float8_e4m3fn else bad
    nan = 0x7f if raw.dtype == torch.uint8 else float("nan")
    bt_np, sl_np = bt.cpu().numpy(), sl.cpu().numpy()
    used = np.zeros(kv.shape[1], bool)
    for r, s in enumerate(sl_np):
        n = -(-int(s) // BS)
        used[bt_np[r, :n]] = True
        if n and s % BS:
            raw[:, int(bt_np[r, n - 1]), :, int(s % BS):] = nan
    raw[:, torch.from_numpy(~used).to(kv.device)] = nan
    return bad


# Steps of the ragged kernel at its item shapes (Hq 8, Hkv 2: group 4).
RAGGED_STEPS = {
    # 32-token items of 128 rows at qb 32, ending on 5, 33 and 3 pages.
    "128-row items, odd pages": ([(65, 64), (1000, 32), (3, 93)], 192),
    # A mixed step: prefill chunks beside decode rows at contexts ~4096
    # (4-row items: two warps per m-tile, merged at the end).
    "decode rows at ctx ~4096": ([(0, 100), (4000, 1), (4094, 1), (3077, 1),
                                  (4063, 1), (200, 37)], 144),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qb", [8, 32])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("step", sorted(RAGGED_STEPS))
def test_ragged_kernel_at_item_shapes(cuda_device, step, d, qb, kv_dtype):
    reqs, t_pad = RAGGED_STEPS[step]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_pad,
                                      d=d)
    pos, req = ragged_rows(reqs, t_pad, cuda_device)
    out = tra.ragged_paged_attention_kernel(q, kv, pos, req, bt, sl, qb=qb,
                                            kv_scale=scale, layer=1)
    ref = ragged_paged_attention_reference(q, kv[1], pos, req, bt, sl,
                                           kv_scale=scale[1])
    torch.cuda.synchronize()
    live = req >= 0
    assert_matches(out[live], ref[live])
    assert not out[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_ragged_kernel_with_two_row_passes(cuda_device, kv_dtype):
    """Group 8 (16 q heads over 2 kv heads): a 32-token item has 256 rows,
    two passes of the CTA's 128."""
    reqs = [(40, 64), (500, 7)]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, 72)
    q = torch.cat([q, q.flip(0)], dim=1).contiguous()
    pos, req = ragged_rows(reqs, 72, cuda_device)
    out = tra.ragged_paged_attention_kernel(q, kv, pos, req, bt, sl, qb=32,
                                            kv_scale=scale, layer=1)
    ref = ragged_paged_attention_reference(q, kv[1], pos, req, bt, sl,
                                           kv_scale=scale[1])
    torch.cuda.synchronize()
    live = req >= 0
    assert_matches(out[live], ref[live])
    assert not out[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qb", [8, 32])
@pytest.mark.parametrize("d", [128, 64])
def test_tree_kernel_with_unaligned_items(cuda_device, d, qb, kv_dtype):
    """Tree items whose first token is not at their 8-aligned window start
    (o0 > 0: the masks are indexed from the window), head dim 64 and 128."""
    rng = np.random.default_rng(5)
    reqs = [(0, 13, None), (37, 1, random_tree(rng, 12)),
            (300, 3, random_tree(rng, 30)), (64, 2, random_tree(rng, 5))]
    (pos, req, ts, rmask), sched, n_new = tree_step(reqs, cuda_device, qb)
    item_qstart, token_item, item_ts = (sched[i].cpu().numpy()
                                        for i in (1, 5, 7))
    o0 = [int(np.argmax(token_item == it)) - int(item_qstart[it])
          for it in np.nonzero(item_ts >= 0)[0]]
    assert max(o0) > 0
    q, kv, scale, bt, sl = paged_case(
        [(c, n) for (c, _, _), n in zip(reqs, n_new)], kv_dtype,
        cuda_device, int(sum(n_new)), d=d)
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(
        q, kv, pos, req, bt, sl, qb=qb, schedule=sched, kv_scale=scale,
        layer=1)
    ref = ragged_paged_attention_reference(
        q, kv[1], pos, req, bt, sl, kv_scale=scale[1], tree_start=ts,
        row_tree_mask=rmask)
    torch.cuda.synchronize()
    assert tra.tree_attention_launches == 1
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("tree", [False, True])
def test_ragged_kernel_ignores_poisoned_slots(cuda_device, tree, d,
                                              kv_dtype):
    """NaN in every unreferenced block and in every slot at or past
    seq_len (the pages' tails, block-table entries past each request's
    pages): the kernel on that cache equals the plain version on the clean
    one, so no such slot is read or weighted."""
    if tree:
        rng = np.random.default_rng(6)
        reqs = [(0, 45, None), (37, 1, random_tree(rng, 12)),
                (300, 1, random_tree(rng, 30)), (4000, 1, None)]
        (pos, req, ts, rmask), sched, n_new = tree_step(reqs, cuda_device,
                                                        32)
        paged = [(c, n) for (c, _, _), n in zip(reqs, n_new)]
        t_pad, qb = int(sum(n_new)), 32
        extra = dict(tree_start=ts, row_tree_mask=rmask)
    else:
        paged = [(0, 45), (37, 1), (300, 70), (4000, 1), (70, 9)]
        t_pad, qb, sched, extra = 136, 8, None, {}
        pos, req = ragged_rows(paged, t_pad, cuda_device)
    q, kv, scale, bt, sl = paged_case(paged, kv_dtype, cuda_device, t_pad,
                                      d=d)
    assert (sl % BS).bool().all()          # every last page has a tail
    bad = poisoned(kv, bt, sl)
    # Each request's last page holds NaN past seq_len.
    for r, s in enumerate(sl.tolist()):
        assert torch.isnan(bad[1, int(bt[r, (s - 1) // BS])].float()).any()
    out = tra.ragged_paged_attention_kernel(
        q, bad, pos, req, bt, sl, qb=qb, schedule=sched, kv_scale=scale,
        layer=1)
    ref = ragged_paged_attention_reference(q, kv[1], pos, req, bt, sl,
                                           kv_scale=scale[1], **extra)
    torch.cuda.synchronize()
    live = req >= 0
    assert torch.isfinite(out.float()).all()
    assert_matches(out[live], ref[live])
    assert not out[~live].any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, kv, scale, bt, sl = paged_case([(5, 3)], torch.bfloat16,
                                      cuda_device, 3)
    pos = torch.arange(5, 8, device=cuda_device, dtype=torch.int32)
    req = torch.zeros(3, device=cuda_device, dtype=torch.int32)
    with pytest.raises(TypeError):
        tra.ragged_paged_attention_kernel(q, kv.float(), pos, req, bt, sl,
                                          layer=1)
    with pytest.raises(TypeError):
        tra.ragged_paged_attention_kernel(q.float(), kv, pos, req, bt, sl,
                                          layer=1)
    with pytest.raises(ValueError):
        tra.ragged_paged_attention_kernel(q[..., :96].contiguous(), kv, pos,
                                          req, bt, sl, layer=1)


def quantized_case(mode, m, k, n, device, per_column=False, seed=0):
    """x [m, k] and layer 1 of a 2-layer stacked quantized weight, as the
    model indexes it (a scalar scale is then an unaligned [L] entry)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((2, k, n), generator=gen, device=device)
    if per_column:      # a fused weight: per-part scales, per column
        half = n // 2
        q = tfp8.fuse_quantized([tfp8.weight_quantize(w[..., :half], mode),
                                 tfp8.weight_quantize(w[..., half:], mode)])
    else:
        q = tfp8.weight_quantize(w, mode)
    return x, q[1]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 40, 64, 128, 200, 256])
@pytest.mark.parametrize("mode,per_column", [
    ("fp8", False), ("fp8", True), ("int8", False)])
def test_fp8_matmul_kernel_matches_plain(cuda_device, mode, per_column, m,
                                         out_dtype):
    """M=1..256 covers the 16- to 128-row tiles, padded rows, one and two
    row tiles, and split K over K warpgroups and a cluster (N = 384 is a
    small grid)."""
    x, q = quantized_case(mode, m, 1024, 384, cuda_device, per_column)
    tfm.reset_launch_counts()
    out = tfm.fp8_matmul_kernel(x, q.weight, q.scale, out_dtype)
    ref = tfm.fp8_matmul_reference(x, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    assert tfm.fp8_matmul_launches == 1
    assert out.dtype == out_dtype and out.shape == (m, 384)
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 40, 64, 128, 200, 256])
@pytest.mark.parametrize("k", [1024, 384, 128])
def test_int4_matmul_kernel_matches_plain(cuda_device, k, m, out_dtype):
    """K=384 and 128: the high half's rows start inside a scale group
    (K/2 = 192, 64), so they take another group than the low half's."""
    x, q = quantized_case("int4", m, k, 256, cuda_device)
    assert q.scale.shape == (k // 128, 256)
    tim.reset_launch_counts()
    out = tim.int4_matmul_kernel(x, q.weight, q.scale, out_dtype)
    ref = tim.int4_matmul_reference(x, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    assert tim.int4_matmul_launches == 1
    assert_matches(out, ref)


@pytest.mark.cuda
def test_quantized_matmul_is_deterministic(cuda_device):
    """Split-K partial sums are added in a fixed order."""
    x, q = quantized_case("fp8", 16, 4096, 512, cuda_device)
    a = tfm.fp8_matmul_kernel(x, q.weight, q.scale)
    b = tfm.fp8_matmul_kernel(x, q.weight, q.scale)
    sms = tfm.sm_count(x.get_device())
    assert tfm.launch_plan(16, 512, 4096 // 64, sms)[3] > 1
    assert torch.equal(a, b)


def matmul(mode, x, q):
    kernel = (tim.int4_matmul_kernel if mode == "int4"
              else tfm.fp8_matmul_kernel)
    return kernel(x, q.weight, q.scale)


# (K, N, M): split K over K warpgroups and a cluster (N = 512); K
# warpgroups alone (128 column tiles); one warpgroup per CTA (136 tiles);
# two row tiles of 128; two warpgroups side by side at 2048 rows.
REPLAY_SHAPES = [(4096, 512, 16), (4096, 512, 64), (2048, 16384, 64),
                 (1024, 17408, 40), (1024, 512, 256), (1024, 2048, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m", REPLAY_SHAPES)
@pytest.mark.parametrize("mode", ["fp8", "int4"])
def test_quantized_matmul_rows_are_replay_invariant(cuda_device, mode, k, n,
                                                    m):
    """A row's output is bit for bit the same whatever the other rows
    hold and wherever the row sits in the launch: its float32 sums depend
    only on the plan (which depends on the bucket of M)."""
    x, q = quantized_case(mode, m, k, n, cuda_device)
    out = matmul(mode, x, q)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x2 = torch.randn((m, k), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    moves = {j: (j + m // 2 + 3) % m for j in range(0, m, max(1, m // 8))}
    for j, j2 in moves.items():
        x2[j2] = x[j]
    out2 = matmul(mode, x2, q)
    torch.cuda.synchronize()
    for j, j2 in moves.items():
        assert torch.equal(out2[j2], out[j]), (j, j2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m", [(4096, 512, 16), (2048, 16384, 64)])
@pytest.mark.parametrize("mode", ["fp8", "int4"])
def test_quantized_matmul_graph_replay_matches_eager(cuda_device, mode, k,
                                                     n, m):
    """One launch captured in a CUDA graph and replayed twice gives the
    eager launch's bits (the split-K cluster and the K warpgroups keep
    no state between launches)."""
    x, q = quantized_case(mode, m, k, n, cuda_device)
    eager = matmul(mode, x, q)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        matmul(mode, x, q)                        # warm up off the graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul(mode, x, q)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_matmul_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """CUDA tensors the kernels do not take raise: no plain-version or
    CPU fallback, and no launch is counted."""
    x, q = quantized_case("fp8", 16, 256, 256, cuda_device)
    tfm.reset_launch_counts()
    tim.reset_launch_counts()
    with pytest.raises(ValueError):              # N not a multiple of 128
        tfm.fp8_matmul_kernel(x, q.weight[:, :96].contiguous(), q.scale)
    with pytest.raises(ValueError):              # K not a multiple of 64
        tfm.fp8_matmul_kernel(x[:, :96].contiguous(),
                              q.weight[:96].contiguous(), q.scale)
    with pytest.raises(TypeError):               # bf16 weights
        tfm.fp8_matmul_kernel(x, q.weight.to(torch.bfloat16), q.scale)
    with pytest.raises(TypeError):               # float16 output
        tfm.fp8_matmul_kernel(x, q.weight, q.scale, torch.float16)
    with pytest.raises(ValueError):              # a scale of another shape
        tfm.fp8_matmul_kernel(x, q.weight, q.scale.expand(3).contiguous())
    with pytest.raises(ValueError):              # weight on the CPU
        tfm.fp8_matmul_kernel(x, q.weight.cpu(), q.scale)
    with pytest.raises(ValueError):              # non-contiguous weight
        tfm.fp8_matmul_kernel(x, q.weight.t(), q.scale)
    x4, q4 = quantized_case("int4", 16, 256, 256, cuda_device)
    with pytest.raises(ValueError):              # scale not [K/128, N]
        tim.int4_matmul_kernel(x4, q4.weight, q4.scale[:1].contiguous())
    with pytest.raises(TypeError):               # unpacked values
        tim.int4_matmul_kernel(x4, q4.weight.to(torch.int16), q4.scale)
    with pytest.raises(ValueError):              # K not a multiple of 128
        tim.int4_matmul_kernel(x4[:, :192].contiguous(),
                               q4.weight[:96].contiguous(),
                               q4.scale[:1].contiguous())
    assert tfm.fp8_matmul_launches == 0 and tim.int4_matmul_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,shape", [(1024, thp.CHUNK_SHAPE),
                                          (5, thp.CHUNK_SHAPE),
                                          (300, (2, 64, 128))])
def test_hbm_read_probe_matches_plain(cuda_device, chunks, shape):
    """The full 4 GiB buffer of the bench, fewer chunks than SMs, and
    one-tile chunks, all of seeded random values."""
    gen = torch.Generator(device="cuda").manual_seed(chunks)
    x = torch.randn((chunks,) + shape, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    thp.reset_launch_counts()
    out = thp.hbm_read_probe(x)
    ref = thp.hbm_read_probe_reference(x)
    assert thp.hbm_probe_launches == 1
    l1 = x.reshape(chunks, -1)[:, :thp.ROW_ELEMS].float().abs().sum()
    assert out.shape == (1, 1) and out.dtype == torch.float32
    assert float((out - ref).abs()) <= 1e-6 * float(l1)
    # Partials are added in a fixed order: the same value every run.
    assert torch.equal(out, thp.hbm_read_probe(x))


@pytest.mark.cuda
def test_hbm_read_probe_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((4,) + thp.CHUNK_SHAPE, dtype=torch.bfloat16,
                    device=cuda_device)
    thp.reset_launch_counts()
    with pytest.raises(TypeError):
        thp.hbm_read_probe(x.float())
    with pytest.raises(ValueError):                  # chunk of 16 KiB
        thp.hbm_read_probe(torch.zeros((4, 64, 128), dtype=torch.bfloat16,
                                       device=cuda_device))
    with pytest.raises(ValueError):
        thp.hbm_read_probe(x.transpose(0, 1))
    assert thp.hbm_probe_launches == 0


def stream_case(k, n, device, seed=0):
    """x [64, k] N(0, 1) and a [k, n] weight drawn as gen_ws draws it,
    per variant."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((64, k), generator=gen, device=device).to(
        torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=device)
         .to(torch.bfloat16) * 0.02)
    fp8 = w.to(torch.float8_e4m3fn)
    i8 = torch.clamp(torch.round(w.float() / 0.001), -127, 127).to(
        torch.int8)
    return x, {"f16trick": fp8.view(torch.int8),
               "bittrick": fp8.view(torch.int8), "astype_e4m3": fp8,
               "astype_int8": i8}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tsm.VARIANTS)
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096),
                                 (4096, 4096), (4096, 28672), (4096, 6144),
                                 (128, 256)])
def test_stream_matmul_kernel_matches_plain(cuda_device, variant, k, n):
    """The five Llama-3.1-8B decode shapes at 64 rows, and a small one."""
    x, ws = stream_case(k, n, cuda_device)
    w = ws[variant]
    tsm.reset_launch_counts()
    out = tsm.stream_matmul_kernel(x, w, variant)
    assert tsm.stream_matmul_launches == 1
    assert out.dtype == torch.bfloat16 and out.shape == (64, n)
    assert_matches(out, tsm.stream_matmul_reference(x, w, variant))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f16trick", "bittrick"])
def test_stream_tricks_read_nan_codes_as_480(cuda_device, variant):
    """Every byte as a weight row: the tricks give +-480 for e4m3's NaN
    codes (0x7f, 0xff), as their JAX bodies do."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    w = codes.view(torch.int8).repeat_interleave(128).reshape(256, 128)
    x = torch.zeros((16, 256), dtype=torch.bfloat16)
    x[:, 0x7F], x[:, 0xFF] = 1.0, 2.0
    out = tsm.stream_matmul_kernel(x.to(cuda_device), w.to(cuda_device),
                                   variant).float().cpu()
    assert torch.equal(out, torch.full((16, 128), 480.0 - 960.0))


@pytest.mark.cuda
def test_stream_matmul_refuses_what_it_does_not_take(cuda_device):
    x, ws = stream_case(256, 256, cuda_device)
    tsm.reset_launch_counts()
    with pytest.raises(TypeError):            # e4m3 tensor for a trick
        tsm.stream_matmul_kernel(x, ws["astype_e4m3"], "f16trick")
    with pytest.raises(ValueError):           # N not a multiple of 128
        tsm.stream_matmul_kernel(x, ws["astype_int8"][:, :96].contiguous(),
                                 "astype_int8")
    with pytest.raises(ValueError):           # weight on the CPU
        tsm.stream_matmul_kernel(x, ws["astype_int8"].cpu(), "astype_int8")
    with pytest.raises(TypeError):            # float32 x
        tsm.stream_matmul_kernel(x.float(), ws["astype_int8"],
                                 "astype_int8")
    assert tsm.stream_matmul_launches == 0
