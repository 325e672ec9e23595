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
The grouped MoE matmul multiplies bf16 rows by the bf16 weights its plain
version dequantizes, float32 out: the same bounds hold, and rows one-hot
at a column must read the dequantized weight back bit for bit.
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
from arcticinference_tpu_torch.ops.cuda import grouped_matmul as tgm
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


def paged_case(reqs, kv_dtype, device, t_pad, layers=2, seed=0, d=D,
               hq=HQ, hkv=HKV):
    """Requests [(ctx, qlen)] on a stacked cache with scattered pages of
    ``hkv`` heads, ``hq`` q heads; layer 1 carries fp8 scales (2.0,
    0.5)."""
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
        (layers, n_blocks, 2, BS, hkv * d)).astype(np.float32) * 0.5)
    scale = torch.ones((layers, 2))
    if kv_dtype == torch.float8_e4m3fn:
        scale[1] = torch.tensor([2.0, 0.5])
    q = torch.from_numpy(rng.standard_normal((t_pad, hq, d)).astype(
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


@pytest.fixture(params=[2, tra.RANGE_PAGES], ids=lambda r: f"R{r}")
def range_pages(request, monkeypatch):
    """Kernel 4's range size: the wrapper's, and 2 pages (64 slots), at
    which short contexts already span many ranges and their merge."""
    monkeypatch.setattr(tra, "RANGE_PAGES", request.param)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen,t_rows", [(1, 4), (1, 16), (4, 16), (8, 32),
                                         (32, 128)])
@pytest.mark.parametrize("d", [128, 64])
def test_decode_paged_kernel_matches_plain(cuda_device, range_pages, d, qlen,
                                           t_rows, kv_dtype):
    """Kernel 4 (one CTA per sequence, kv head and page range): dead slot
    1, a context of 500 (16 pages: eight 2-page ranges merged), the token
    bucket wider than B * qlen once, 4 to 32 rows per kv head (qlen 32:
    four passes of the CTA's tiles over each range)."""
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
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_paged_kernel_takes_wide_rows(cuda_device, range_pages,
                                             kv_dtype):
    """Kernel 4 stages one head's D columns per token: 16 kv heads of 128
    (2048 elements a token row, refused by its first design) match the
    plain version."""
    rng = np.random.default_rng(4)
    hkv, hq, qlen = 16, 32, 4
    ctx = [40, 0, 600]
    seq = np.array([c + qlen if c else 0 for c in ctx], np.int32)
    pages = [-(-int(x) // BS) for x in seq]
    bt = np.zeros((len(ctx), max(pages)), np.int32)
    bt[0, :pages[0]] = np.arange(1, 1 + pages[0])
    bt[2, :pages[2]] = np.arange(1 + pages[0], 1 + pages[0] + pages[2])
    kv = torch.from_numpy(rng.standard_normal(
        (1, sum(pages) + 1, 2, BS, hkv * D)).astype(np.float32) * 0.5)
    q = torch.from_numpy(rng.standard_normal((len(ctx) * qlen, hq, D))
                         .astype(np.float32) * Q_STD).to(torch.bfloat16)
    kv = kv.to(kv_dtype)
    pb = torch.tensor(ctx, dtype=torch.int32)
    bt, sl = torch.from_numpy(bt), torch.from_numpy(seq)
    out = tra.decode_paged_attention_kernel(
        q.to(cuda_device), kv.to(cuda_device), pb.to(cuda_device),
        bt.to(cuda_device), sl.to(cuda_device), qlen, layer=0)
    ref = tra.decode_paged_attention_kernel(q, kv, pb, bt, sl, qlen, layer=0)
    torch.cuda.synchronize()
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [1, 8])
def test_decode_paged_kernel_at_long_contexts(cuda_device, qlen, kv_dtype):
    """Kernel 4 and kernel 2 at contexts of 9000-20000 tokens (18-40
    ranges a sequence, a dead slot) against the plain version."""
    reqs = [(9000, qlen), (0, 0), (20000, qlen), (15001, qlen)]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device,
                                      len(reqs) * qlen)
    pb = torch.clamp(sl - qlen, min=0)
    ref = tra.decode_paged_attention_kernel(
        q.cpu(), kv.cpu(), pb.cpu(), bt.cpu(), sl.cpu(), qlen,
        kv_scale=scale.cpu(), layer=1)
    for fn in (tra.decode_paged_attention_kernel,
               tra.grouped_decode_attention_kernel):
        out = fn(q, kv, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
        torch.cuda.synchronize()
        assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [4, 8])
@pytest.mark.parametrize("d", [128, 64])
def test_decode_paged_rows_do_not_depend_on_qlen(cuda_device, range_pages,
                                                 d, qlen, kv_dtype):
    """Row j of a kernel-4 launch at qlen ``qlen`` is bit for bit the
    single row of a qlen-1 launch at position ctx + j.  Contexts put rows
    on both sides of page and range boundaries (a row written from one
    range at qlen 1 is merged with an empty later range at qlen 8), over
    many ranges, and in a dead slot."""
    ctx = [30, 509, 1020, 4093, 0, 9000, 2045, 62]
    q, kv, scale, bt, sl, pb = uniform_step(ctx, qlen, kv_dtype,
                                            cuda_device, d=d)
    out = tra.decode_paged_attention_kernel(
        q, kv, pb, bt, sl, qlen, kv_scale=scale, layer=1)
    live = sl > 0
    for j in range(qlen):
        one = tra.decode_paged_attention_kernel(
            q[j::qlen].contiguous(), kv, pb + j,
            bt, torch.where(live, pb + j + 1, 0), 1, kv_scale=scale,
            layer=1)
        assert torch.equal(out[j::qlen].view(torch.int16),
                           one.view(torch.int16)), f"row {j}"


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


def uniform_step(ctx, qlen, kv_dtype, device, d=D, hq=HQ, seed=0,
                 hkv=HKV):
    """A grouped decode step: sequence s at ``ctx[s]`` cached tokens (0 =
    dead) with ``qlen`` rows at positions ctx + j; returns q, the cache,
    scales, block tables, seq_lens and pos_base."""
    reqs = [(c, qlen if c else 0) for c in ctx]
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, device,
                                      len(ctx) * qlen, d=d, seed=seed,
                                      hkv=hkv)
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


# Qwen2.5-7B's GQA group: 28 q heads over 4 kv heads.  Here 14 over 2
# (the cache's kv heads): a decode row maps to token r / 7 under q head
# h * 7 + r % 7, so kernel 2's and 4's tiles hold 7 rows at qlen 1, 28 at
# qlen 4 and 56 at qlen 8 (two passes of 32).
HQ_GROUP_7 = 7 * HKV
GROUP_7_CTX = [30, 0, 1000, 4093, 62, 509]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [1, 4, 8])
@pytest.mark.parametrize("kernel", ["grouped", "decode_paged"])
def test_decode_kernels_at_group_7(cuda_device, monkeypatch, kernel, qlen,
                                   kv_dtype):
    """Kernels 2 and 4 at group 7 against the plain version, on a clean
    cache and on one poisoned past every seq_len and in every unused
    block; kernel 4 at 2-page ranges too (a context of 4093 spans 64)."""
    q, kv, scale, bt, sl, _ = uniform_step(GROUP_7_CTX, qlen, kv_dtype,
                                           cuda_device, hq=HQ_GROUP_7)
    pb = torch.clamp(sl - qlen, min=0)
    fn = (tra.grouped_decode_attention_kernel if kernel == "grouped"
          else tra.decode_paged_attention_kernel)
    ref = fn(q.cpu(), kv.cpu(), pb.cpu(), bt.cpu(), sl.cpu(), qlen=qlen,
             kv_scale=scale.cpu(), layer=1)
    for cache in (kv, poisoned(kv, bt, sl)):
        out = fn(q, cache, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        assert_matches(out, ref)
    if kernel == "decode_paged":
        monkeypatch.setattr(tra, "RANGE_PAGES", 2)
        out = fn(q, kv, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
        torch.cuda.synchronize()
        assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qlen", [4, 8])
@pytest.mark.parametrize("kernel", ["grouped", "decode_paged"])
def test_group_7_rows_do_not_depend_on_qlen(cuda_device, kernel, qlen,
                                            kv_dtype):
    """At group 7 as at group 4: row j of a qlen-``qlen`` launch is bit
    for bit the single row of a qlen-1 launch at position ctx + j."""
    q, kv, scale, bt, sl, pb = uniform_step(GROUP_7_CTX, qlen, kv_dtype,
                                            cuda_device, hq=HQ_GROUP_7)
    fn = (tra.grouped_decode_attention_kernel if kernel == "grouped"
          else tra.decode_paged_attention_kernel)
    out = fn(q, kv, pb, bt, sl, qlen=qlen, kv_scale=scale, layer=1)
    live = sl > 0
    for j in range(qlen):
        one = fn(q[j::qlen].contiguous(), kv, pb + j, bt,
                 torch.where(live, pb + j + 1, 0), qlen=1, kv_scale=scale,
                 layer=1)
        assert torch.equal(out[j::qlen].view(torch.int16),
                           one.view(torch.int16)), f"row {j}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("qb", [8, 32])
def test_ragged_kernel_at_group_7(cuda_device, qb, kv_dtype):
    """Kernel 1 at group 7: a 32-token item has 224 rows (two passes of
    the CTA's 128, the second partial), an 8-token item 56; prefill
    chunks beside decode rows, on a clean and a poisoned cache."""
    reqs = [(40, 64), (500, 7), (3000, 1), (0, 45), (1023, 1)]
    t_pad = 128
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_pad)
    q = torch.cat([q, q.flip(0)], dim=1)[:, :HQ_GROUP_7].contiguous()
    pos, req = ragged_rows(reqs, t_pad, cuda_device)
    ref = ragged_paged_attention_reference(q, kv[1], pos, req, bt, sl,
                                           kv_scale=scale[1])
    live = req >= 0
    for cache in (kv, poisoned(kv, bt, sl)):
        out = tra.ragged_paged_attention_kernel(
            q, cache, pos, req, bt, sl, qb=qb, kv_scale=scale, layer=1)
        torch.cuda.synchronize()
        assert_matches(out[live], ref[live])
        assert not out[~live].any()


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


# The Qwen2.5-7B and Qwen3-8B products the Llama shapes do not cover
# (K, N): wqkv, wo, w_gateup, w_down and the LM head of Qwen2.5-7B
# (hidden 3584, intermediate 18944), w_gateup and w_down of Qwen3-8B
# (hidden 4096, intermediate 12288) and its LM head.
QWEN_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584),
               (3584, 152064), (4096, 24576), (12288, 4096), (4096, 151936)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 64, 2048])
@pytest.mark.parametrize("k,n", QWEN_SHAPES)
def test_fp8_matmul_kernel_at_qwen_shapes(cuda_device, k, n, m):
    """Kernel 5 at the Qwen weights (the plans they pick: split K on
    w_down's K = 18944, the wide LM heads) against the plain version;
    each moved row bit for bit beside fresh rows."""
    if m == 2048 and n > 100000:
        pytest.skip("the LM head sees only the sample rows (<= 64 here)")
    x, q = quantized_case("fp8", m, k, n, cuda_device)
    out_dtype = torch.float32 if n > 100000 else torch.bfloat16
    out = tfm.fp8_matmul_kernel(x, q.weight, q.scale, out_dtype)
    ref = tfm.fp8_matmul_reference(x, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    assert_matches(out, ref)
    x2 = torch.randn_like(x)
    moves = {j: (j + m // 2 + 3) % m for j in range(0, m, max(1, m // 8))}
    for j, j2 in moves.items():
        x2[j2] = x[j]
    out2 = tfm.fp8_matmul_kernel(x2, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    for j, j2 in moves.items():
        assert torch.equal(out2[j2], out[j]), (j, j2)


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
@pytest.mark.parametrize("variant", tsm.VARIANTS)
def test_stream_matmul_reads_every_code(cuda_device, variant):
    """One-hot x rows against w [64, 256] holding every byte code (code j
    in row j % 64 of column j, other codes elsewhere; the NaN codes 0x7f
    and 0xff only in their own columns): each output equals the variant's
    value of its weight byte, bit for bit (a signed zero compares equal:
    the kernel adds +0 products to it), and NaN exactly where the plain
    version gives NaN (astype_e4m3's columns 0x7f and 0xff: 0 * NaN)."""
    k_idx = torch.arange(64)[:, None]
    j_idx = torch.arange(256)[None, :]
    codes = (j_idx + 5 * k_idx) % 256
    nan_code = (codes & 0x7F) == 0x7F
    codes = torch.where(nan_code, codes ^ 1, codes)
    codes = torch.where(k_idx == j_idx % 64, j_idx, codes)
    w = codes.to(torch.uint8).view(torch.int8)
    if variant == "astype_e4m3":
        w = w.view(torch.float8_e4m3fn)
    x = torch.eye(64, dtype=torch.bfloat16)
    out = tsm.stream_matmul_kernel(x.to(cuda_device), w.to(cuda_device),
                                   variant).float().cpu()
    ref = tsm.stream_matmul_reference(x, w, variant).float()
    value = tsm.dequant(w, variant).to(torch.bfloat16).float()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], value[~nan])
    if variant == "astype_e4m3":
        assert nan[:, 0x7F].all() and nan[:, 0xFF].all()
        assert int(nan.sum()) == 2 * 64
    else:
        assert not nan.any()


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


# ---------------------------------------------------------------------------
# SwiftKV's shapes: the swift half's schedule, the fused KV operand, and
# the model's step with the kernels against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [128, 64])
def test_ragged_kernel_on_the_swift_schedule(cuda_device, d, kv_dtype):
    """The swift half of a mixed step: six requests with one sample row
    and two with four verify rows, on the runner's 8-row schedule over
    the sample rows (``swift_schedule``), padded to 32 rows (padding
    rows are request -1 and come out zero)."""
    from arcticinference_tpu_torch.engine.runner import swift_schedule

    reqs = [(c, 1) for c in (37, 300, 95, 511, 64, 128)] + [(200, 4),
                                                           (77, 4)]
    s_pad = 32
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, s_pad,
                                      d=d)
    pos = np.zeros(s_pad, np.int32)
    req = np.full(s_pad, -1, np.int32)
    t = 0
    for r, (c, n) in enumerate(reqs):
        pos[t:t + n], req[t:t + n] = np.arange(c, c + n), r
        t += n
    sched = swift_schedule([n for _, n in reqs],
                           np.array([c + n - 1 for c, n in reqs]), s_pad, BS)
    sched = tuple(torch.from_numpy(sched[f"swift_{k}"]).to(cuda_device)
                  for k in ("item_req", "item_qstart", "item_qlen",
                            "item_pages", "item_pos_base", "token_item",
                            "token_off"))
    pos_t = torch.from_numpy(pos).to(cuda_device)
    req_t = torch.from_numpy(req).to(cuda_device)
    tra.reset_launch_counts()
    out = tra.ragged_paged_attention_kernel(q, kv, pos_t, req_t, bt, sl,
                                            qb=8, schedule=sched,
                                            kv_scale=scale, layer=1)
    ref = ragged_paged_attention_reference(q, kv[1], pos_t, req_t, bt, sl,
                                           kv_scale=scale[1])
    torch.cuda.synchronize()
    assert tra.ragged_attention_launches == 1
    live = req_t >= 0
    assert_matches(out[live], ref[live])
    assert not out[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 64, 2048])
@pytest.mark.parametrize("mode", ["fp8", "int8"])
def test_fp8_matmul_on_the_fused_swift_kv_operand(cuda_device, mode, m):
    """The stacked per-layer K / V projections fused into one operand
    (per-layer scales as per-column scales): one launch against its
    plain version, and each layer's columns against that layer's own
    product at the same bounds."""
    from arcticinference_tpu_torch.models.llama_swiftkv import fuse_swift_kv

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kb, k, e = 4, 1024, 256
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    wk, wv = (tfp8.quantize_layers(torch.randn(
        (kb, k, e), generator=gen, device=cuda_device), mode)
        for _ in range(2))
    fused = fuse_swift_kv(wk, wv)
    assert fused.weight.shape == (k, 2 * kb * e)
    assert fused.scale.shape == (2 * kb * e,)
    tfm.reset_launch_counts()
    out = tfm.fp8_matmul_kernel(x, fused.weight, fused.scale)
    torch.cuda.synchronize()
    assert tfm.fp8_matmul_launches == 1
    assert_matches(out, tfm.fp8_matmul_reference(x, fused.weight,
                                                 fused.scale))
    for j, part in enumerate([wk[i] for i in range(kb)]
                             + [wv[i] for i in range(kb)]):
        own = tfm.fp8_matmul_kernel(x, part.weight, part.scale)
        assert_matches(out[:, j * e:(j + 1) * e], own)


@pytest.mark.cuda
@pytest.mark.parametrize("quantization", [None, "fp8"])
def test_swiftkv_forward_kernels_match_plain(cuda_device, quantization):
    """A 4-layer SwiftKV (2 + 2) at head dim 128 on the card: a mixed
    step (two prefill chunks, a sample row each, padded sample rows) and
    a decode step through the kernels against the same steps through
    the plain versions: the real sample rows within 2e-2 of the plain
    ones (norm of the difference over the norm: bf16 activations through
    four layers), every row finite, the caches (but block 0, where
    padding rows write) at atol = rtol = 2e-2,
    every kernel launched (the fused KV operand once a step)."""
    from arcticinference_tpu_torch.engine.runner import swift_schedule
    from arcticinference_tpu_torch.models import llama as tllama
    from arcticinference_tpu_torch.models import llama_swiftkv as tsw

    arch = tsw.LlamaSwiftKVArch(
        vocab_size=512, hidden_size=512, intermediate_size=1024,
        num_layers=4, num_heads=4, num_kv_heads=2, head_dim=128,
        num_key_value_layers=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tsw.fuse_params(tsw.init_params(arch, gen, torch.bfloat16,
                                             quantization))
    bt = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
    kv0 = torch.zeros((4, 8, 2, BS, 256), dtype=torch.bfloat16,
                      device=cuda_device)
    caches = {"kernel": kv0.clone(), "plain": kv0.clone()}
    rng = np.random.default_rng(0)
    for reqs, t_pad, attn_qb in (([(0, 70), (0, 40)], 128, 32),
                                 ([(70, 1), (40, 1)], 16, 1)):
        pos = np.zeros(t_pad, np.int32)
        req = np.full(t_pad, -1, np.int32)
        slots = np.full(t_pad, -1, np.int32)
        rows = []
        t = 0
        for r, (c, n) in enumerate(reqs):
            p = np.arange(c, c + n)
            pos[t:t + n], req[t:t + n] = p, r
            slots[t:t + n] = bt.numpy()[r, p // BS] * BS + p % BS
            t += n
            rows.append(t - 1)
        li = np.zeros(16, np.int32)
        li[:2] = rows
        last = np.array([c + n - 1 for c, n in reqs])
        qlens = np.array([n for _, n in reqs])
        sched = tra.build_work_items(qlens, last,
                                     8 if attn_qb == 1 else attn_qb, BS,
                                     t_pad // 8 + 2, t_pad)
        arrays = dict(input_ids=rng.integers(0, 512, t_pad).astype(np.int32),
                      positions=pos, req_idx=req, slot_mapping=slots,
                      block_tables=bt.numpy(), logits_indices=li,
                      seq_lens=last.astype(np.int32) + 1)
        arrays.update(zip(tllama._SCHEDULE_KEYS, sched))
        arrays.update(swift_schedule([1, 1], last, 16, BS))
        inputs = {k: torch.from_numpy(np.array(v)).to(cuda_device)
                  for k, v in arrays.items()}
        out = {}
        for name in ("kernel", "plain"):
            tra.reset_launch_counts()
            tfm.reset_launch_counts()
            saved = tllama.matmul
            if name == "plain":
                tllama.matmul = tfp8.matmul_reference
            try:
                caches[name], out[name] = tsw.forward(
                    params, arch, caches[name], dict(inputs),
                    attn_impl=(tsw.make_attn_impl(attn_qb)
                               if name == "kernel" else tsw.plain_attn))
            finally:
                tllama.matmul = saved
            torch.cuda.synchronize()
            if name == "kernel":
                key = ("grouped_decode_launches" if attn_qb == 1
                       else "ragged_attention_launches")
                assert getattr(tra, key) == 4
                if quantization:
                    # 4 per first-half layer, the KV operand, 4 per
                    # later layer (wq, wo, w_gateup, w_down).
                    assert tfm.fp8_matmul_launches == 4 * 2 + 1 + 4 * 2
        a, b = out["kernel"][:2].float(), out["plain"][:2].float()
        assert torch.isfinite(out["kernel"]).all()
        assert float((a - b).norm() / b.norm()) < 2e-2
        # Block 0 takes the padding rows' writes (slot -1).
        torch.testing.assert_close(caches["kernel"][:, 1:].float(),
                                   caches["plain"][:, 1:].float(),
                                   atol=2e-2, rtol=2e-2)


class _CharTokenizer:
    """ids 0..127 are char codes; tokens past them decode to ""."""

    def __init__(self, vocab):
        self.vocab = [chr(i) for i in range(128)] + [""] * (vocab - 128)

    def __len__(self):
        return len(self.vocab)

    def decode(self, ids, **kw):
        return "".join(self.vocab[i] for i in ids)


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_pipelined_dispatch_has_no_host_sync(cuda_device, guided):
    """A small Llama (head dim 128) generating on the pipelined step:
    every pure-decode dispatch, seeded sampling and (guided) the device
    grammar pool included, and the copy of its output vector, run under
    ``torch.cuda.set_sync_debug_mode("error")``; the guided outputs walk
    their grammar to an accepting state."""
    from arcticinference_tpu_torch.config import EngineConfig
    from arcticinference_tpu_torch.engine import engine as tengine
    from arcticinference_tpu_torch.engine.llm import LLM
    from arcticinference_tpu_torch.engine.request import SamplingParams
    from arcticinference_tpu_torch.serving.structured import (
        make_guided_decoder)

    cfg = EngineConfig.from_dict(dict(
        model=dict(model="llama", max_model_len=512, dtype="bfloat16",
                   hf_overrides=dict(vocab_size=384, hidden_size=256,
                                     intermediate_size=512,
                                     num_hidden_layers=2,
                                     num_attention_heads=2,
                                     num_key_value_heads=1, head_dim=128)),
        cache=dict(num_blocks=64),
        scheduler=dict(max_num_seqs=8, max_num_batched_tokens=256)))
    llm = LLM(cfg)
    eng, runner = llm.engine, llm.engine.runner
    assert eng._pipeline
    tok = _CharTokenizer(384)
    checked = {"dispatches": 0, "guided": 0}
    dispatch, inflight = runner.dispatch, tengine._InflightStep

    def checked_dispatch(si, *a, **k):
        if si.attn_qb != 1:
            return dispatch(si, *a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(si, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked["dispatches"] += 1
        checked["guided"] += "gd_slot" in si.arrays
        return out

    class CheckedInflight(inflight):
        def __init__(self, *a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super().__init__(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    decs = [make_guided_decoder(tok, {"regex": r"\d{4}-\d{2}-\d{2}"})
            if guided and i % 2 else None for i in range(6)]
    runner.dispatch = checked_dispatch
    tengine._InflightStep = CheckedInflight
    try:
        outs = llm.generate(
            prompt_token_ids=[[1 + i, 2, 3] * (5 + i) for i in range(6)],
            sampling_params=[SamplingParams(
                max_tokens=16, temperature=0.8 * (i % 3 > 0),
                seed=i if i % 3 else None, ignore_eos=True, guided=d)
                for i, d in enumerate(decs)])
    finally:
        del runner.dispatch
        tengine._InflightStep = inflight
    assert checked["dispatches"] > 0
    assert (checked["guided"] > 0) == guided
    assert "pipelined" in eng.step_times.summary()
    for o, d in zip(outs, decs):
        if d is None:
            assert len(o.token_ids) == 16
            continue
        st = d.index.dfa.start
        for t in o.token_ids:
            st = d.index.advance(st, t)
        assert d.index.is_accept(st) and o.finish_reason == \
            "finished_stopped"


@pytest.mark.cuda
@pytest.mark.parametrize("v", [139, 128256])
def test_guided_ops_on_the_card_match_cpu(cuda_device, v):
    """``guided_mask_rows``, ``guided_advance`` and ``apply_vocab_mask``
    on the card against the same ops on the CPU, on seeded random pools
    and masks with padding rows: equal, and no host sync on the card."""
    from arcticinference_tpu_torch.ops import guided as tguided
    from arcticinference_tpu_torch.ops import sampling as tsampling
    from arcticinference_tpu_torch.serving.guided_dfa import PAD_CP

    rng = np.random.default_rng(v)
    p, s_pad, i_pad, g, w, lmax = 3, 64, 256, 16, (v + 31) // 32, 32
    masks = rng.integers(-2 ** 31, 2 ** 31, (p, s_pad, w),
                         dtype=np.int64).astype(np.int32)
    keys = np.full((p, i_pad), np.iinfo(np.int32).max, np.int32)
    his = np.full((p, i_pad), -1, np.int32)
    nxt = np.full((p, i_pad), -1, np.int32)
    for slot in range(p):
        st = np.sort(rng.integers(0, 40, 200))
        lo = rng.integers(0, 130, 200)
        order = np.lexsort((lo, st))
        keys[slot, :200] = (st[order] << 21) | lo[order]
        his[slot, :200] = lo[order] + rng.integers(0, 5, 200)
        nxt[slot, :200] = rng.integers(-1, 40, 200)
    cps = rng.integers(0, 130, (v, lmax)).astype(np.int32)
    cps[rng.integers(1, lmax, v)[:, None] <= np.arange(lmax)] = PAD_CP
    states = rng.integers(-1, 42, g).astype(np.int32)
    slots = rng.integers(-1, p, g).astype(np.int32)
    tokens = rng.integers(0, v, g).astype(np.int32)
    logits = rng.normal(0, 2, (32, v)).astype(np.float32)
    rows = np.full(g, -1, np.int32)
    rows[:10] = rng.choice(32, 10, replace=False)
    host = [torch.from_numpy(x) for x in (states, slots, tokens, masks, cps,
                                          keys, his, nxt, logits, rows)]
    dev = [x.to(cuda_device) for x in host]

    def ops(t):
        mask_rows = tguided.guided_mask_rows(t[0], t[1], t[3])
        return (mask_rows,
                tguided.guided_advance(t[0], t[1], t[2], *t[4:8]),
                tsampling.apply_vocab_mask(t[8], t[9], mask_rows))

    want = ops(host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops(dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=0, rtol=0)


def grouped_case(mode, counts, k, n, device, seed=0, r=None):
    """Expert-sorted bf16 rows (``r``, by default 3 past the counts' sum),
    an [E, K, N] expert stack quantized as the Mixtral module quantizes a
    layer (``quantize_experts``) and the int32 offsets of ``counts``
    (summing to at most the rows) on the card."""
    from arcticinference_tpu_torch.models.mixtral import quantize_experts

    gen = torch.Generator(device=device).manual_seed(seed)
    r = max(sum(counts), 1) + 3 if r is None else r
    xs = torch.randn((r, k), generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn((len(counts), k, n), generator=gen, device=device)
    w = w.to(torch.bfloat16)
    q = w if mode == "bf16" else quantize_experts(w, mode)
    return xs, q, grouped_offsets(counts, device)


def grouped_offsets(counts, device):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device=device)


def grouped_launch(xs, q, offsets, fn=tgm.grouped_matmul_kernel):
    if isinstance(q, tfp8.QuantizedLinear):
        return fn(xs, q.weight, q.scale, offsets)
    return fn(xs, q, None, offsets)


def routing_counts(routing, r, e=8, seed=0):
    """Rows per expert of ``r`` rows (chip_smoke.py phase 11's routings):
    uniform, skewed (~70% on one expert), one expert empty, every row on
    one expert."""
    if routing == "one expert":
        return (r,) + (0,) * (e - 1)
    p = np.ones(e) / e
    if routing == "skewed":
        p = np.full(e, 0.3 / (e - 1))
        p[3] = 0.7
    elif routing == "one empty":
        p[5] = 0
        p /= p.sum()
    return tuple(int(c) for c in np.random.default_rng(seed).multinomial(
        r, p))


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["uniform", "skewed", "one empty",
                                     "one expert"])
@pytest.mark.parametrize("rows", [128, 512, 4096])
@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "int4"])
def test_grouped_matmul_kernel_matches_plain(cuda_device, mode, rows,
                                             routing):
    """Decode (128 = 64 x top-2), 512 and a 2048-token chunk x 2 over 8
    experts (the 32-, 128-row and two-warpgroup 128-row tiles); 5 rows
    past the last group are exactly 0."""
    counts = routing_counts(routing, rows - 5, seed=rows)
    xs, q, offsets = grouped_case(mode, counts, 1024, 768, cuda_device,
                                  r=rows)
    tgm.reset_launch_counts()
    out = grouped_launch(xs, q, offsets)
    ref = grouped_launch(xs, q, offsets, tgm.grouped_matmul_reference)
    torch.cuda.synchronize()
    assert tgm.grouped_matmul_launches == 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert_matches(out, ref)
    assert not out[sum(counts):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [(16, 16, 16, 16), (90, 10, 0, 28),
                                    (0, 0, 200, 0), (1, 0, 0, 2),
                                    (40, 40, 40, 0)])
@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "int4"])
def test_grouped_matmul_kernel_at_odd_counts(cuda_device, mode, counts):
    """Tiny and empty groups over 4 experts at the 16-, 64- and 128-row
    tiles, N = 384 (one warpgroup at 128 rows); rows past the last group
    are exactly 0."""
    xs, q, offsets = grouped_case(mode, counts, 512, 384, cuda_device)
    out = grouped_launch(xs, q, offsets)
    ref = grouped_launch(xs, q, offsets, tgm.grouped_matmul_reference)
    torch.cuda.synchronize()
    assert_matches(out, ref)
    assert not out[sum(counts):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128, 4096])
@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "int4"])
def test_grouped_matmul_one_hot_rows_are_exact(cuda_device, mode, rows):
    """x rows one-hot at column k give float(bf16(W[e][k] * scale)): the
    dequantized weight row, bit for bit, and the plain version's.  A
    kernel that scaled the float32 sums instead of the weights would
    differ here by the bf16 rounding of each weight."""
    counts = routing_counts("skewed", rows - 3, seed=rows + 1)
    _, q, offsets = grouped_case(mode, counts, 1024, 768, cuda_device,
                                 r=rows)
    cols = torch.randint(0, 1024, (rows,), generator=torch.Generator(
        ).manual_seed(rows)).to(cuda_device)
    xs = torch.zeros((rows, 1024), dtype=torch.bfloat16, device=cuda_device)
    xs[torch.arange(rows, device=cuda_device), cols] = 1
    out = grouped_launch(xs, q, offsets)
    ref = grouped_launch(xs, q, offsets, tgm.grouped_matmul_reference)
    wd = (tgm.dequantized(q.weight, q.scale)
          if isinstance(q, tfp8.QuantizedLinear) else q).float()
    expert = torch.repeat_interleave(
        torch.arange(8, device=cuda_device),
        torch.tensor(counts, device=cuda_device))
    live = expert.numel()
    want = wd[expert, cols[:live]]
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out[:live], want)
    assert not out[live:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "fp8", "int8", "int4"])
def test_grouped_matmul_rows_are_bitwise_independent(cuda_device, mode):
    """A row's output is the same bits beside other rows and at another
    index of its group; two launches are alike; a CUDA graph captured at
    one routing and replayed at another equals a fresh launch there."""
    counts = (24, 8, 40, 0)
    xs, q, offsets = grouped_case(mode, counts, 1024, 256, cuda_device)
    out = grouped_launch(xs, q, offsets)
    xs2 = torch.randn_like(xs.float()).to(torch.bfloat16)
    moves = {0: 17, 5: 23, 30: 24, 70: 41}     # within each row's group
    for j, j2 in moves.items():
        xs2[j2] = xs[j]
    out2 = grouped_launch(xs2, q, offsets)
    again = grouped_launch(xs, q, offsets)
    routed = offsets.clone()
    graph = torch.cuda.CUDAGraph()
    grouped_launch(xs, q, routed)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        captured = grouped_launch(xs, q, routed)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, out)
    other = grouped_offsets((5, 50, 0, 18), cuda_device)
    routed.copy_(other)
    graph.replay()
    fresh = grouped_launch(xs, q, other)
    torch.cuda.synchronize()
    for j, j2 in moves.items():
        assert torch.equal(out2[j2], out[j])
    assert torch.equal(again, out)
    assert torch.equal(captured, fresh)
    assert_matches(fresh, grouped_launch(xs, q, other,
                                         tgm.grouped_matmul_reference))


@pytest.mark.cuda
def test_grouped_matmul_refuses_what_it_does_not_take(cuda_device):
    xs, q, offsets = grouped_case("bf16", (8, 8), 128, 128, cuda_device)
    with pytest.raises(TypeError):
        tgm.grouped_matmul_kernel(xs.float(), q, None, offsets)
    with pytest.raises(ValueError):
        tgm.grouped_matmul_kernel(xs, q, None, offsets.long())
    with pytest.raises(ValueError):
        tgm.grouped_matmul_kernel(xs, q[:, :, :64], None, offsets)
    with pytest.raises(TypeError):
        tgm.grouped_matmul_kernel(xs, q.float(), None, offsets)
    with pytest.raises(ValueError):
        tgm.grouped_matmul_kernel(xs[:, :96].contiguous(), q[:, :96]
                                  .contiguous(), None, offsets)


# A mesh rank's shapes (``arcticinference_tpu_torch/parallel/``):
# Llama-3.1-8B's attention heads per rank (Hq, Hkv) over tp 2 and over
# sp 2 x tp 2, and its weights as the ranks hold them (K, N): the tp 2
# pieces of wqkv, w_gateup, wo, w_down and the LM head, then the fused
# sp 2 x tp 2 pieces of the shift program.
SHARD_HEADS = [(16, 4), (8, 2)]
SHARD_SHAPES = [(4096, 3072), (4096, 14336), (2048, 4096), (7168, 4096),
                (4096, 64128), (4096, 1536), (4096, 7168), (1024, 4096),
                (3584, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("hq,hkv", SHARD_HEADS)
def test_attention_kernels_at_shard_heads(cuda_device, hq, hkv, kv_dtype):
    """Kernel 1 on prefill chunks beside decode rows (an SP step: the
    whole token batch at a rank's heads) and kernel 2 on a decode step
    (a shift step), against the plain version."""
    reqs = [(0, 100), (300, 40), (1000, 1), (77, 1)]
    t_pad = 256
    q, kv, scale, bt, sl = paged_case(reqs, kv_dtype, cuda_device, t_pad,
                                      hq=hq, hkv=hkv)
    pos, req = ragged_rows(reqs, t_pad, cuda_device)
    ref = ragged_paged_attention_reference(q, kv[1], pos, req, bt, sl,
                                           kv_scale=scale[1])
    live = req >= 0
    for qb in (8, 32):
        out = tra.ragged_paged_attention_kernel(
            q, kv, pos, req, bt, sl, qb=qb, kv_scale=scale, layer=1)
        torch.cuda.synchronize()
        assert_matches(out[live], ref[live])
    q, kv, scale, bt, sl, _ = uniform_step(
        [30, 1000, 4093, 509, 0, 62, 2000, 7], 1, kv_dtype, cuda_device,
        hq=hq, hkv=hkv)
    pb = torch.clamp(sl - 1, min=0)
    ref = tra.grouped_decode_attention_kernel(
        q.cpu(), kv.cpu(), pb.cpu(), bt.cpu(), sl.cpu(), qlen=1,
        kv_scale=scale.cpu(), layer=1)
    out = tra.grouped_decode_attention_kernel(q, kv, pb, bt, sl, qlen=1,
                                              kv_scale=scale, layer=1)
    torch.cuda.synchronize()
    assert_matches(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 1024])
@pytest.mark.parametrize("k,n", SHARD_SHAPES)
def test_fp8_matmul_kernel_at_shard_shapes(cuda_device, k, n, m):
    if m > 16 and n > 60000:
        pytest.skip("the LM head sees only the sample rows")
    x, q = quantized_case("fp8", m, k, n, cuda_device, per_column=n < 60000)
    out_dtype = torch.float32 if n > 60000 else torch.bfloat16
    out = tfm.fp8_matmul_kernel(x, q.weight, q.scale, out_dtype)
    ref = tfm.fp8_matmul_reference(x, q.weight, q.scale, out_dtype)
    torch.cuda.synchronize()
    assert_matches(out, ref)


def _mesh_prompt_logits(prompt):
    """A rank of a tp 2 world on cuda:0 (or the single device, outside a
    world): the prompt's logits through the port's engine, fp8 weights,
    with the attention and matmul kernels' launches."""
    from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                                  ModelConfig,
                                                  ParallelConfig)
    from arcticinference_tpu_torch.engine.llm import LLM

    import torch.distributed as dist

    par = (dict(tensor_parallel_size=dist.get_world_size())
           if dist.is_initialized() else {})
    cfg = EngineConfig(
        model=ModelConfig(model="llama", dtype="bfloat16",
                          max_model_len=512, quantization="fp8",
                          hf_overrides=dict(
                              vocab_size=4096, hidden_size=1024,
                              intermediate_size=2048, num_hidden_layers=2,
                              num_attention_heads=8, num_key_value_heads=4,
                              head_dim=128)),
        cache=CacheConfig(num_blocks=64),
        parallel=ParallelConfig(**par))
    llm = LLM(cfg, device="cuda:0")
    tra.reset_launch_counts()
    tfm.reset_launch_counts()
    logits = llm.engine.prompt_logits(prompt)
    torch.cuda.synchronize()
    return logits, tra.ragged_attention_launches, tfm.fp8_matmul_launches


@pytest.mark.cuda
def test_tp2_world_on_one_card_matches_single(cuda_device):
    """Two ranks sharing cuda:0 over gloo (``parallel.world``): each
    rank's prompt logits equal the other's bit for bit and the single
    device's within the bf16 forward's tolerance, through kernels 1 and
    5 on every rank."""
    from arcticinference_tpu_torch.parallel.world import spawn

    prompt = [int(t) for t in np.random.default_rng(7).integers(
        0, 4096, 200)]
    want, _, _ = _mesh_prompt_logits(prompt)
    ranks = spawn(_mesh_prompt_logits, 2, args=(prompt,), backend="gloo",
                  timeout_s=300)
    for got, attn, mm in ranks:
        assert np.array_equal(got, ranks[0][0])
        assert attn > 0 and mm > 0
        diff = np.abs(got - want).max()
        assert diff <= 0.05 * np.abs(want).max(), diff
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree >= 0.95, agree
