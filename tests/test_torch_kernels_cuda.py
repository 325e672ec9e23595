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
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.ops.attention import (
    ragged_paged_attention_reference)
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.ops.cuda import fp8_matmul as tfm
from arcticinference_tpu_torch.ops.cuda import int4_matmul as tim
from arcticinference_tpu_torch.ops.cuda import ragged_attention as tra

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
@pytest.mark.parametrize("qlen,t_rows", [(1, 16), (1, 2), (3, 12)])
@pytest.mark.parametrize("d", [128, 64])
def test_grouped_kernel_matches_plain(cuda_device, d, qlen, t_rows,
                                      kv_dtype):
    """Dead slot 1; the token bucket wider (16 rows for 4 slots) and
    narrower (2 rows) than B * qlen."""
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
@pytest.mark.parametrize("m", [1, 16, 40, 200])
@pytest.mark.parametrize("mode,per_column", [
    ("fp8", False), ("fp8", True), ("int8", False)])
def test_fp8_matmul_kernel_matches_plain(cuda_device, mode, per_column, m,
                                         out_dtype):
    """M=1..200 covers one to eight m16 tiles per CTA, padded rows and
    split K (small grids) and no split."""
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
@pytest.mark.parametrize("m", [1, 16, 40, 200])
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
    assert tfm.launch_plan(16, 512, 4096 // 64, x.get_device())[1] > 1
    assert torch.equal(a, b)


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
