"""Weight-only fp8 / int8 matmul on the card: wrapper of the CUDA kernel
in ``csrc/fp8_matmul.cu``.

:func:`fp8_matmul_kernel` replaces
``arcticinference_tpu/ops/pallas/fp8_matmul.py::fp8_matmul_kernel``:
``(x_bf16 @ bf16(w)) * scale`` with float32 sums, for e4m3 or int8
weights ``[K, N]`` and a scalar or per-output-column float32 scale (the
JAX package's ``matmul`` computes both; the TPU kernel took only the
scalar).  It is bound by the weight bytes at decode and by the bf16
products at prefill; the source notes in ``fp8_matmul.cu`` and
``quant_wgmma.cuh`` say what the design does about each.  Its launch
plan, :func:`launch_plan`, is a pure function of the shapes and the SM
count.

Given CPU tensors the wrapper computes the plain version
(:func:`fp8_matmul_reference`, the JAX package's CPU function); given
CUDA tensors it launches the kernel and raises on anything the kernel
does not take.  Each launch adds one to ``fp8_matmul_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SOURCE = "fp8_matmul.cu"

#: Kernel launches since the last :func:`reset_launch_counts`.
fp8_matmul_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 10 + [_P]

# Tiles of csrc/quant_wgmma.cuh: weight columns per consumer warpgroup
# (N must be a multiple), weight rows per pipeline stage (K must be a
# multiple) and x rows per CTA by bucket of M.
BN, BKW = 128, 64
ROW_TILES = (16, 32, 64, 128)
# The largest K split, a cluster of 3 CTAs: on an H100 SXM (132 SMs)
# 4-CTA clusters of one-CTA-per-SM blocks fit only ~120 SMs at once, so
# the rest ran in a second wave (PERF.md, the plan sweep).
MAX_SPLITS = 3
# Stages a warpgroup streams at least: the pipeline's ramp is a few.
MIN_SPLIT_STAGES = 4
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_SCALE_SCALAR, _SCALE_COLUMN = 1, 2
_SM_COUNT: dict[int, int] = {}


def reset_launch_counts() -> None:
    global fp8_matmul_launches
    fp8_matmul_launches = 0


def fp8_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version: ``x`` rounded to bf16, ``w`` (e4m3 or int8, exact
    in bf16 and float32) widened, float32 products and sums, times the
    scalar or per-column scale, cast to ``out_dtype`` (default
    ``x.dtype``), as the JAX package's ``matmul`` on its CPU path."""
    out_dtype = out_dtype or x.dtype
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    if scale.dim() == w.dim() - 1 and scale.shape[-1] == w.shape[-1]:
        return (y * scale).to(out_dtype)
    return (y * scale.reshape(())).to(out_dtype)


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.fp8_matmul_launch.argtypes is None:
        lib.fp8_matmul_launch.argtypes = _ARGTYPES
        lib.fp8_matmul_launch.restype = _I
    return lib


def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device`` (cached)."""
    sms = _SM_COUNT.get(device)
    if sms is None:
        sms = _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def launch_plan(m: int, n: int, k_tiles: int,
                sms: int) -> tuple[int, int, int, int]:
    """(x rows per CTA, warpgroups along N, warpgroups along K, K splits)
    for an ``[m, n]`` output over ``k_tiles`` weight stages on a card of
    ``sms`` SMs.

    Rows: 16, 32, 64, else 128 per CTA (wgmma's N).  At 128 rows, when
    the 256-column tiles give half the SMs a CTA or more, two warpgroups
    side by side share each x tile.  Else a grid of 128-column tiles that
    fills the SMs runs one warpgroup per CTA (two CTAs per SM up to 64
    rows).  A smaller grid gives each CTA two warpgroups that take
    alternate K stages and splits K over up to :data:`MAX_SPLITS` CTAs of
    one cluster while the grid fits the SMs once, with
    :data:`MIN_SPLIT_STAGES` stages per warpgroup and every split
    non-empty.  The plan depends on nothing but (the bucket of m, n,
    k_tiles, sms).
    """
    bm = next((b for b in ROW_TILES if m <= b), ROW_TILES[-1])
    tiles = -(-m // bm)
    if bm == ROW_TILES[-1] and n % (2 * BN) == 0 and \
            2 * tiles * (n // (2 * BN)) >= sms:
        return bm, 2, 1, 1
    ctas = tiles * (n // BN)
    if ctas >= sms:
        return bm, 1, 1, 1
    splits = max(1, min(sms // ctas, k_tiles // (2 * MIN_SPLIT_STAGES),
                        MAX_SPLITS))
    per = -(-k_tiles // splits)
    return bm, 1, 2, -(-k_tiles // per)


def check_operands(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype, k: int) -> None:
    """Raise on anything the quantized matmul kernels do not take (shared
    by both wrappers; ``k`` is the unpacked K).  Called once per layer
    and matmul of a step, so it compares device indices, not devices."""
    dev = x.get_device()
    if dev < 0 or w.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, weight and scale must be on the same CUDA "
                         "device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x dtype {x.dtype} not supported (bf16 or f32, "
                        "taken as bf16)")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale dtype {scale.dtype} not supported "
                        "(float32)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out dtype {out_dtype} not supported "
                        f"(one of {_OUT_DTYPES})")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"need x [M, K] and a 2-D weight for K={k}; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if w.shape[1] % BN:
        raise ValueError(f"N={w.shape[1]} must be a multiple of {BN}")
    if not (x.is_contiguous() and w.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, weight and scale must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and weight must be 16-byte aligned")
    # A scalar scale is one float (a layer's entry of a stacked [L]
    # scale); vectors of scales are read 16 bytes at a time.
    if scale.data_ptr() % (4 if scale.numel() == 1 else 16):
        raise ValueError("scale vectors must be 16-byte aligned")


def _stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device``, as the raw
    handle (without building a ``torch.cuda.Stream`` on every call)."""
    return torch._C._cuda_getCurrentRawStream(device)


def fp8_matmul_kernel(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """``(bf16(x) @ bf16(w)) * scale`` with float32 sums.

    x: [M, K] bf16 (float32 is rounded to bf16 first, as the JAX function
    does); w: [K, N] float8_e4m3fn or int8; scale: float32 scalar (one
    element) or [N]; K a multiple of 64 and N of 128 on the card.
    """
    global fp8_matmul_launches
    if not x.is_cuda:
        return fp8_matmul_reference(x, w, scale, out_dtype)
    k = x.shape[-1]
    check_operands(x, w, scale, out_dtype, k)
    if w.dtype not in (torch.float8_e4m3fn, torch.int8):
        raise TypeError(f"weight dtype {w.dtype} not supported "
                        "(float8_e4m3fn or int8)")
    if k % BKW:
        raise ValueError(f"K={k} must be a multiple of {BKW}")
    n = w.shape[1]
    if scale.numel() == 1:
        mode = _SCALE_SCALAR
    elif scale.dim() == 1 and scale.shape[0] == n:
        mode = _SCALE_COLUMN
    else:
        raise ValueError(f"scale {tuple(scale.shape)} is neither a scalar "
                         f"nor per column of N={n}")
    x = x.to(torch.bfloat16)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    dev = x.get_device()
    rc = _lib().fp8_matmul_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n,
        k, int(w.dtype == torch.int8), mode, int(out_dtype == torch.float32),
        *launch_plan(m, n, k // BKW, sm_count(dev)), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fp8_matmul_launch failed: CUDA error {rc}")
    fp8_matmul_launches += 1
    return out
