"""Decode weight-stream matmul variants on the card: wrapper of the CUDA
kernel in ``csrc/stream_matmul.cu``.

:func:`stream_matmul_kernel` replaces
``benchmarks/stream_microbench.py::make_pallas_body`` (the
``pallas_call`` at ``stream_microbench.py:167``) and its three kernel
bodies: ``bf16(x[M, K] @ dequant(w[K, N]))`` with float32 sums and no
scale, the weight bytes dequantized one of four ways (:data:`VARIANTS`):

- ``f16trick``: e4m3 bit patterns in an int8 tensor, through the f16
  shift-and-scale (``_mm_kernel_f16trick``);
- ``bittrick``: the same bytes through i32 bit surgery with a select for
  subnormals (``_mm_kernel_bittrick_i32``);
- ``astype_e4m3``: a ``float8_e4m3fn`` tensor converted as it is
  (``_mm_kernel_astype``);
- ``astype_int8``: int8 values converted as they are (the same body).

The two tricks map e4m3's NaN codes (0x7f, 0xff) to +-480; ``astype``
gives NaN.  The weights of the microbench never hold those codes.

The kernel runs the wgmma pipeline of the quantized matmuls (kernels 5
and 6, ``csrc/quant_wgmma.cuh``) with no scale, on kernel 5's launch plan
(:func:`plan`): split K is summed on chip, with no workspace.

Given CPU tensors the wrapper computes the plain version
(:func:`stream_matmul_reference`); given CUDA tensors it launches the
kernel and raises on anything the kernel does not take.  Each launch adds
one to ``stream_matmul_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from arcticinference_tpu_torch.ops.cuda import fp8_matmul as fm

SOURCE = "stream_matmul.cu"

#: Dequantization variants, in the C entry's numbering.
VARIANTS = ("f16trick", "bittrick", "astype_e4m3", "astype_int8")
#: The weight dtype each variant takes.
WEIGHT_DTYPES = {"f16trick": torch.int8, "bittrick": torch.int8,
                 "astype_e4m3": torch.float8_e4m3fn,
                 "astype_int8": torch.int8}

#: Kernel launches since the last :func:`reset_launch_counts`.
stream_matmul_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    global stream_matmul_launches
    stream_matmul_launches = 0


def _bytes(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint8).to(torch.int64)


def dequant_f16trick(w: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes -> float32 through the f16 bit pattern ``(sign << 15) |
    (mag << 7)`` times 2^8."""
    u = _bytes(w)
    h = ((u & 0x80) << 8) | ((u & 0x7F) << 7)
    h = torch.where(h >= 1 << 15, h - (1 << 16), h)    # as int16 bits
    return h.to(torch.int16).view(torch.float16).float() * 256.0


def dequant_bittrick(w: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes -> float32 through the bits ``sign << 31 | ((mag << 20)
    + (120 << 23))``, subnormals (mag < 8) as ``mag * 2^-9``."""
    u = _bytes(w)
    mag = u & 0x7F
    bits = ((u & 0x80) << 24) | ((mag << 20) + (120 << 23))
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    normal = bits.to(torch.int32).view(torch.float32)
    sub = torch.where(u >= 0x80, -1.0, 1.0) * (mag.float() * 2.0 ** -9)
    return torch.where(mag < 8, sub, normal)


def dequant(w: torch.Tensor, variant: str) -> torch.Tensor:
    """The variant's float32 value of every weight element."""
    if variant == "f16trick":
        return dequant_f16trick(w)
    if variant == "bittrick":
        return dequant_bittrick(w)
    if variant in ("astype_e4m3", "astype_int8"):
        return w.float()
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def stream_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                            variant: str) -> torch.Tensor:
    """Plain version: float32 products of bf16 ``x`` and the dequantized
    weight (exact in bf16), float32 sums, rounded to bf16."""
    wt = dequant(w, variant).to(torch.bfloat16).float()
    return torch.matmul(x.to(torch.bfloat16).float(), wt).to(torch.bfloat16)


def plan(m: int, n: int, k: int, sms: int) -> tuple[int, int, int, int]:
    """The launch plan of an ``[m, k] @ [k, n]`` product on a card of
    ``sms`` SMs: kernel 5's (:func:`fp8_matmul.launch_plan`), whose
    pipeline this kernel runs."""
    return fm.launch_plan(m, n, k // fm.BKW, sms)


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.stream_matmul_launch.argtypes is None:
        lib.stream_matmul_launch.argtypes = [_P] * 3 + [_I] * 8 + [_P]
        lib.stream_matmul_launch.restype = _I
    return lib


def stream_matmul_kernel(x: torch.Tensor, w: torch.Tensor,
                         variant: str) -> torch.Tensor:
    """``bf16(x @ dequant(w))`` with float32 sums.

    x: [M, K] bf16; w: [K, N] of the variant's dtype
    (:data:`WEIGHT_DTYPES`); on the card K a multiple of 64 and N of 128,
    both contiguous and 16-byte aligned.
    """
    global stream_matmul_launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if not x.is_cuda:
        return stream_matmul_reference(x, w, variant)
    if w.dtype != WEIGHT_DTYPES[variant]:
        raise TypeError(f"variant {variant} takes {WEIGHT_DTYPES[variant]} "
                        f"weights, not {w.dtype}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x dtype {x.dtype} not supported (bfloat16)")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x [M, K] and w [K, N]; got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if x.get_device() != w.get_device():
        raise ValueError("x and w must be on the same CUDA device")
    m, k = x.shape
    n = w.shape[1]
    if k % fm.BKW or n % fm.BN:
        raise ValueError(f"K={k} must be a multiple of {fm.BKW} and N={n} "
                         f"of {fm.BN}")
    if not (x.is_contiguous() and w.is_contiguous()) or \
            x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    dev = x.get_device()
    rc = _lib().stream_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        VARIANTS.index(variant), *plan(m, n, k, fm.sm_count(dev)),
        fm._stream(dev))
    if rc != 0:
        raise RuntimeError(f"stream_matmul_launch failed: CUDA error {rc}")
    stream_matmul_launches += 1
    return out
