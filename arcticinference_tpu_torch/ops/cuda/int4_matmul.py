"""Weight-only int4 matmul on the card: wrapper of the CUDA kernel in
``csrc/int4_matmul.cu``.

:func:`int4_matmul_kernel` replaces
``arcticinference_tpu/ops/pallas/int4_matmul.py::int4_matmul_kernel``:
``x @ dequant(w)`` for a split-half packed int4 weight ``[K/2, N]`` (byte
row ``u`` holds row ``u`` in its low nibble and row ``u + K/2`` in its
high nibble) with group-128 float32 scales ``[K/128, N]``.  Its plain
version is :func:`int4_matmul_reference`, the JAX package's oracle of the
same name and its CPU path: dequantize to bf16 (``bf16(q * s)``), then
bf16 products with float32 sums.  The kernel computes that same function
(it folds the scale into the bf16 weight value), where the TPU kernel
scaled its float32 partial sums.

Given CPU tensors the wrapper computes the plain version; given CUDA
tensors it launches the kernel and raises on anything the kernel does not
take.  Each launch adds one to ``int4_matmul_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from arcticinference_tpu_torch.ops.cuda.fp8_matmul import (
    BKW, BN, _stream, check_operands, launch_plan, sm_count)

SOURCE = "int4_matmul.cu"
GROUP = 128  # quantization group size along the (unpacked) input dim

#: Kernel launches since the last :func:`reset_launch_counts`.
int4_matmul_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]


def reset_launch_counts() -> None:
    global int4_matmul_launches
    int4_matmul_launches = 0


def int4_shapes_ok(k: int, n: int) -> bool:
    """True when the CUDA kernel takes an unpacked ``[k, n]`` weight:
    every weight ``int_quantize`` packs (K a multiple of the 128-row
    group) with N a multiple of its 128-column tile."""
    return k % (2 * BKW) == 0 and k % GROUP == 0 and n % BN == 0


def int4_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Plain version: explicit unpack, group dequant to bf16, then bf16
    products with float32 sums, cast to ``out_dtype``."""
    from arcticinference_tpu_torch.ops.fp8 import _unpack_int4

    k = w_packed.shape[-2] * 2
    n = w_packed.shape[-1]
    w4 = _unpack_int4(w_packed).float()
    wg = w4.reshape(scale.shape[-2], k // scale.shape[-2], n)
    wd = (wg * scale[:, None, :]).reshape(k, n).to(torch.bfloat16)
    y = torch.matmul(x.to(torch.bfloat16).float(), wd.float())
    return y.to(out_dtype)


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.int4_matmul_launch.argtypes is None:
        lib.int4_matmul_launch.argtypes = _ARGTYPES
        lib.int4_matmul_launch.restype = _I
    return lib


def int4_matmul_kernel(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """``x @ dequant(w)`` with split-half packed int4 ``w``.

    x: [M, K] bf16 (float32 is rounded to bf16 first); w_packed: [K/2, N]
    int8; scale: [K/128, N] float32; on the card K a multiple of 128 and
    N of 128 (:func:`int4_shapes_ok`).
    """
    global int4_matmul_launches
    if not x.is_cuda:
        return int4_matmul_reference(x, w_packed, scale, out_dtype)
    k = x.shape[-1]
    check_operands(x, w_packed, scale, out_dtype, 2 * w_packed.shape[0])
    if w_packed.dtype != torch.int8:
        raise TypeError(f"packed weight dtype {w_packed.dtype} not "
                        "supported (int8 nibble pairs)")
    n = w_packed.shape[1]
    if not int4_shapes_ok(k, n):
        raise ValueError(f"int4 weight [{k}, {n}] not supported: K must be "
                         f"a multiple of {GROUP}, N of {BN}")
    if tuple(scale.shape) != (k // GROUP, n):
        raise ValueError(f"scale {tuple(scale.shape)} is not the "
                         f"[K/{GROUP}, N] = {(k // GROUP, n)} group scale")
    x = x.to(torch.bfloat16)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    dev = x.get_device()
    rc = _lib().int4_matmul_launch(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, n, k, int(out_dtype == torch.float32),
        *launch_plan(m, n, k // 2 // BKW, sm_count(dev)), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"int4_matmul_launch failed: CUDA error {rc}")
    int4_matmul_launches += 1
    return out
