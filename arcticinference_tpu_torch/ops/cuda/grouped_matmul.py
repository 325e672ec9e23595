"""Grouped matmul over expert-sorted rows on the card: wrapper of the CUDA
kernel in ``csrc/grouped_matmul.cu``.

:func:`grouped_matmul_kernel` is the port's counterpart of the XLA op
``jax.lax.ragged_dot`` as ``arcticinference_tpu/models/mixtral.py``
(``_moe_mlp``) calls it, over expert stacks that ``_deq`` dequantized to
bf16 first: ``out[r] = float32(xs[r] @ deq(W[e]))`` for the rows
``offsets[e] : offsets[e + 1]`` of expert ``e``, and 0 for the rows past
``offsets[E]``.  It replaces no ``pallas_call``.  The offsets are an
int32 ``[E + 1]`` tensor on the device (``offsets[0]`` is 0), so the step
reads nothing back to size the launch.

Weights are ``[E, K, N]`` bf16, e4m3 with one float32 scale, int8 with
per-column scales ``[E, N]``, or int4 packed split-half ``[E, K/2, N]``
with group-128 scales ``[E, K/128, N]``: the layouts ``ops/fp8.py``
gives an expert stack (``models/mixtral.quantize_experts``).  Each weight
element is dequantized to bf16 (``bf16(float(w) * scale)``) before the
product, as the JAX function does; the sums are float32.

The launch plan (:func:`launch_plan`) is a pure function of ``(R, E, N)``:
the rows per CTA (wgmma's N), one or two consumer warpgroups, and
``ceil(R / BM) + E`` row tiles by ``N / BN`` column tiles.  Each CTA
finds its expert and rows from ``offsets`` (:func:`tile_map` is the same
walk on the host, for the tests).  The kernel runs on ``wgmma`` with TMA
loads (``csrc/grouped_matmul.cu`` over ``csrc/quant_wgmma.cuh``); K is
never split, so each row's sums run in one order whatever the plan.

Given CPU tensors the wrapper computes the plain version
(:func:`grouped_matmul_reference`); given CUDA tensors it launches the
kernel and raises on anything the kernel does not take.  Each launch adds
one to ``grouped_matmul_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SOURCE = "grouped_matmul.cu"

#: Kernel launches since the last :func:`reset_launch_counts`.
grouped_matmul_launches = 0

BN = 128            # weight columns per consumer warpgroup (N a multiple)
KS = 64             # weight rows per pipeline stage (K must be a multiple)
GROUP = 128         # int4 group (packed int4 needs K a multiple of 128)
ROW_TILES = (16, 32, 64, 128)
MAX_EXPERTS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]

_BF16, _E4M3, _INT8, _INT4 = 0, 1, 2, 3


def reset_launch_counts() -> None:
    global grouped_matmul_launches
    grouped_matmul_launches = 0


def launch_plan(r: int, e: int, n: int) -> tuple[int, int, int, int]:
    """(rows per tile, consumer warpgroups, row tiles, column tiles) of an
    ``[r, n]`` output over ``e`` experts.  The row tile is the smallest of
    :data:`ROW_TILES` that holds twice the mean group (``r / e``), so a
    decode step's groups take one tile each and a prefill chunk's few
    large ones; ``ceil(r / bm) + e`` tiles cover any split of ``r`` rows
    into ``e`` groups plus the zeroed rest.  At 128 rows two warpgroups
    side by side share each x tile (256 columns a CTA) where ``n``
    allows it; else one warpgroup takes 128 columns.  Nothing but the
    three sizes enters: no routing, and no K split."""
    mean = -(-r // e)
    bm = next((b for b in ROW_TILES if b >= 2 * mean), ROW_TILES[-1])
    wgs = 2 if bm == ROW_TILES[-1] and n % (2 * BN) == 0 else 1
    return bm, wgs, -(-r // bm) + e, n // (wgs * BN)


def clamped_offsets(offsets: list[int], r: int) -> list[int]:
    """The group bounds the kernel reads: ``offsets[0]`` taken as 0, the
    rest made non-decreasing and at most ``r``."""
    out = [0]
    for o in offsets[1:]:
        out.append(min(max(int(o), out[-1]), r))
    return out


def tile_map(offsets: list[int], r: int, bm: int,
             row_tiles: int) -> list[tuple[str, int, int, int]]:
    """The kernel's walk on the host: for each row tile, ``("mma",
    expert, row0, rows)``, ``("zero", -1, row0, rows)`` for rows past the
    last group, or ``("exit", -1, 0, 0)``."""
    bounds = clamped_offsets(offsets, r)
    tiles = []
    for t in range(row_tiles):
        cum = 0
        for e in range(len(bounds) - 1):
            a, b = bounds[e], bounds[e + 1]
            n_t = -(-(b - a) // bm)
            if t < cum + n_t:
                row0 = a + (t - cum) * bm
                tiles.append(("mma", e, row0, min(bm, b - row0)))
                break
            cum += n_t
        else:
            row0 = bounds[-1] + (t - cum) * bm
            tiles.append(("zero", -1, row0, min(bm, r - row0))
                         if row0 < r else ("exit", -1, 0, 0))
    return tiles


def dequantized(w: torch.Tensor, scale: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The expert stack as the products read it: ``w`` itself when
    unquantized, else ``fp8_dequantize`` to bf16."""
    if scale is None:
        return w
    from arcticinference_tpu_torch.ops.fp8 import (QuantizedLinear,
                                                   fp8_dequantize)

    return fp8_dequantize(QuantizedLinear(w, scale), torch.bfloat16)


def grouped_matmul_reference(xs: torch.Tensor, w: torch.Tensor,
                             scale: Optional[torch.Tensor],
                             offsets: torch.Tensor) -> torch.Tensor:
    """Plain version, the JAX function on its CPU path: dequantize the
    stack (:func:`dequantized`), then per expert ``xs[a:b].float() @
    W[e].float()``; rows outside every group are 0.  It reads the
    offsets on the host."""
    r = xs.shape[0]
    wd = dequantized(w, scale)
    out = torch.zeros((r, wd.shape[-1]), dtype=torch.float32,
                      device=xs.device)
    bounds = clamped_offsets(offsets.tolist(), r)
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = torch.matmul(xs[a:b].float(), wd[e].float())
    return out


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.grouped_matmul_launch.argtypes is None:
        lib.grouped_matmul_launch.argtypes = _ARGTYPES
        lib.grouped_matmul_launch.restype = _I
    return lib


def weight_format(w: torch.Tensor, scale: Optional[torch.Tensor]
                  ) -> tuple[int, int]:
    """(weight format, unpacked K) of an expert stack the kernel takes;
    raises on any other."""
    if w.dim() != 3:
        raise ValueError(f"need an [E, K, N] expert stack, got "
                         f"{tuple(w.shape)}")
    e, k, n = w.shape
    if scale is None:
        if w.dtype != torch.bfloat16:
            raise TypeError(f"unquantized weight dtype {w.dtype} not "
                            "supported (bfloat16)")
        return _BF16, k
    if scale.dtype != torch.float32:
        raise TypeError(f"scale dtype {scale.dtype} not supported "
                        "(float32)")
    if w.dtype == torch.float8_e4m3fn and scale.numel() == 1:
        return _E4M3, k
    if w.dtype == torch.int8 and tuple(scale.shape) == (e, n):
        return _INT8, k
    if w.dtype == torch.int8 and tuple(scale.shape) == (
            e, 2 * k // GROUP, n) and (2 * k) % GROUP == 0:
        return _INT4, 2 * k
    raise ValueError(
        f"weight {tuple(w.shape)} {w.dtype} with scale "
        f"{tuple(scale.shape)} is none of: e4m3 with one scale, int8 with "
        f"[E, N] scales, packed int4 [E, K/2, N] with [E, K/{GROUP}, N]")


def grouped_matmul_kernel(xs: torch.Tensor, w: torch.Tensor,
                          scale: Optional[torch.Tensor],
                          offsets: torch.Tensor) -> torch.Tensor:
    """``float32(xs[r] @ deq(w[e]))`` over the groups of ``offsets``.

    xs: [R, K] bf16 rows sorted by expert; w: [E, K, N] (see the module
    note); offsets: int32 [E + 1] on the same device.  Returns [R, N]
    float32; rows past ``offsets[E]`` are 0.  On the card N must be a
    multiple of 128 and K of 64 (packed int4: of 128).
    """
    global grouped_matmul_launches
    if not xs.is_cuda:
        return grouped_matmul_reference(xs, w, scale, offsets)
    fmt, k = weight_format(w, scale)
    e, n = w.shape[0], w.shape[2]
    dev = xs.get_device()
    if w.get_device() != dev or offsets.get_device() != dev or (
            scale is not None and scale.get_device() != dev):
        raise ValueError("xs, weight, scale and offsets must be on the same "
                         "CUDA device")
    if xs.dtype != torch.bfloat16:
        raise TypeError(f"xs dtype {xs.dtype} not supported (bfloat16)")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (e + 1,):
        raise ValueError(f"offsets must be int32 [{e + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if xs.dim() != 2 or xs.shape[1] != k:
        raise ValueError(f"need xs [R, {k}], got {tuple(xs.shape)}")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"{e} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if n % BN or k % (GROUP if fmt == _INT4 else KS):
        raise ValueError(f"N={n} must be a multiple of {BN} and K={k} of "
                         f"{GROUP if fmt == _INT4 else KS}")
    if not (xs.is_contiguous() and w.is_contiguous()
            and offsets.is_contiguous()
            and (scale is None or scale.is_contiguous())):
        raise ValueError("xs, weight, scale and offsets must be contiguous")
    if xs.data_ptr() % 16 or w.data_ptr() % 16 or (
            fmt in (_INT8, _INT4) and scale.data_ptr() % 16):
        raise ValueError("xs, weight and scale vectors must be 16-byte "
                         "aligned")
    r = xs.shape[0]
    out = torch.empty((r, n), dtype=torch.float32, device=xs.device)
    if r == 0:
        return out
    bm, wgs, row_tiles, _ = launch_plan(r, e, n)
    rc = _lib().grouped_matmul_launch(
        xs.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), r, e, n, k, fmt, bm, wgs, row_tiles,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_launch failed: CUDA error {rc}")
    grouped_matmul_launches += 1
    return out
