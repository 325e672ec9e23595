"""Weight-only quantized linear layers (fp8 e4m3, int8, int4) and the
matmul that takes them.

Counterpart of ``arcticinference_tpu/ops/fp8.py``.  The quantizers give the
JAX package's bytes and scales exactly: the same float32 division, clamp
and round-to-nearest-even.  The scale granularity is encoded in the
scale's rank relative to the weight's, as there:

- fp8: per tensor, or per layer for stacked ``[L, in, out]`` weights;
- int8: per output channel (``[.., out]``);
- int4: per group of 128 input rows and output channel
  (``[.., in/128, out]``), two values per byte, SPLIT-HALF packed: byte
  row ``u`` holds row ``u`` in its low nibble and row ``u + in/2`` in its
  high nibble.  Weights whose input dim is not a multiple of 128 keep
  int4 values unpacked in int8 with a per-output-channel scale.

:func:`matmul` sends group-scaled (packed int4) weights to
``int4_matmul_kernel`` and the other quantized weights to
``fp8_matmul_kernel``; each wrapper launches its CUDA kernel for tensors
on the card and computes the JAX package's CPU function for tensors on
the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from arcticinference_tpu_torch.ops.cuda.fp8_matmul import (
    fp8_matmul_kernel, fp8_matmul_reference)
from arcticinference_tpu_torch.ops.cuda.int4_matmul import (
    int4_matmul_kernel, int4_matmul_reference)

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
INT4_GROUP = 128


class QuantizedLinear:
    """Quantized values + float32 scale; ``dequant = weight * scale``.

    Indexing slices weight and scale together, so ``q[layer]`` of a
    stacked ``[L, in, out]`` weight is that layer's 2-D weight with its
    scale (``[L]`` -> scalar, ``[L, out]`` -> ``[out]``,
    ``[L, in/128, out]`` -> ``[in/128, out]``).
    """

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        self.weight = weight
        self.scale = scale

    def __getitem__(self, idx) -> "QuantizedLinear":
        return QuantizedLinear(self.weight[idx], self.scale[idx])

    @property
    def shape(self) -> torch.Size:
        return self.weight.shape

    @property
    def out_features(self) -> int:
        return self.weight.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.weight.nbytes + self.scale.nbytes

    def to(self, device) -> "QuantizedLinear":
        return QuantizedLinear(self.weight.to(device), self.scale.to(device))

    def __repr__(self):
        return (f"QuantizedLinear(weight={tuple(self.weight.shape)} "
                f"{self.weight.dtype}, scale={tuple(self.scale.shape)})")


def fp8_scale(w: torch.Tensor) -> torch.Tensor:
    """The per-tensor e4m3 scale of ``w`` (0-d float32): its largest
    magnitude over ``FP8_MAX``."""
    return torch.clamp(w.abs().amax().float(), min=1e-12) / FP8_MAX


def fp8_quantize(w: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> QuantizedLinear:
    """Per-tensor symmetric quantization to e4m3; stacked weights
    (``ndim >= 3``) get one scale per layer (``[L]``).  ``scale`` (0-d)
    quantizes ``w`` against a scale given instead: a piece of a larger
    tensor quantized as that whole tensor (:func:`fp8_scale` of it)."""
    wf = w.float()
    if scale is None and w.dim() >= 3:
        amax = wf.abs().amax(dim=tuple(range(1, w.dim())))
        scale = torch.clamp(amax, min=1e-12) / FP8_MAX
        q = wf / scale.reshape((-1,) + (1,) * (w.dim() - 1))
    else:
        if scale is None:
            scale = fp8_scale(w)
        q = wf / scale
    q = torch.clamp(q, -FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    return QuantizedLinear(q, scale.float())


def int_quantize(w: torch.Tensor, bits: int = 8,
                 group_size: Optional[int] = None) -> QuantizedLinear:
    """Symmetric round-to-nearest int8 / int4 quantization of ``w``
    ``[.., in, out]``: per-output-channel scales, and for int4 groups of
    ``group_size`` input rows, packed split-half (see the module note)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if group_size is None and bits == 4:
        group_size = INT4_GROUP
    wf = w.float()
    qmax = 127.0 if bits == 8 else 7.0
    packed = bool(group_size and w.shape[-2] % group_size == 0)
    if packed:
        g = group_size
        lead = wf.shape[:-2]
        kin, out = wf.shape[-2:]
        wg = wf.reshape(*lead, kin // g, g, out)
        amax = wg.abs().amax(dim=-2)                      # [.., in/g, out]
        scale = torch.clamp(amax, min=1e-12) / qmax
        q = torch.round(wg / scale[..., None, :]).reshape(*lead, kin, out)
    else:
        amax = wf.abs().amax(dim=-2)                      # [.., out]
        scale = torch.clamp(amax, min=1e-12) / qmax
        q = torch.round(wf / scale[..., None, :])
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    if packed:
        q = _pack_int4(q)
    return QuantizedLinear(q, scale.float())


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[.., in, out] int8 in [-7, 7] -> [.., in/2, out] split-half
    nibbles (row ``u`` low, row ``u + in/2`` high)."""
    kin = q.shape[-2]
    if kin % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {kin}")
    lo = q[..., :kin // 2, :] & 0x0F
    hi = q[..., kin // 2:, :] << 4
    return lo | hi


def _unpack_int4(w: torch.Tensor) -> torch.Tensor:
    """Packed [.., in/2, out] int8 -> [.., in, out] int8, sign-extended:
    the low nibbles' rows, then the high nibbles'."""
    lo = (w << 4) >> 4
    hi = w >> 4
    return torch.cat([lo, hi], dim=-2)


def weight_quantize(w: torch.Tensor, mode: str) -> QuantizedLinear:
    """Quantize by mode name: "fp8" | "int8" | "int4"."""
    if mode == "fp8":
        return fp8_quantize(w)
    if mode == "int8":
        return int_quantize(w, bits=8)
    if mode == "int4":
        return int_quantize(w, bits=4)
    raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_layers(w: torch.Tensor, mode: str) -> QuantizedLinear:
    """:func:`weight_quantize` of a stacked ``[L, in, out]`` weight, one
    layer at a time.  Every scale is a reduction within one layer, so the
    bytes and scales are those of the whole-stack call, while the float32
    working copy is one layer's, not the stack's."""
    parts = [weight_quantize(w[i], mode) for i in range(w.shape[0])]
    return QuantizedLinear(torch.stack([p.weight for p in parts]),
                           torch.stack([p.scale for p in parts]))


def fuse_quantized(parts: list, interleave: int = 1):
    """Concatenate linear weights along the out axis into one matmul
    operand (fused qkv / gate+up).

    Quantized parts keep their scales exactly: a per-tensor / per-layer
    scale is broadcast to per-out-channel over its part's columns, so
    ``dequant(fused)[..., span]`` equals ``dequant(part)`` bit for bit.

    ``interleave=W`` gives the W-shard-interleaved column order
    ``[p0_0|p1_0|..|p0_1|p1_1|..]`` (chunk f of each part is its f-th
    1/W slice of out columns): a contiguous W-way split of the fused out
    axis then hands shard f exactly ``[q_f|k_f|v_f]``, and the columns of
    one part stay in order inside any run of consecutive shards, so no
    row of ``wo`` / ``w_down`` needs moving.
    """
    def chunks(arrs):
        """Per-shard chunks of each part, shard-major."""
        if interleave == 1:
            return list(arrs)
        out = []
        for f in range(interleave):
            for a in arrs:
                n = a.shape[-1]
                if n % interleave:
                    raise ValueError(f"out dim {n} does not divide by "
                                     f"interleave={interleave}")
                nf = n // interleave
                out.append(a[..., f * nf:(f + 1) * nf])
        return out

    if not any(isinstance(p, QuantizedLinear) for p in parts):
        return torch.cat(chunks(parts), dim=-1)
    if not all(isinstance(p, QuantizedLinear) for p in parts):
        raise ValueError("cannot fuse quantized with unquantized weights")
    w = torch.cat(chunks([p.weight for p in parts]), dim=-1)
    group = parts[0].scale.dim() == parts[0].weight.dim()
    scales = []
    for p in parts:
        s, wq = p.scale, p.weight
        n = wq.shape[-1]
        if (s.dim() == wq.dim()) != group:
            raise ValueError("mixed scale granularities")
        if group or (s.dim() == wq.dim() - 1 and s.shape[-1] == n):
            scales.append(s)                  # group / per-out-channel
        else:                                 # per-tensor / per-layer
            tgt = wq.shape[:-2] + (n,)
            s = s.reshape(s.shape + (1,) * (len(tgt) - s.dim()))
            scales.append(s.float().expand(tgt))
    return QuantizedLinear(w, torch.cat(chunks(scales), dim=-1))


def fp8_dequantize(q: QuantizedLinear,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dequantize any QuantizedLinear (fp8 / int8 / int4; the granularity
    is read from the scale's rank)."""
    scale, wq = q.scale, q.weight
    if scale.dim() == wq.dim():               # group scales => packed int4
        w = _unpack_int4(wq).float()
        g = w.shape[-2] // scale.shape[-2]
        lead = w.shape[:-2]
        wg = w.reshape(*lead, scale.shape[-2], g, w.shape[-1])
        return (wg * scale[..., None, :]).reshape(w.shape).to(dtype)
    w = wq.float()
    if scale.dim() == w.dim() - 1 and scale.shape[-1] == w.shape[-1]:
        return (w * scale[..., None, :]).to(dtype)        # per out-channel
    if w.dim() >= 3 and scale.dim() == 1:
        scale = scale.reshape((-1,) + (1,) * (w.dim() - 1))
    return (w * scale).to(dtype)


def matmul(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """``x @ w`` for a plain weight or a :class:`QuantizedLinear`; the
    result is ``out_dtype`` (default ``x.dtype``).

    Quantized weights take bf16 products with float32 sums, as the JAX
    package's ``matmul``: group scales (packed int4) go to
    ``int4_matmul_kernel``, which dequantizes to bf16 before the product;
    per-tensor and per-out-channel scales go to ``fp8_matmul_kernel``,
    which multiplies the float32 sums by the scale.
    """
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedLinear):
        if w.scale.dim() == w.weight.dim():
            return int4_matmul_kernel(x, w.weight, w.scale, out_dtype)
        return fp8_matmul_kernel(x, w.weight, w.scale, out_dtype)
    return plain_matmul(x, w, out_dtype)


def matmul_reference(x: torch.Tensor, w,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`matmul` through the kernels' plain versions on any device
    (the yardstick the kernels are held against)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedLinear):
        if w.scale.dim() == w.weight.dim():
            return int4_matmul_reference(x, w.weight, w.scale, out_dtype)
        return fp8_matmul_reference(x, w.weight, w.scale, out_dtype)
    return plain_matmul(x, w, out_dtype)


def plain_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with float32 accumulation for plain (bf16 / float32)
    weights, as ``jnp.dot(x, w, preferred_element_type=float32)
    .astype(out_dtype)``.

    When the output is wider than the inputs (bf16 in, float32 logits
    out), the card's ``torch.mm(..., out_dtype=float32)`` keeps the
    float32 sums; on the CPU both operands are widened first (products of
    bf16 values are exact in float32, so it is the same function).  A
    plain large matrix product, left to PyTorch as the JAX package left
    it to XLA.
    """
    if out_dtype == x.dtype:
        return torch.matmul(x, w.to(x.dtype))
    if out_dtype == torch.float32:
        if x.is_cuda and x.dim() == 2 and w.dtype == x.dtype:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)
