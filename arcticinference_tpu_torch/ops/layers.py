"""Stateless layer math (plain torch ops on tensors).

Counterparts of ``arcticinference_tpu/ops/layers.py``.  None of these is
a Pallas kernel in the JAX package (XLA fuses them), so here they are
plain PyTorch as well.  Each computes in float32 and returns the input's
dtype, as the JAX functions do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from arcticinference_tpu_torch.ops.fp8 import matmul


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def l2_norm_scaled(x: torch.Tensor, weight: torch.Tensor | None,
                   bias: torch.Tensor | None,
                   eps: float = 1e-6) -> torch.Tensor:
    """The speculators' LayerNorm variant: L2-normalise (no mean
    subtraction), then scale and shift; output in x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def compute_rope_freqs(head_dim: int, rope_theta: float,
                       scaling: dict | None = None, *,
                       device: torch.device | str) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (float32), with optional Llama-3
    scaling (``rope_type == "llama3"``)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (rope_theta ** exponents)
    if scaling and scaling.get("rope_type") == "llama3":
        factor = scaling["factor"]
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        old_len = scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / inv_freq
        low_wl = old_len / low
        high_wl = old_len / high
        smooth = (old_len / wavelen - low) / (high - low)
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq,
                        (1 - smooth) * inv_freq / factor
                        + smooth * inv_freq))
    return inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split convention (HF Llama).

    x: [T, H, D]; positions: [T]; inv_freq: [D//2].
    """
    angles = positions[:, None].float() * inv_freq[None, :]
    cos = torch.cos(angles)[:, None, :]  # [T, 1, D/2]
    sin = torch.sin(angles)[:, None, :]
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ), weights [in, out]."""
    g = matmul(x, w_gate, torch.float32)
    u = matmul(x, w_up, torch.float32)
    h = (F.silu(g) * u).to(x.dtype)
    return matmul(h, w_down)
