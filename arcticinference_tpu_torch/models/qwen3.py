"""Qwen3 family: the Llama decoder body with a per-head RMSNorm on q/k.

Counterpart of ``arcticinference_tpu/models/qwen3.py``, a thin variant
of :mod:`arcticinference_tpu_torch.models.llama`: a per-head RMSNorm
(``[L, head_dim]`` weights) on q and k after the projections and before
RoPE (HF ``Qwen3Attention.q_norm`` / ``k_norm``), no attention biases by
default, and an explicit ``head_dim`` that need not equal ``hidden_size
/ num_heads``; ``rope_theta`` defaults to 1e6.
"""

from __future__ import annotations

from typing import Any

# Re-exported module interface (registry contract, models/__init__.py):
from arcticinference_tpu_torch.models.llama import (  # noqa: F401
    LlamaArch, _QUANT_KEYS, compute_logits, embed_lookup, forward,
    fuse_params, init_params, load_hf_state, make_attn_impl, plain_attn,
    quantize_params, scan_layers)


class Qwen3Arch(LlamaArch):
    """LlamaArch with qk-norm on."""

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "Qwen3Arch":
        c = dict(cfg)
        c["qk_norm"] = True
        c.setdefault("attention_bias", False)
        c.setdefault("rope_theta", 1000000.0)
        return super().from_hf_config(c)


Arch = Qwen3Arch
