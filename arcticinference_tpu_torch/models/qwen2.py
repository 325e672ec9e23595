"""Qwen2 / Qwen2.5 family: the Llama decoder body with q/k/v biases.

Counterpart of ``arcticinference_tpu/models/qwen2.py``.  The family is a
thin variant of :mod:`arcticinference_tpu_torch.models.llama`: the same
forward, paged cache and weight-only quantization, with biases on the
q/k/v projections (HF ``Qwen2Attention`` always has them; its config has
no ``attention_bias`` field) and a default ``rope_theta`` of 1e6.  Tied
embeddings (the 0.5B / 1.5B checkpoints) are the base loader's.
"""

from __future__ import annotations

from typing import Any

# Re-exported module interface (registry contract, models/__init__.py):
from arcticinference_tpu_torch.models.llama import (  # noqa: F401
    LlamaArch, _QUANT_KEYS, compute_logits, embed_lookup, forward,
    fuse_params, init_params, load_hf_state, make_attn_impl, plain_attn,
    quantize_params, scan_layers)


class Qwen2Arch(LlamaArch):
    """LlamaArch with attention biases on by default."""

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "Qwen2Arch":
        c = dict(cfg)
        c.setdefault("attention_bias", True)
        c.setdefault("rope_theta", 1000000.0)
        return super().from_hf_config(c)


Arch = Qwen2Arch
