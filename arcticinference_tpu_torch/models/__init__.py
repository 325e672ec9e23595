"""Model registry: architecture name -> module.

Each module exposes ``Arch.from_hf_config``, ``init_params``,
``load_hf_state``, ``fuse_params``, ``forward``, ``compute_logits`` and
``make_attn_impl``.  Llama, Llama-SwiftKV, Qwen2 / Qwen2.5 and Qwen3 in
this part of the port.  A module whose ``RETURNS_SAMPLE_ROWS`` is true
(SwiftKV) returns the sample rows' hidden states from ``forward``, and
with ``NEEDS_SWIFT_SCHEDULE`` it takes the runner's second attention
schedule over them (the ``swift_*`` arrays).
"""

from importlib import import_module

_REGISTRY = {
    "llama": "arcticinference_tpu_torch.models.llama",
    "LlamaForCausalLM": "arcticinference_tpu_torch.models.llama",
    "llama_swiftkv": "arcticinference_tpu_torch.models.llama_swiftkv",
    "LlamaSwiftKVForCausalLM":
        "arcticinference_tpu_torch.models.llama_swiftkv",
    "qwen2": "arcticinference_tpu_torch.models.qwen2",
    "Qwen2ForCausalLM": "arcticinference_tpu_torch.models.qwen2",
    "qwen3": "arcticinference_tpu_torch.models.qwen3",
    "Qwen3ForCausalLM": "arcticinference_tpu_torch.models.qwen3",
}

# Architectures the JAX package serves that are not ported yet.
_NOT_PORTED = (
    "bert", "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
    "mixtral", "MixtralForCausalLM", "mlp_speculator",
    "ArcticMLPSpeculatorPreTrainedModel",
    "ArcticLSTMSpeculatorPreTrainedModel")


def get_model_module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model architecture {name!r} is not ported yet (Llama, "
            "Llama-SwiftKV, Qwen2 and Qwen3 are)")
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown model architecture {name!r}; known: {sorted(_REGISTRY)}")
    return import_module(_REGISTRY[name])
