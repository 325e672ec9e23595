"""Model registry: architecture name -> module.

Each module exposes ``Arch.from_hf_config``, ``init_params``,
``load_hf_state``, ``forward``, ``compute_logits``, ``make_attn_impl``
and, where it fuses weights, ``fuse_params`` (Mixtral, as in the JAX
package, does not).  Llama, Llama-SwiftKV, Qwen2 / Qwen2.5, Qwen3 and
Mixtral in this part of the port, and the BERT encoders, whose module
instead sets ``IS_ENCODER`` and exposes a dense ``forward`` and ``pool``
(the ``EncoderRunner``'s, ``engine/encoder.py``).  A module whose
``RETURNS_SAMPLE_ROWS`` is true (SwiftKV) returns the sample rows' hidden
states from ``forward``, and with ``NEEDS_SWIFT_SCHEDULE`` it takes the
runner's second attention schedule over them (the ``swift_*`` arrays).
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
    "mixtral": "arcticinference_tpu_torch.models.mixtral",
    "MixtralForCausalLM": "arcticinference_tpu_torch.models.mixtral",
    "bert": "arcticinference_tpu_torch.models.bert",
    "BertModel": "arcticinference_tpu_torch.models.bert",
    "BertForMaskedLM": "arcticinference_tpu_torch.models.bert",
    "BertForSequenceClassification": "arcticinference_tpu_torch.models.bert",
}

# The speculator checkpoints the JAX registry lists: drafters, not targets
# (their JAX module has no ``forward`` either).
_NOT_PORTED = (
    "mlp_speculator", "ArcticMLPSpeculatorPreTrainedModel",
    "ArcticLSTMSpeculatorPreTrainedModel")


def get_model_module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model architecture {name!r} is a speculator checkpoint, not "
            "a target model; load it as a drafter "
            "(SpeculativeConfig(method=\"arctic\", model=...))")
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown model architecture {name!r}; known: {sorted(_REGISTRY)}")
    return import_module(_REGISTRY[name])
