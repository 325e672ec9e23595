"""The quantization quality gate on the tiny trained checkpoint.

Counterpart of the JAX package's ``tests/test_quality_gate.py``: held-out
perplexity through the whole engine (loader, quantizer, paged forward,
``LLM.score``) for bf16, fp8, int8, int4 and fp8 weights over an fp8 KV
cache, each quantized one against bf16; and the logit KL of each
quantized precision against bf16 over one 256-token prefill
(``LLMEngine.prompt_logits``).  The bounds are the JAX gate's.

    from arcticinference_tpu_torch.benchmarks import quality_gate as qg
    llm = LLM(qg.engine_config(ckpt, "fp8"), device="cpu")
    ppl = qg.perplexity(llm, qg.heldout_sequences(heldout))

``chip_smoke.py`` (phase ``quality``) runs the gate on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from arcticinference_tpu_torch.config import EngineConfig

#: The precisions of the gate: (name, weight quantization, KV dtype).
PRECISIONS = (("bf16", None, "auto"), ("fp8", "fp8", "auto"),
              ("int8", "int8", "auto"), ("int4", "int4", "auto"),
              ("fp8_kv", "fp8", "fp8"))
#: bf16 perplexity must stay below this (uniform over 256 bytes is 256).
PPL_BOUND = 2.5
#: Each precision's perplexity over bf16's must stay below these.
RATIO_BOUNDS = {"fp8": 1.02, "int8": 1.02, "int4": 1.06, "fp8_kv": 1.03}
#: Mean KL(bf16 || precision) of the logits must stay below these.
KL_BOUNDS = {"fp8": 0.05, "int8": 0.05, "int4": 0.20}
#: Held-out sequences and their length, and the KL's prefill length.
SEQUENCES, SEQ_LEN, KL_TOKENS = 6, 256, 256


def engine_config(ckpt: str, quantization: Optional[str] = None,
                  kv_cache_dtype: str = "auto", dtype: str = "bfloat16",
                  block_size: int = 32) -> EngineConfig:
    """The gate's engine: the JAX gate's sizes (2048-token contexts, 256
    blocks, 8 sequences, 512 batched tokens).  The card's kernels take
    32-token pages; the JAX gate runs 16."""
    return EngineConfig.from_dict(dict(
        model=dict(model=ckpt, quantization=quantization,
                   max_model_len=2048, dtype=dtype),
        cache=dict(block_size=block_size, num_blocks=256,
                   kv_cache_dtype=kv_cache_dtype),
        scheduler=dict(max_num_seqs=8, max_num_batched_tokens=512)))


def heldout_sequences(heldout, n: int = SEQUENCES,
                      length: int = SEQ_LEN) -> list[list[int]]:
    """The first ``n`` whole ``length``-token windows of ``heldout``."""
    return [[int(t) for t in heldout[i:i + length]]
            for i in range(0, len(heldout) - length, length)][:n]


def perplexity(llm, seqs) -> float:
    """exp(-mean teacher-forced logprob) of ``seqs`` through
    ``llm.score``."""
    return float(np.exp(-np.concatenate(llm.score(seqs)).mean()))


def kl(p_logits: np.ndarray, q_logits: np.ndarray) -> float:
    """Mean over rows of KL(softmax(p) || softmax(q)), in float64 (the
    logits of ``LLMEngine.prompt_logits``)."""
    def logsoft(x):
        x = np.asarray(x, np.float64)
        m = x.max(-1, keepdims=True)
        return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))

    lp, lq = logsoft(p_logits), logsoft(q_logits)
    return float((np.exp(lp) * (lp - lq)).sum(-1).mean())


def failures(ppls: dict, kls: dict) -> list[str]:
    """Every bound of the gate that ``ppls`` ({precision: perplexity})
    and ``kls`` ({precision: KL against bf16}) break."""
    out = []
    if not ppls["bf16"] < PPL_BOUND:
        out.append(f"bf16 perplexity {ppls['bf16']:.4f} >= {PPL_BOUND}")
    for name, bound in RATIO_BOUNDS.items():
        ratio = ppls[name] / ppls["bf16"]
        if not ratio < bound:
            out.append(f"{name} perplexity ratio {ratio:.4f} >= {bound}")
    for name, bound in KL_BOUNDS.items():
        if not kls[name] < bound:
            out.append(f"{name} KL {kls[name]:.4f} >= {bound}")
    return out
