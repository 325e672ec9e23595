"""BERT-family bidirectional encoders as plain functions on tensors.

Counterpart of ``arcticinference_tpu/models/bert.py``, with its keys and
layout: layer weights stacked on a leading ``[L, ...]`` axis, matmul
weights ``[in, out]``, post-LN residuals (original BERT), learned
absolute positions and a GELU MLP, so Hugging Face ``BertModel``
checkpoints (with or without a ``bert.`` prefix) load as they are.

Encoders are one-shot: a dense ``[B, T]`` batch padded to bucketed
lengths, no KV cache.  No Pallas kernel lies on this path in the JAX
package, so there is no hand-written kernel here either: the products are
``torch.matmul`` and ``torch.einsum``, and attention follows the JAX
module op for op:

- the scores are formed in float32 from the (exact) upcast q and k, as
  ``preferred_element_type=jnp.float32`` forms them; a bf16 product would
  round them to bf16 first;
- the additive mask is ``-1e30``, not ``-inf``, so an all-padding row of
  a bucket softmaxes to uniform weights instead of NaN;
- the probabilities are cast to the activation dtype before P @ V;
- LayerNorm runs in float32 and casts back; only ``type_emb[0]`` is
  added (token types are ignored).

Pooling (cls / mean / max / last, optional L2 normalisation) runs on the
device, so the host gets ``[B, D]``, not ``[B, T, D]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from arcticinference_tpu_torch.utils import resolve_device

IS_ENCODER = True


@dataclass(frozen=True)
class BertArch:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    hidden_act: str = "gelu"

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "BertArch":
        d = int(cfg.get("hidden_size", 768))
        heads = int(cfg.get("num_attention_heads", 12))
        return cls(
            vocab_size=int(cfg.get("vocab_size", 30522)),
            hidden_size=d,
            intermediate_size=int(cfg.get("intermediate_size", 4 * d)),
            num_layers=int(cfg.get("num_hidden_layers", 12)),
            num_heads=heads,
            head_dim=d // heads,
            max_position_embeddings=int(
                cfg.get("max_position_embeddings", 512)),
            type_vocab_size=int(cfg.get("type_vocab_size", 2)),
            layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
            pad_token_id=int(cfg.get("pad_token_id") or 0),
            hidden_act=str(cfg.get("hidden_act", "gelu")),
        )


Arch = BertArch


def init_params(arch: BertArch, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                quantization: Optional[str] = None,
                device: torch.device | str | None = None) -> dict:
    """Random init (benchmarks, tests) on ``device`` (by default the
    generator's): Normal(0, 0.02) matrices and tables, zero biases and
    type embeddings, unit LayerNorm gains, as the JAX package draws them
    (not the same numbers).  ``quantization`` is accepted and ignored,
    as there: weight-only fp8 buys nothing at encoder sizes."""
    if device is None:
        device = generator.device
    d, f, nl = arch.hidden_size, arch.intermediate_size, arch.num_layers

    def w(*shape):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "wq": w(nl, d, d), "wk": w(nl, d, d), "wv": w(nl, d, d),
        "wo": w(nl, d, d),
        "bq": zeros(nl, d), "bk": zeros(nl, d), "bv": zeros(nl, d),
        "bo": zeros(nl, d),
        "ln1_g": ones(nl, d), "ln1_b": zeros(nl, d),
        "w_in": w(nl, d, f), "b_in": zeros(nl, f),
        "w_out": w(nl, f, d), "b_out": zeros(nl, d),
        "ln2_g": ones(nl, d), "ln2_b": zeros(nl, d),
    }
    return {
        "word_emb": w(arch.vocab_size, d),
        "pos_emb": w(arch.max_position_embeddings, d),
        "type_emb": zeros(arch.type_vocab_size, d),
        "emb_ln_g": ones(d),
        "emb_ln_b": zeros(d),
        "layers": layers,
    }


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _act(name: str):
    if name in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        # "gelu" is the erf form; the other two the tanh approximation.
        approx = "none" if name == "gelu" else "tanh"
        return lambda x: F.gelu(x, approximate=approx)
    if name == "relu":
        return F.relu
    if name == "silu":
        return F.silu
    raise ValueError(f"unsupported hidden_act {name!r}")


@torch.inference_mode()
def forward(params: dict, arch: BertArch, inputs: dict) -> torch.Tensor:
    """Dense bidirectional encode.

    inputs: ``input_ids`` [B, T] integer, ``attention_mask`` [B, T]
    (1 = real token).  Returns the hidden states [B, T, D] in the
    parameters' dtype."""
    ids = inputs["input_ids"].long()
    mask = inputs["attention_mask"]
    b, t = ids.shape
    h = params["word_emb"][ids]
    h = h + params["pos_emb"][:t][None, :, :]
    h = h + params["type_emb"][0][None, None, :]
    eps = arch.layer_norm_eps
    h = _layer_norm(h, params["emb_ln_g"], params["emb_ln_b"], eps)

    nh, hd = arch.num_heads, arch.head_dim
    act = _act(arch.hidden_act)
    # Additive mask in float32 (the scores are float32).
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).float()
    scale = 1.0 / math.sqrt(hd)
    lp = params["layers"]
    for i in range(arch.num_layers):
        q = (h @ lp["wq"][i] + lp["bq"][i]).reshape(b, t, nh, hd)
        k = (h @ lp["wk"][i] + lp["bk"][i]).reshape(b, t, nh, hd)
        v = (h @ lp["wv"][i] + lp["bv"][i]).reshape(b, t, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores * scale + bias, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.to(h.dtype), v)
        o = o.reshape(b, t, nh * hd) @ lp["wo"][i] + lp["bo"][i]
        h = _layer_norm(h + o, lp["ln1_g"][i], lp["ln1_b"][i], eps)
        m = act(h @ lp["w_in"][i] + lp["b_in"][i]) @ lp["w_out"][i] \
            + lp["b_out"][i]
        h = _layer_norm(h + m, lp["ln2_g"][i], lp["ln2_b"][i], eps)
    return h


def pool(hidden: torch.Tensor, mask: torch.Tensor, method: str = "mean",
         normalize: bool = True) -> torch.Tensor:
    """[B, T, D] -> [B, D] float32 on the device; ``mask`` [B, T] is 1
    for a real token."""
    m = mask.float()[:, :, None]
    h = hidden.float()
    if method == "mean":
        out = (h * m).sum(1) / m.sum(1).clamp_min(1.0)
    elif method == "cls":
        out = h[:, 0, :]
    elif method == "max":
        out = torch.where(m > 0, h, -torch.inf).amax(1)
    elif method == "last":
        last = (mask.sum(-1).long() - 1).clamp_min(0)
        out = h[torch.arange(h.shape[0], device=h.device), last]
    else:
        raise ValueError(f"unknown pooling {method!r}")
    if normalize:
        out = out / torch.linalg.vector_norm(
            out, dim=-1, keepdim=True).clamp_min(1e-12)
    return out


def load_hf_state(arch: BertArch, tensors: dict,
                  dtype: torch.dtype = torch.float32,
                  quantization: Optional[str] = None,
                  device: torch.device | str | None = None) -> dict:
    """Map Hugging Face ``BertModel`` checkpoint names (with or without a
    ``bert.`` prefix; tensors or numpy arrays) onto the stacked-layer
    parameters on ``device`` (``cuda:0`` by default)."""
    device = resolve_device(device)

    def get(name):
        for cand in (name, "bert." + name):
            if cand in tensors:
                x = tensors[cand]
                return (torch.from_numpy(np.asarray(x))
                        if not isinstance(x, torch.Tensor) else x)
        raise KeyError(name)

    def put(x):
        return x.to(device=device, dtype=dtype)

    def stack(fmt, transpose=False):
        ws = [get(fmt.format(i)) for i in range(arch.num_layers)]
        # HF Linear stores [out, in]; these multiply as x @ w: [in, out].
        return put(torch.stack([w.T if transpose else w for w in ws]))

    p = "encoder.layer.{}."
    layers = {
        "wq": stack(p + "attention.self.query.weight", True),
        "bq": stack(p + "attention.self.query.bias"),
        "wk": stack(p + "attention.self.key.weight", True),
        "bk": stack(p + "attention.self.key.bias"),
        "wv": stack(p + "attention.self.value.weight", True),
        "bv": stack(p + "attention.self.value.bias"),
        "wo": stack(p + "attention.output.dense.weight", True),
        "bo": stack(p + "attention.output.dense.bias"),
        "ln1_g": stack(p + "attention.output.LayerNorm.weight"),
        "ln1_b": stack(p + "attention.output.LayerNorm.bias"),
        "w_in": stack(p + "intermediate.dense.weight", True),
        "b_in": stack(p + "intermediate.dense.bias"),
        "w_out": stack(p + "output.dense.weight", True),
        "b_out": stack(p + "output.dense.bias"),
        "ln2_g": stack(p + "output.LayerNorm.weight"),
        "ln2_b": stack(p + "output.LayerNorm.bias"),
    }
    return {
        "word_emb": put(get("embeddings.word_embeddings.weight")),
        "pos_emb": put(get("embeddings.position_embeddings.weight")),
        "type_emb": put(get("embeddings.token_type_embeddings.weight")),
        "emb_ln_g": put(get("embeddings.LayerNorm.weight")),
        "emb_ln_b": put(get("embeddings.LayerNorm.bias")),
        "layers": layers,
    }
