"""Arctic MLP / LSTM speculators (draft models).

Counterpart of ``arcticinference_tpu/models/speculators.py``:

- :class:`MLPSpecArch`: the multi-head MLP speculator.  Per head,
  embed(last token) and project(state) are blended with the fixed
  ``state_weight`` / ``emb_weight``, L2-normed, GELU'd (exact, erf), and
  decoded greedily through the head's LM head.
- :class:`LSTMSpecArch`: the ``sum_lstm`` variant: one 4-way projection
  split into forget / input / output gates and a cell candidate, a
  normed cell chain, tied embeddings.

The ``n_predict``-head greedy chain is unrolled in Python and keeps the
argmax chain on the device: a call returns the ``[B, n_predict]`` draft
block as a device tensor and synchronises nothing.  Quantized leaves are
:class:`~arcticinference_tpu_torch.ops.fp8.QuantizedLinear`; their
products go through :func:`~arcticinference_tpu_torch.ops.fp8.matmul`,
which launches ``fp8_matmul_kernel`` for tensors on the card.  Plain
weights take bf16 (or float32) products with float32 sums, as the JAX
package's ``jnp.dot(..., preferred_element_type=float32)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from arcticinference_tpu_torch.ops import fp8 as fp8_ops
from arcticinference_tpu_torch.ops.layers import l2_norm_scaled

SQRT2 = math.sqrt(2.0)

# ---------------------------------------------------------------------------
# Quantization: fp8 / int8 LM heads, projections and embedding gathers
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with float32 output, where ``w`` may be quantized."""
    if isinstance(w, fp8_ops.QuantizedLinear):
        return fp8_ops.matmul(x.to(torch.bfloat16), w, torch.float32)
    return fp8_ops.plain_matmul(x.to(w.dtype), w, torch.float32)


def _embed(e, tok: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tok`` in float32; a quantized table is
    dequantized in the gathered rows only (int8: per column, fp8: one
    scalar)."""
    if isinstance(e, fp8_ops.QuantizedLinear):
        z = e.weight[tok.long()].float()
        s = e.scale
        if s.dim() and s.shape[-1] == e.weight.shape[-1]:
            return z * s
        return z * s.reshape(())
    return e[tok.long()].float()


def quantize_spec_params(params: dict, mode: str) -> dict:
    """Every draft matmul and embedding weight to fp8 / int8 (norm
    vectors stay as they are).  int4 is refused: its packed split-half
    layout cannot be gathered by row for the embeddings."""
    if mode not in ("fp8", "int8"):
        raise ValueError(f"speculator quantization {mode!r} unsupported")
    out = dict(params)
    for key in ("emb", "proj", "head", "forget_emb", "proj_first",
                "proj_rest"):
        if key not in out:
            continue
        v = out[key]
        out[key] = ([fp8_ops.weight_quantize(w, mode) for w in v]
                    if isinstance(v, list)
                    else fp8_ops.weight_quantize(v, mode))
    return out


def _normal(generator: torch.Generator, dtype: torch.dtype, device):
    def w(shape):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(0.02)
    return w


# ---------------------------------------------------------------------------
# MLP speculator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLPSpecArch:
    vocab_size: int = 32000
    emb_dim: int = 4096            # the base model's hidden size
    inner_dim: int = 4096
    n_predict: int = 3
    tie_weights: bool = True
    scale_input: bool = True
    method: str = "sum_rnn"

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "MLPSpecArch":
        inner = cfg.get("inner_dim", 0)
        if isinstance(inner, str):
            inner = int(inner.split(".")[-1])
        emb = cfg.get("emb_dim", 4096)
        if isinstance(emb, str):
            emb = int(emb.split(".")[-1])
        return cls(
            vocab_size=cfg.get("vocab_size", 32000),
            emb_dim=emb,
            inner_dim=inner or emb,
            n_predict=cfg.get("n_predict", 3),
            tie_weights=cfg.get("tie_weights", True),
            scale_input=cfg.get("scale_input", True),
        )

    @property
    def state_weight(self) -> float:
        return 0.5 ** (0.5 / self.n_predict)

    @property
    def emb_weight(self) -> float:
        return math.sqrt(
            (1 - self.state_weight ** 2) * (self.inner_dim / 2))


def mlp_init_params(arch: MLPSpecArch, generator: torch.Generator,
                    dtype: torch.dtype = torch.bfloat16,
                    device: torch.device | str | None = None) -> dict:
    """Random parameters, Normal(0, 0.02) drawn from ``generator`` on
    ``device`` (by default the generator's): the JAX package's shapes,
    not its numbers."""
    device = generator.device if device is None else device
    n_uniq = 1 if arch.tie_weights else arch.n_predict
    n_proj = min(2, arch.n_predict) if arch.tie_weights else arch.n_predict
    w = _normal(generator, dtype, device)
    proj_in = [arch.emb_dim if i == 0 else arch.inner_dim
               for i in range(n_proj)]
    return {
        "emb": [w((arch.vocab_size, arch.inner_dim)) for _ in range(n_uniq)],
        "proj": [w((proj_in[i], arch.inner_dim)) for i in range(n_proj)],
        "head": [w((arch.inner_dim, arch.vocab_size))
                 for _ in range(n_uniq)],
        "ln_w": [torch.ones(arch.inner_dim, dtype=dtype, device=device)
                 for _ in range(n_uniq)],
        "ln_b": [torch.zeros(arch.inner_dim, dtype=dtype, device=device)
                 for _ in range(n_uniq)],
    }


def _mlp_head_params(params: dict, arch: MLPSpecArch, i: int):
    if arch.tie_weights:
        return (params["emb"][0], params["proj"][min(i, 1)],
                params["head"][0], params["ln_w"][0], params["ln_b"][0])
    return (params["emb"][i], params["proj"][i], params["head"][i],
            params["ln_w"][i], params["ln_b"][i])


def mlp_chain(params: dict, arch: MLPSpecArch, last_tokens: torch.Tensor,
              hidden: torch.Tensor, num_predict: int, gather=None
              ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The greedy chain: [B] last tokens and [B, emb_dim] hidden rows ->
    ([B, num_predict] int32 drafts, each head's float32 logits).
    ``gather``: the whole vocabulary's logits from a head that holds a
    column piece of it (a tied head on a tp mesh)."""
    state = hidden.float()
    if arch.scale_input:
        state = l2_norm_scaled(state, None, None) / SQRT2
    tok = last_tokens
    alpha = arch.emb_weight / arch.state_weight
    drafts, logits = [], []
    for i in range(num_predict):
        e, p, h, lw, lb = _mlp_head_params(params, arch, i)
        states = _mm(state, p) + alpha * _embed(e, tok)
        states = F.gelu(l2_norm_scaled(states, lw, lb).float())
        lg = _mm(states, h)
        logits.append(lg if gather is None else gather(lg))
        tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)
        drafts.append(tok)
        state = states
    return torch.stack(drafts, dim=1), logits


def mlp_generate_proposals(params: dict, arch: MLPSpecArch,
                           last_tokens: torch.Tensor, hidden: torch.Tensor,
                           num_predict: int, gather=None) -> torch.Tensor:
    """Greedy draft chain: [B] last tokens and [B, emb_dim] hidden rows
    -> [B, num_predict] int32 draft tokens, on the device."""
    return mlp_chain(params, arch, last_tokens, hidden, num_predict,
                     gather)[0]


# ---------------------------------------------------------------------------
# LSTM speculator (sum_lstm)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LSTMSpecArch:
    vocab_size: int = 32000
    input_hidden_dim: int = 4096
    emb_dim: tuple[int, ...] = (4096,)
    inner_dim: tuple[int, ...] = (4096,)
    proj_dim: tuple[int, ...] = (4096,)
    n_predict: int = 3
    tie_weights: bool = True
    tie_lstm_embs: bool = True
    scale_input: bool = True
    method: str = "sum_lstm"

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any]) -> "LSTMSpecArch":
        def dims(x, default):
            if x is None:
                return default
            if isinstance(x, str):
                return tuple(int(v) for v in x.split("."))
            if isinstance(x, int):
                return (x,)
            return tuple(x)

        hid = cfg.get("input_hidden_dim", 4096)
        return cls(
            vocab_size=cfg.get("vocab_size", 32000),
            input_hidden_dim=hid,
            emb_dim=dims(cfg.get("emb_dim"), (hid,)),
            inner_dim=dims(cfg.get("inner_dim"), (hid,)),
            proj_dim=dims(cfg.get("proj_dim"), (hid,)),
            n_predict=cfg.get("n_predict", 3),
            tie_weights=cfg.get("tie_weights", True),
            tie_lstm_embs=cfg.get("tie_lstm_embs", True),
            scale_input=cfg.get("scale_input", True),
            method=cfg.get("method", "sum_lstm"),
        )

    @property
    def state_weight(self) -> float:
        return 0.5 ** (0.5 / self.n_predict)

    @property
    def emb_weight(self) -> float:
        return math.sqrt(
            (1 - self.state_weight ** 2) * (self.inner_dim[0] / 2))


def lstm_init_params(arch: LSTMSpecArch, generator: torch.Generator,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str | None = None) -> dict:
    """Random parameters, as :func:`mlp_init_params`."""
    if not arch.tie_weights:
        raise ValueError("sum_lstm requires tie_weights")
    device = generator.device if device is None else device
    w = _normal(generator, dtype, device)
    p0 = arch.proj_dim[0]

    def const(fill):
        return torch.full((arch.inner_dim[0],), fill, dtype=dtype,
                          device=device)

    return {
        "forget_emb": w((arch.vocab_size, arch.emb_dim[0])),
        "proj_first": w((arch.input_hidden_dim, p0 * 4)),
        "proj_rest": w((arch.inner_dim[-1], p0 * 4)),
        "cell_ln_w": const(1.0),
        "cell_ln_b": const(0.0),
        "state_ln_w": const(1.0),
        "state_ln_b": const(0.0),
        "head": w((arch.inner_dim[-1], arch.vocab_size)),
    }


def lstm_chain(params: dict, arch: LSTMSpecArch, last_tokens: torch.Tensor,
               hidden: torch.Tensor, num_predict: int
               ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The sum_lstm greedy chain -> (drafts, each head's logits), as
    :func:`mlp_chain`."""
    b = last_tokens.shape[0]
    p0 = arch.proj_dim[0]
    state = hidden.float()
    if arch.scale_input:
        state = l2_norm_scaled(state, None, None) / SQRT2
    cell = torch.zeros((b, arch.inner_dim[0]), dtype=torch.float32,
                       device=hidden.device)
    tok = last_tokens
    alpha = arch.emb_weight / arch.state_weight
    drafts, logits = [], []
    for i in range(num_predict):
        proj = params["proj_first"] if i == 0 else params["proj_rest"]
        z4 = _embed(params["forget_emb"], tok).repeat(1, 4)
        states = _mm(state, proj) + alpha * z4
        gates = torch.sigmoid(states[:, :3 * p0])
        fg, ig, og = gates[:, :p0], gates[:, p0:2 * p0], gates[:, 2 * p0:]
        cand = F.gelu(l2_norm_scaled(
            states[:, 3 * p0:], params["cell_ln_w"],
            params["cell_ln_b"]).float()) * ig
        cell = cell * fg + cand
        state = F.gelu(l2_norm_scaled(
            cell, params["state_ln_w"], params["state_ln_b"]).float()) * og
        logits.append(_mm(state, params["head"]))
        tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)
        drafts.append(tok)
    return torch.stack(drafts, dim=1), logits


def lstm_generate_proposals(params: dict, arch: LSTMSpecArch,
                            last_tokens: torch.Tensor, hidden: torch.Tensor,
                            num_predict: int) -> torch.Tensor:
    """sum_lstm greedy chain -> [B, num_predict] int32 drafts."""
    return lstm_chain(params, arch, last_tokens, hidden, num_predict)[0]


# ---------------------------------------------------------------------------
# Checkpoint loading (HF safetensors names)
# ---------------------------------------------------------------------------

def _as(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A checkpoint tensor (numpy array or torch tensor, any layout) as a
    contiguous ``dtype`` tensor on ``device``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype).contiguous()


def load_mlp_state(arch: MLPSpecArch, tensors: dict,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu") -> dict:
    """MLP speculator checkpoints (``emb.N`` / ``proj.N`` / ``head.N`` /
    ``ln.N``, an optional ``speculator.`` prefix) as the parameter dict;
    linear weights are transposed to ``[in, out]``."""
    t = {k.replace("speculator.", ""): v for k, v in tensors.items()}
    n_uniq = 1 if arch.tie_weights else arch.n_predict
    n_proj = min(2, arch.n_predict) if arch.tie_weights else arch.n_predict

    def get(name):
        if name not in t:
            raise KeyError(f"missing speculator tensor {name}; "
                           f"have {sorted(t)[:8]}...")
        return t[name]

    return {
        "emb": [_as(get(f"emb.{i}.weight"), dtype, device)
                for i in range(n_uniq)],
        "proj": [_as(get(f"proj.{i}.weight").T, dtype, device)
                 for i in range(n_proj)],
        "head": [_as(get(f"head.{i}.weight").T, dtype, device)
                 for i in range(n_uniq)],
        "ln_w": [_as(get(f"ln.{i}.weight"), dtype, device)
                 for i in range(n_uniq)],
        "ln_b": [_as(get(f"ln.{i}.bias"), dtype, device)
                 for i in range(n_uniq)],
    }


def load_lstm_state(arch: LSTMSpecArch, tensors: dict,
                    dtype: torch.dtype = torch.bfloat16,
                    device: torch.device | str = "cpu") -> dict:
    """sum_lstm speculator checkpoints as the parameter dict."""
    del arch
    t = {k.replace("speculator.", ""): v for k, v in tensors.items()}

    def get(name):
        if name not in t:
            raise KeyError(f"missing speculator tensor {name}")
        return t[name]

    return {
        "forget_emb": _as(get("forget_emb.0.weight"), dtype, device),
        "proj_first": _as(get("projs.0.weight").T, dtype, device),
        "proj_rest": _as(get("projs.1.weight").T, dtype, device),
        "cell_ln_w": _as(get("cell_ln.0.weight"), dtype, device),
        "cell_ln_b": _as(get("cell_ln.0.bias"), dtype, device),
        "state_ln_w": _as(get("state_ln.0.weight"), dtype, device),
        "state_ln_b": _as(get("state_ln.0.bias"), dtype, device),
        "head": _as(get("head.0.weight").T, dtype, device),
    }
