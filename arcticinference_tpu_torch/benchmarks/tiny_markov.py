"""The tiny trained checkpoint: a 2-layer Llama trained on a Markov
corpus, built by the port with neither ``transformers`` nor
``tokenizers`` nor ``safetensors``.

Counterpart of the JAX harness's ``tests/quality_utils.py``.  The corpus
is a peaked first-order Markov chain over a 16-word lexicon, so a
trained model's outputs have learnable structure: perplexity and
accuracy differences between precisions mean something, and a drafter
distilled on one part of the corpus can be held out on another.

The JAX harness trains ``hidden 128, 4 heads x 32 over 2 KV heads``.
The card's attention kernels take head_dim 64 or 128, so the port's
default splits the same 128 columns into 2 query heads of 64 over 1 KV
head (GQA group 2, as 4 / 2): every weight matrix keeps its shape
(``wq`` [128, 128], ``wk`` / ``wv`` [128, 64], the MLP [128, 256], the
LM head [128, 256]).  ``num_heads`` / ``num_kv_heads`` give the JAX
harness's split.

    from arcticinference_tpu_torch.benchmarks.tiny_markov import (
        train_tiny_checkpoint)
    train_ids, heldout_ids = train_tiny_checkpoint("ckpt", device="cpu")

writes ``config.json`` (Hugging Face ``LlamaForCausalLM`` keys),
``model.safetensors`` (through ``st_io``), the byte-level tokenizer's
files (``byte_tokenizer.write_tokenizer``) and ``train_metrics.json``
(first and last loss, seconds).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.byte_tokenizer import (ByteLevelTokenizer,
                                                      write_tokenizer)
from arcticinference_tpu_torch.utils import resolve_device

LEXICON = [
    "sun", "moon", "star", "wind", "rain", "snow", "tree", "leaf",
    "bird", "fish", "stone", "river", "cloud", "fire", "ice", "sand",
]
HIDDEN = 128
INTERMEDIATE = 256
VOCAB = 256
LAYERS = 2
ROPE_THETA = 10000.0
RMS_EPS = 1e-6
INIT_STD = 0.02


def make_corpus(n_words: int = 4000, seed: int = 0,
                peak: float = 0.85) -> str:
    """Peaked first-order Markov chain over LEXICON, space-joined: each
    word has one successor of probability ``peak`` and a uniform tail.
    The transition matrix depends on ``seed`` only, so streams of any
    length from one seed speak the same language."""
    rng = np.random.default_rng(seed)
    n = len(LEXICON)
    succ = rng.permutation(n)
    probs = np.full((n, n), (1 - peak) / (n - 1))
    probs[np.arange(n), succ] = peak
    words = [int(rng.integers(n))]
    for _ in range(n_words - 1):
        words.append(int(rng.choice(n, p=probs[words[-1]])))
    return " ".join(LEXICON[w] for w in words)


def corpus_ids(n_words: int = 4000, seed: int = 0) -> np.ndarray:
    """The corpus as byte-level token ids (int64)."""
    return np.asarray(ByteLevelTokenizer().encode(
        make_corpus(n_words=n_words, seed=seed)), np.int64)


def hf_config(num_heads: int, num_kv_heads: int) -> dict:
    """``config.json`` of the checkpoint, with the keys Hugging Face's
    ``LlamaConfig`` writes for the JAX harness's model."""
    return {
        "architectures": ["LlamaForCausalLM"],
        "attention_bias": False,
        "attention_dropout": 0.0,
        "bos_token_id": 1,
        "eos_token_id": 2,
        "head_dim": HIDDEN // num_heads,
        "hidden_act": "silu",
        "hidden_size": HIDDEN,
        "initializer_range": INIT_STD,
        "intermediate_size": INTERMEDIATE,
        "max_position_embeddings": 4096,
        "mlp_bias": False,
        "model_type": "llama",
        "num_attention_heads": num_heads,
        "num_hidden_layers": LAYERS,
        "num_key_value_heads": num_kv_heads,
        "pretraining_tp": 1,
        "rms_norm_eps": RMS_EPS,
        "rope_scaling": None,
        "rope_theta": ROPE_THETA,
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
        "use_cache": True,
        "vocab_size": VOCAB,
    }


# --------------------------------------------------------------------- #
# The trainer's model: plain torch, Hugging Face's parameter names
# --------------------------------------------------------------------- #

class RMSNorm(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + RMS_EPS)
        return self.weight * xf.to(x.dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


class Attention(nn.Module):

    def __init__(self, num_heads: int, num_kv_heads: int):
        super().__init__()
        self.h, self.hkv = num_heads, num_kv_heads
        self.d = HIDDEN // num_heads
        self.q_proj = nn.Linear(HIDDEN, num_heads * self.d, bias=False)
        self.k_proj = nn.Linear(HIDDEN, num_kv_heads * self.d, bias=False)
        self.v_proj = nn.Linear(HIDDEN, num_kv_heads * self.d, bias=False)
        self.o_proj = nn.Linear(num_heads * self.d, HIDDEN, bias=False)

    def forward(self, x, cos, sin):
        b, t, _ = x.shape
        q = self.q_proj(x).view(b, t, self.h, self.d).transpose(1, 2)
        k = self.k_proj(x).view(b, t, self.hkv, self.d).transpose(1, 2)
        v = self.v_proj(x).view(b, t, self.hkv, self.d).transpose(1, 2)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        group = self.h // self.hkv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(self.d)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        o = (p @ v).transpose(1, 2).reshape(b, t, self.h * self.d)
        return self.o_proj(o)


class MLP(nn.Module):

    def __init__(self):
        super().__init__()
        self.gate_proj = nn.Linear(HIDDEN, INTERMEDIATE, bias=False)
        self.up_proj = nn.Linear(HIDDEN, INTERMEDIATE, bias=False)
        self.down_proj = nn.Linear(INTERMEDIATE, HIDDEN, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Layer(nn.Module):

    def __init__(self, num_heads: int, num_kv_heads: int):
        super().__init__()
        self.self_attn = Attention(num_heads, num_kv_heads)
        self.mlp = MLP()
        self.input_layernorm = RMSNorm(HIDDEN)
        self.post_attention_layernorm = RMSNorm(HIDDEN)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Body(nn.Module):

    def __init__(self, num_heads: int, num_kv_heads: int):
        super().__init__()
        self.embed_tokens = nn.Embedding(VOCAB, HIDDEN)
        self.layers = nn.ModuleList(Layer(num_heads, num_kv_heads)
                                    for _ in range(LAYERS))
        self.norm = RMSNorm(HIDDEN)


class TinyLlama(nn.Module):
    """Llama for causal LM with Hugging Face's parameter names
    (``model.embed_tokens.weight``, ``model.layers.{i}.self_attn.q_proj.
    weight``, ..., ``lm_head.weight``) and its forward: RMSNorm in
    float32, rotate-half RoPE, causal GQA attention, SwiGLU, untied
    head."""

    def __init__(self, num_heads: int = 2, num_kv_heads: int = 1):
        super().__init__()
        if HIDDEN % num_heads or num_heads % num_kv_heads:
            raise ValueError(f"heads {num_heads} / {num_kv_heads} do not "
                             f"split hidden {HIDDEN}")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.model = Body(num_heads, num_kv_heads)
        self.lm_head = nn.Linear(HIDDEN, VOCAB, bias=False)

    def rope(self, t: int, device, dtype):
        d = HIDDEN // self.num_heads
        inv = 1.0 / (ROPE_THETA ** (torch.arange(
            0, d, 2, dtype=torch.int64, device=device).float() / d))
        freqs = torch.arange(t, device=device).float()[:, None] * inv
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos().to(dtype), emb.sin().to(dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, T] ids -> [B, T, VOCAB] logits."""
        x = self.model.embed_tokens(input_ids)
        cos, sin = self.rope(input_ids.shape[1], x.device, x.dtype)
        for layer in self.model.layers:
            x = layer(x, cos, sin)
        return self.lm_head(self.model.norm(x))

    def loss(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross entropy (labels = inputs, shifted)."""
        logits = self.forward(input_ids)
        return F.cross_entropy(logits[:, :-1].float().reshape(-1, VOCAB),
                               input_ids[:, 1:].reshape(-1))

    def init_weights(self, gen: torch.Generator) -> None:
        """N(0, INIT_STD) matrices and unit norms, drawn from ``gen`` in
        parameter-name order (on the generator's device, the CPU)."""
        with torch.no_grad():
            for name, p in sorted(self.named_parameters()):
                if name.endswith("layernorm.weight") or \
                        name == "model.norm.weight":
                    p.fill_(1.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * INIT_STD)


def train_tiny_checkpoint(save_dir: Union[str, Path], steps: int = 400,
                          seed: int = 0, seq_len: int = 64,
                          batch: int = 16, lr: float = 3e-3,
                          num_heads: int = 2, num_kv_heads: int = 1,
                          device: Union[str, torch.device, None] = None):
    """Train :class:`TinyLlama` with Adam on the next-token objective over
    the first 90% of the 4000-word corpus (seed ``seed``) in float32, on
    ``device`` (``cuda:0`` unless the caller names another), and write
    the checkpoint into ``save_dir``.  Initial weights and batch starts
    come from one ``torch.Generator`` seeded with ``seed``.

    Returns ``(train_ids, heldout_ids)`` (int64 arrays: the corpus's
    first 90% and last 10%)."""
    device = resolve_device(device)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    write_tokenizer(save_dir)
    ids = corpus_ids(seed=seed)
    split = int(len(ids) * 0.9)
    train_ids, heldout_ids = ids[:split], ids[split:]

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    model = TinyLlama(num_heads, num_kv_heads)
    model.init_weights(gen)
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    data = torch.from_numpy(train_ids).to(device)
    offsets = torch.arange(seq_len, device=device)
    first = last = None
    for step in range(steps):
        starts = torch.randint(0, len(train_ids) - seq_len - 1, (batch,),
                               generator=gen).to(device)
        loss = model.loss(data[starts[:, None] + offsets])
        opt.zero_grad()
        loss.backward()
        opt.step()
        if step == 0:
            first = float(loss.detach())
        last = loss.detach()
    last = float(last) if last is not None else None
    seconds = time.perf_counter() - t0

    st_io.save_file({k: v.float() for k, v in model.state_dict().items()},
                    save_dir / "model.safetensors")
    (save_dir / "config.json").write_text(
        json.dumps(hf_config(num_heads, num_kv_heads), indent=2))
    (save_dir / "train_metrics.json").write_text(json.dumps(
        {"steps": steps, "first_loss": first, "final_loss": last,
         "seconds": seconds, "device": str(device)}))
    return train_ids, heldout_ids


def read_train_metrics(save_dir: Union[str, Path]) -> Optional[dict]:
    """``train_metrics.json`` of a checkpoint, or None."""
    p = Path(save_dir) / "train_metrics.json"
    return json.loads(p.read_text()) if p.exists() else None
