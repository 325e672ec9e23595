"""Drafter distillation against the running target model.

Counterpart of ``arcticinference_tpu/spec/distill.py`` (optax becomes
``torch.optim.Adam`` with optax's defaults, PRNG keys become seeded
``torch.Generator``\\ s):

1. :func:`capture_pairs`: greedy generation over a prompt set with a
   :class:`HiddenCapture` hook installed on the engine, collecting
   ``(hidden_t, x_{t+1}, x_{t+2..t+1+K})``: the supervision the drafter
   sees at inference time (the hidden row of the last accepted token and
   the token it emitted predict the next K).
2. :func:`distill_mlp`: trains the MLP speculator chain (teacher-forced
   cross-entropy per head).  The drafter's embedding and LM head are the
   target's own tables, frozen (fp8 when the target is quantized; the
   training product then runs on the table dequantized to bf16, as XLA's
   fused dequant did for the JAX package), so only the per-head
   projections and norms train.
3. :func:`save_distilled` / :func:`load_distilled`: a safetensors
   checkpoint (the port's own reader and writer, ``st_io``) with
   ``distilled_tied: true`` in its config.json; ``ArcticProposer`` takes
   the tied tables live from the target's parameters, so in an fp8 target
   the drafter's head product runs ``fp8_matmul_kernel``.

:func:`distill_lstm` / :func:`save_lstm` train and save a full
``sum_lstm`` drafter (its own embedding and head) in the HF layout
``load_lstm_state`` reads.

Training runs on fresh tensors built from the captured numpy arrays and
on tables read outside inference mode (``runner.execute`` and the fused
step run under ``torch.inference_mode()``, whose tensors autograd cannot
save).
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.models.speculators import (LSTMSpecArch,
                                                          MLPSpecArch, SQRT2,
                                                          _embed, _mm,
                                                          _mlp_head_params)
from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear, fp8_dequantize
from arcticinference_tpu_torch.ops.layers import l2_norm_scaled
from arcticinference_tpu_torch.utils import resolve_device

logger = logging.getLogger("arcticinference_tpu_torch")

# optax.adam's defaults.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# --------------------------------------------------------------------- #
# Capture: the engine hook and the capture run
# --------------------------------------------------------------------- #

class HiddenCapture:
    """Engine hook recording (hidden row, emitted token) per request.

    Install as ``engine.hidden_capture``; the synchronous step and the
    fused loop's drain call it with a block of hidden rows (a device
    tensor or a host array) and ``[(req_id, row, emitted_token)]``.  Rows
    are kept as float32 numpy arrays (exact for bf16 and float32
    models).
    """

    def __init__(self):
        self.seqs: dict[str, tuple[list, list]] = {}

    def __call__(self, rows, items) -> None:
        rows_np = None
        for req_id, row_idx, token in items:
            if rows_np is None:
                rows_np = (rows.detach().float().cpu().numpy()
                           if isinstance(rows, torch.Tensor)
                           else np.asarray(rows, np.float32))
            h_list, t_list = self.seqs.setdefault(req_id, ([], []))
            h_list.append(rows_np[row_idx].copy())
            t_list.append(int(token))

    def pairs(self, n_predict: int):
        """Captured trajectories as training arrays: (hidden [N, D] f32,
        tok0 [N] int32, targets [N, K] int32, mask [N, K] f32); targets
        are the next K tokens the target emitted, masked past each
        trajectory's end."""
        hs, t0s, tgts, masks = [], [], [], []
        for h_list, t_list in self.seqs.values():
            n = len(t_list)
            for i in range(n - 1):
                hs.append(h_list[i])
                t0s.append(t_list[i])
                tgt = t_list[i + 1:i + 1 + n_predict]
                m = [1.0] * len(tgt)
                while len(tgt) < n_predict:
                    tgt.append(0)
                    m.append(0.0)
                tgts.append(tgt)
                masks.append(m)
        if not hs:
            raise ValueError("no pairs captured")
        return (np.stack(hs), np.asarray(t0s, np.int32),
                np.asarray(tgts, np.int32), np.asarray(masks, np.float32))


def capture_pairs(llm, prompt_token_ids, gen_len: int, n_predict: int):
    """Greedy generation over ``prompt_token_ids`` capturing supervision
    pairs (see :meth:`HiddenCapture.pairs`).

    Two engine configurations capture:

    - no speculative config: plain greedy decode, one pair per request
      per step;
    - a speculative config (spec-shaped capture): verify-shaped steps
      (K+1 rows per request; the fused loop when enabled), each committed
      token paired with its verify row's hidden.  This is the
      configuration the spec bench measures, and on a random-weight
      target the only capture that transfers: greedy argmax at a 128k
      vocabulary flips under a change of program (another token bucket,
      a prefix-cache prefill, another fused program), so the trajectory,
      and with it the drafter's acceptance, reproduces only under the
      steps it was captured from.  Disable prefix caching in both runs
      for the same reason.
    """
    from arcticinference_tpu_torch.engine.request import SamplingParams

    eng = llm.engine
    cap = HiddenCapture()
    eng.hidden_capture = cap
    try:
        llm.generate(prompt_token_ids=prompt_token_ids,
                     sampling_params=SamplingParams(max_tokens=gen_len,
                                                    ignore_eos=True))
    finally:
        eng.hidden_capture = None
    return cap.pairs(n_predict)


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #

def _tied_tables(target_params):
    """The target model's (embedding, lm_head) leaves, used frozen."""
    head = target_params.get("lm_head")
    if head is None:
        raise ValueError(
            "distilled_tied drafters need an untied target lm_head "
            "(tie_word_embeddings models would require a transposed "
            "gather of the shared table)")
    return target_params["embed"], head


def _table_shape(t) -> tuple:
    return tuple(t.weight.shape if isinstance(t, QuantizedLinear)
                 else t.shape)


def _trainable_head(head):
    """The frozen head as a plain tensor autograd can multiply: a
    quantized table dequantized to bf16 (XLA's fused dequant in the JAX
    package), a plain one as it is, outside inference mode."""
    if isinstance(head, QuantizedLinear):
        return fp8_dequantize(head, torch.bfloat16)
    return head.detach().clone()


def _train_head_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The head product in training: a bf16 table (a dequantized fp8 one)
    by one bf16 ``torch.matmul`` widened to float32 (autograd has no
    float32-output bf16 product), any other as the drafter's ``_mm``."""
    if w.dtype == torch.bfloat16:
        return torch.matmul(x.to(torch.bfloat16), w).float()
    return _mm(x, w)


def _chain_logits(params, arch: MLPSpecArch, hidden, tok0, targets,
                  head_mm=_mm):
    """Teacher-forced drafter chain; yields per-head float32 logits
    (the head product by ``head_mm``)."""
    state = hidden.float()
    if arch.scale_input:
        state = l2_norm_scaled(state, None, None) / SQRT2
    tok = tok0
    alpha = arch.emb_weight / arch.state_weight
    out = []
    for i in range(arch.n_predict):
        e, p, h, lw, lb = _mlp_head_params(params, arch, i)
        states = _mm(state, p) + alpha * _embed(e, tok)
        states = F.gelu(l2_norm_scaled(states, lw, lb).float())
        out.append(head_mm(states, h))
        tok = targets[:, i]          # teacher forcing
        state = states
    return out


def _chain_loss(logits, tgt, m):
    """Sum over heads of the masked mean cross-entropy."""
    total = 0.0
    for i, lg in enumerate(logits):
        ce = torch.logsumexp(lg, dim=-1) - torch.gather(
            lg, 1, tgt[:, i:i + 1].long())[:, 0]
        total = total + (ce * m[:, i]).sum() / m[:, i].sum().clamp(min=1.0)
    return total


def _head_accuracy(logits, tgt, m) -> torch.Tensor:
    return torch.stack([
        ((lg.argmax(dim=-1).to(torch.int32) == tgt[:, i]) * m[:, i]).sum()
        / m[:, i].sum().clamp(min=1.0) for i, lg in enumerate(logits)])


def _full_set_accuracy(chain, data, mask: np.ndarray, batch_size: int,
                       n_predict: int) -> np.ndarray:
    """Per-head accuracy over all pairs, in ``batch_size`` windows (the
    last one shifted back to full size, as the JAX function does)."""
    n = data[0].shape[0]
    accs = np.zeros(n_predict, np.float64)
    wsum = np.zeros(n_predict, np.float64)
    with torch.no_grad():
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            if hi - lo < batch_size:
                lo = max(0, hi - batch_size)
            h, t0, tgt, m = (x[lo:hi] for x in data)
            a = _head_accuracy(chain(h, t0, tgt), tgt, m)
            msum = mask[lo:hi].sum(0)
            accs += a.cpu().numpy() * msum
            wsum += msum
    return accs / np.maximum(wsum, 1.0)


def _train(loss_fn, train: dict, data, steps: int, batch_size: int,
           lr: float, seed: int, log_every: int, what: str) -> None:
    """Adam (optax's defaults) on ``train`` over random batches of
    ``data`` drawn from a generator seeded with ``seed + 1``."""
    leaves = [t for v in train.values()
              for t in (v if isinstance(v, list) else [v])]
    opt = torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    n = data[0].shape[0]
    dev = data[0].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for step in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
        loss = loss_fn(*(x[idx] for x in data))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (step + 1) % log_every == 0:
            logger.info("%s step %d: loss %.4f", what, step + 1,
                        float(loss.detach()))


def _on(device, hidden, tok0, targets, mask):
    return (torch.as_tensor(np.asarray(hidden, np.float32), device=device),
            torch.as_tensor(np.asarray(tok0, np.int32), device=device),
            torch.as_tensor(np.asarray(targets, np.int32), device=device),
            torch.as_tensor(np.asarray(mask, np.float32), device=device))


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1 / shape[0]) from ``gen`` (on the CPU), on ``device``."""
    return (torch.randn(shape, generator=gen) / math.sqrt(shape[0])).to(
        device)


def distill_mlp(target_params, hidden, tok0, targets, mask,
                n_predict: int = 3, steps: int = 400,
                batch_size: int = 1024, lr: float = 1e-3,
                seed: int = 0, log_every: int = 100):
    """Train a tied-table MLP drafter to predict the target's next K
    tokens from its hidden states (numpy arrays from
    :func:`capture_pairs`), on the device of the target's tables.

    Returns ``(params, arch, per_head_accuracy)``: params in the
    inference layout (float32 projections; embedding and head are the
    target's own tables).
    """
    emb_t, head_t = _tied_tables(target_params)
    d = hidden.shape[1]
    vocab = _table_shape(head_t)[-1]
    arch = MLPSpecArch(vocab_size=int(vocab), emb_dim=int(d),
                       inner_dim=int(d), n_predict=n_predict,
                       tie_weights=False, scale_input=True)
    device = (head_t.weight if isinstance(head_t, QuantizedLinear)
              else head_t).device
    gen = torch.Generator().manual_seed(seed)
    train = {
        "proj": [_normal(gen, (d, d), device).requires_grad_()
                 for _ in range(n_predict)],
        "ln_w": [torch.ones(d, device=device, requires_grad=True)
                 for _ in range(n_predict)],
        "ln_b": [torch.zeros(d, device=device, requires_grad=True)
                 for _ in range(n_predict)],
    }
    head_train = _trainable_head(head_t)

    def full(tr, head):
        return {"emb": [emb_t] * n_predict, "head": [head] * n_predict,
                **tr}

    def chain(h, t0, tgt):
        return _chain_logits(full(train, head_train), arch, h, t0, tgt,
                             head_mm=_train_head_mm)

    data = _on(device, hidden, tok0, targets, mask)
    batch_size = min(batch_size, data[0].shape[0])
    _train(lambda h, t0, tgt, m: _chain_loss(chain(h, t0, tgt), tgt, m),
           train, data, steps, batch_size, lr, seed, log_every, "distill")
    per_head = _full_set_accuracy(chain, data, mask, batch_size, n_predict)
    logger.info("distill done: per-head accuracy %s",
                np.round(per_head, 4).tolist())
    del head_train
    trained = {k: [t.detach() for t in v] for k, v in train.items()}
    return full(trained, head_t), arch, per_head


def _lstm_chain_logits(params, arch: LSTMSpecArch, hidden, tok0, targets):
    """Teacher-forced sum_lstm chain (``lstm_chain`` with the argmax
    feedback replaced by the target's next token); per-head float32
    logits."""
    b = hidden.shape[0]
    p0 = arch.proj_dim[0]
    state = hidden.float()
    if arch.scale_input:
        state = l2_norm_scaled(state, None, None) / SQRT2
    cell = torch.zeros((b, arch.inner_dim[0]), dtype=torch.float32,
                       device=hidden.device)
    tok = tok0
    alpha = arch.emb_weight / arch.state_weight
    out = []
    for i in range(arch.n_predict):
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
        out.append(_mm(state, params["head"]))
        tok = targets[:, i]          # teacher forcing
    return out


def distill_lstm(hidden_dim: int, vocab_size: int, hidden, tok0, targets,
                 mask, n_predict: int = 3, steps: int = 400,
                 batch_size: int = 1024, lr: float = 1e-3, seed: int = 0,
                 log_every: int = 100, device=None):
    """Train a full ``sum_lstm`` drafter (its own embedding and head; the
    cell consumes a 4x-tiled forget embedding that has no tied-table
    counterpart) on captured pairs, on ``device`` (``cuda:0`` unless the
    caller names another).  Returns ``(params, LSTMSpecArch,
    per_head_accuracy)`` in the layout of ``lstm_chain``."""
    device = resolve_device(device)
    d = int(hidden_dim)
    arch = LSTMSpecArch(vocab_size=int(vocab_size), input_hidden_dim=d,
                        emb_dim=(d,), inner_dim=(d,), proj_dim=(d,),
                        n_predict=n_predict)
    gen = torch.Generator().manual_seed(seed)

    def w(shape):
        return _normal(gen, shape, device).requires_grad_()

    def const(fill):
        return torch.full((d,), fill, device=device, requires_grad=True)

    train = {
        "forget_emb": w((arch.vocab_size, arch.emb_dim[0])),
        "proj_first": w((d, d * 4)),
        "proj_rest": w((d, d * 4)),
        "cell_ln_w": const(1.0),
        "cell_ln_b": const(0.0),
        "state_ln_w": const(1.0),
        "state_ln_b": const(0.0),
        "head": w((d, arch.vocab_size)),
    }

    def chain(h, t0, tgt):
        return _lstm_chain_logits(train, arch, h, t0, tgt)

    data = _on(device, hidden, tok0, targets, mask)
    batch_size = min(batch_size, data[0].shape[0])
    _train(lambda h, t0, tgt, m: _chain_loss(chain(h, t0, tgt), tgt, m),
           train, data, steps, batch_size, lr, seed, log_every,
           "lstm distill")
    per_head = _full_set_accuracy(chain, data, mask, batch_size, n_predict)
    logger.info("lstm distill done: per-head accuracy %s",
                np.round(per_head, 4).tolist())
    return {k: v.detach() for k, v in train.items()}, arch, per_head


def save_lstm(out_dir, params: dict, arch: LSTMSpecArch,
              metrics: Optional[dict] = None) -> None:
    """Write a trained sum_lstm drafter in the HF layout
    ``load_lstm_state`` reads (projections and head transposed back to
    ``[out, in]``; the writer stores each tensor's values, so a
    transposed view is written as its values)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def t(x):
        return torch.as_tensor(x).T

    tensors = {
        "forget_emb.0.weight": torch.as_tensor(params["forget_emb"]),
        "projs.0.weight": t(params["proj_first"]),
        "projs.1.weight": t(params["proj_rest"]),
        "cell_ln.0.weight": torch.as_tensor(params["cell_ln_w"]),
        "cell_ln.0.bias": torch.as_tensor(params["cell_ln_b"]),
        "state_ln.0.weight": torch.as_tensor(params["state_ln_w"]),
        "state_ln.0.bias": torch.as_tensor(params["state_ln_b"]),
        "head.0.weight": t(params["head"]),
    }
    st_io.save_file(tensors, out / "model.safetensors")
    cfg = {
        "method": "sum_lstm",
        "architectures": ["ArcticLSTMSpeculator"],
        "n_predict": arch.n_predict,
        "input_hidden_dim": arch.input_hidden_dim,
        "emb_dim": list(arch.emb_dim),
        "inner_dim": list(arch.inner_dim),
        "proj_dim": list(arch.proj_dim),
        "vocab_size": arch.vocab_size,
        "tie_weights": True,
        "tie_lstm_embs": True,
        "scale_input": arch.scale_input,
    }
    if metrics:
        cfg["distill_metrics"] = metrics
    (out / "config.json").write_text(json.dumps(cfg, indent=2))


# --------------------------------------------------------------------- #
# Checkpoint format ("distilled_tied")
# --------------------------------------------------------------------- #

def init_tied_drafter(target_params, n_predict: int = 3,
                      seed: int = 0) -> tuple:
    """A random tied-table drafter of the distilled architecture (float32
    projections on the CPU, from a generator seeded with ``seed``).

    Spec-shaped capture runs the engine with this drafter, so the fused
    steps of capture are those the trained drafter runs at bench time:
    only the weights differ.  ``target_params`` is the target's parameter
    dict or a ``(hidden_size, vocab_size)`` tuple.
    """
    if isinstance(target_params, tuple):
        d, vocab = target_params
    else:
        emb_t, head_t = _tied_tables(target_params)
        d = _table_shape(emb_t)[-1]
        vocab = _table_shape(head_t)[-1]
    arch = MLPSpecArch(vocab_size=int(vocab), emb_dim=int(d),
                       inner_dim=int(d), n_predict=n_predict,
                       tie_weights=False, scale_input=True)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "proj": [_normal(gen, (d, d), "cpu") for _ in range(n_predict)],
        "ln_w": [torch.ones(d) for _ in range(n_predict)],
        "ln_b": [torch.zeros(d) for _ in range(n_predict)],
    }
    return params, arch


def save_distilled(out_dir, params: dict, arch: MLPSpecArch,
                   metrics: Optional[dict] = None) -> None:
    """Write the trained projections (``[in, out]``, as the JAX package
    writes them) and norms with a config.json; the tables stay tied."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tensors = {}
    for i in range(arch.n_predict):
        tensors[f"proj.{i}.weight"] = torch.as_tensor(params["proj"][i])
        tensors[f"ln.{i}.weight"] = torch.as_tensor(params["ln_w"][i])
        tensors[f"ln.{i}.bias"] = torch.as_tensor(params["ln_b"][i])
    st_io.save_file(tensors, out / "model.safetensors")
    cfg = {
        "method": "sum_rnn",
        "architectures": ["ArcticMLPSpeculatorDistilled"],
        "distilled_tied": True,
        "n_predict": arch.n_predict,
        "emb_dim": arch.emb_dim,
        "inner_dim": arch.inner_dim,
        "vocab_size": arch.vocab_size,
        "tie_weights": False,
        "scale_input": arch.scale_input,
    }
    if metrics:
        cfg["distill_metrics"] = metrics
    (out / "config.json").write_text(json.dumps(cfg, indent=2))


def load_distilled(model_dir, cfg: dict, target_params,
                   device="cpu") -> tuple:
    """A distilled_tied checkpoint as (params, MLPSpecArch): its tensors
    on ``device`` in their stored dtype, the tables the target's own."""
    emb_t, head_t = _tied_tables(target_params)
    arch = MLPSpecArch.from_hf_config(cfg)
    n = arch.n_predict
    tensors = st_io.load_file(Path(model_dir) / "model.safetensors", device)
    return {
        "emb": [emb_t] * n,
        "head": [head_t] * n,
        "proj": [tensors[f"proj.{i}.weight"] for i in range(n)],
        "ln_w": [tensors[f"ln.{i}.weight"] for i in range(n)],
        "ln_b": [tensors[f"ln.{i}.bias"] for i in range(n)],
    }, arch
