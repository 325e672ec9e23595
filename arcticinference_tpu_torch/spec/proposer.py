"""ArcticProposer: the host side of the MLP / LSTM draft models.

Counterpart of ``arcticinference_tpu/spec/proposer.py``.  It holds the
speculator's parameters on the engine's device and, after a synchronous
step, drafts for each request the engine hands it: the hidden row of the
request's last accepted token (the runner's sample rows stay on the
device and are gathered there), the request's last token, the unrolled
greedy chain, and one host copy of the ``[B, n_predict]`` drafts.  The
fused decode loop runs the same chain inside its step
(``engine/fused_decode.py``) on :attr:`params`.

``SpeculativeConfig.model`` names a directory with the speculator's
``config.json`` and safetensors shards (read by the port's own reader,
``st_io``); without one the parameters are a random init from a seeded
generator.  A ``distilled_tied`` checkpoint (``spec/distill.py``) holds
only the projections and norms: its embedding and LM head are the
target's own tables, taken live from ``target_params``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.config import SpeculativeConfig
from arcticinference_tpu_torch.models import speculators as spec_mod
from arcticinference_tpu_torch.utils import pad_to_bucket

#: Padded drafter batch sizes (one set of shapes each).
BATCH_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


class ArcticProposer:

    def __init__(self, spec_config: SpeculativeConfig, base_arch,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 target_params: Optional[dict] = None):
        self.config = spec_config
        self.device = device
        cfg_dict = self._load_config(spec_config.model) or {}
        if cfg_dict.get("distilled_tied"):
            # Projections from the checkpoint; embedding and LM head are
            # the target's (an fp8 head runs fp8_matmul_kernel).
            if target_params is None:
                raise ValueError(
                    "distilled_tied drafter needs the target params")
            from arcticinference_tpu_torch.spec.distill import load_distilled

            self.kind = "mlp"
            self._gen = spec_mod.mlp_generate_proposals
            self.params, self.arch = load_distilled(
                spec_config.model, cfg_dict, target_params, device)
            self.n_predict = min(self.arch.n_predict,
                                 spec_config.num_speculative_tokens)
            return
        method = cfg_dict.get("method", "sum_rnn")
        archs = cfg_dict.get("architectures") or []
        base = dict(cfg_dict)
        base.setdefault("vocab_size", base_arch.vocab_size)
        base.setdefault("n_predict", spec_config.num_speculative_tokens)
        if method == "sum_lstm" or any("LSTM" in a for a in archs):
            self.kind = "lstm"
            base.setdefault("input_hidden_dim", base_arch.hidden_size)
            self.arch = spec_mod.LSTMSpecArch.from_hf_config(base)
            self._gen = spec_mod.lstm_generate_proposals
        else:
            self.kind = "mlp"
            base.setdefault("emb_dim", base_arch.hidden_size)
            self.arch = spec_mod.MLPSpecArch.from_hf_config(base)
            self._gen = spec_mod.mlp_generate_proposals
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.params = self._load_params(spec_config.model, generator)
        if spec_config.quantization:
            self.params = spec_mod.quantize_spec_params(
                self.params, spec_config.quantization)
        self.n_predict = min(self.arch.n_predict,
                             spec_config.num_speculative_tokens)

    # -- loading --------------------------------------------------------

    @staticmethod
    def _load_config(model: Optional[str]) -> Optional[dict]:
        if model is None:
            return None
        p = Path(model) / "config.json"
        return json.loads(p.read_text()) if p.exists() else None

    def _load_params(self, model: Optional[str],
                     generator: torch.Generator) -> dict:
        files = []
        if model is not None and Path(model).is_dir():
            files = sorted(Path(model).glob("*.safetensors"))
        if files:
            tensors: dict[str, torch.Tensor] = {}
            for f in files:
                tensors.update(st_io.load_file(f))
            load = (spec_mod.load_lstm_state if self.kind == "lstm"
                    else spec_mod.load_mlp_state)
            return load(self.arch, tensors, device=self.device)
        init = (spec_mod.lstm_init_params if self.kind == "lstm"
                else spec_mod.mlp_init_params)
        return init(self.arch, generator, device=self.device)

    # -- proposing ------------------------------------------------------

    def generate(self, params: dict, last_tokens: torch.Tensor,
                 hidden: torch.Tensor) -> torch.Tensor:
        """The greedy chain on the device: [B] last tokens and [B, hidden]
        rows -> [B, n_predict] int32 drafts."""
        return self._gen(params, self.arch, last_tokens, hidden,
                         self.n_predict)

    @torch.inference_mode()
    def propose(self, drafter_reqs, rows: torch.Tensor,
                accepted_row: dict[str, int], max_len_cap: int) -> None:
        """Fill ``req.spec_token_ids`` of each scheduled request in
        ``drafter_reqs`` that committed this step.

        rows: [S_pad, hidden] sample-row hidden states of the step, on the
        device; ``accepted_row[req_id]`` is the row of the request's last
        accepted token.  Drafts are cut so that a request never runs past
        ``max_len_cap`` tokens.
        """
        items = [(s.request, accepted_row[s.request.req_id])
                 for s in drafter_reqs
                 if s.request.req_id in accepted_row]
        if not items:
            return
        b_pad = pad_to_bucket(len(items), BATCH_BUCKETS)
        idx_tok = np.zeros((2, b_pad), np.int32)
        for i, (req, row) in enumerate(items):
            idx_tok[0, i] = row
            idx_tok[1, i] = req.all_token_ids[-1]
        dev = torch.from_numpy(idx_tok).to(rows.device)
        hidden = rows[dev[0].long()]
        drafts = self.generate(self.params, dev[1], hidden).cpu().numpy()
        for i, (req, _) in enumerate(items):
            cap = max_len_cap - req.num_tokens - 1
            if cap <= 0:
                continue
            req.spec_token_ids = [int(t) for t in drafts[i][:cap]]
