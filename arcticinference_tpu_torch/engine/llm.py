"""Offline inference API, the port's ``vllm.LLM``:

    from arcticinference_tpu_torch.engine.llm import LLM
    llm = LLM(EngineConfig(...))                  # runs on cuda:0
    outs = llm.generate(prompt_token_ids=[[1, 2, 3]],
                        sampling_params=SamplingParams(max_tokens=32))

``LLM(config, device="cpu")`` runs on the CPU.  Prompts are token ids;
text prompts need a checkpoint that ships a tokenizer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.engine import LLMEngine
from arcticinference_tpu_torch.engine.request import Request, SamplingParams
from arcticinference_tpu_torch.ops.fp8 import FP8_MAX


@dataclass
class RequestOutput:
    req_id: str
    prompt_token_ids: list[int]
    token_ids: list[int]
    text: Optional[str] = None
    finish_reason: str = "stop"
    num_accepted_draft_tokens: int = 0
    num_draft_tokens: int = 0
    #: Per generated token, {token id: logprob} of the top
    #: ``SamplingParams.logprobs`` candidates (None when not asked for).
    logprobs: Optional[list[dict]] = None


def fp8_kv_scales(kv: torch.Tensor, old_scale: torch.Tensor,
                  margin: float = 1.0) -> np.ndarray:
    """Per-layer ``[k_scale, v_scale]`` ([L, 2] float32) that map each
    layer's K and V amax in the fp8 cache ``kv`` [L, N, 2, Bs, Hkv*D] to
    the e4m3 maximum.  The cache holds values divided by ``old_scale``
    (the scales they were written with), so the true amax is the cached
    amax times ``old_scale``."""
    amax = kv.float().abs().amax(dim=(1, 3, 4)) * old_scale.to(kv.device)
    amax = amax.cpu().numpy()
    return np.maximum(amax, 1e-6) / FP8_MAX * margin


class LLM:

    def __init__(self, config: EngineConfig,
                 device: Union[str, torch.device, None] = None):
        self.config = config
        self.engine = LLMEngine(config, device=device)
        self.tokenizer = self._load_tokenizer()
        if self.tokenizer is not None:
            self.engine.tokenizer = self.tokenizer
            if self.engine.eos_token_id is None:
                self.engine.eos_token_id = self.tokenizer.eos_token_id
        self._next_id = 0

    def _load_tokenizer(self):
        path = Path(self.config.model.tokenizer or self.config.model.model)
        if not (path / "tokenizer_config.json").exists() and \
                not (path / "tokenizer.json").exists():
            return None
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(str(path))

    def generate(
        self,
        prompts: Optional[Sequence[str]] = None,
        sampling_params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
        prompt_token_ids: Optional[Sequence[Sequence[int]]] = None,
    ) -> list[RequestOutput]:
        if prompts is None and prompt_token_ids is None:
            raise ValueError("provide prompts or prompt_token_ids")
        if prompt_token_ids is None:
            if self.tokenizer is None:
                raise ValueError(
                    "no tokenizer available; pass prompt_token_ids")
            prompt_token_ids = [self.tokenizer.encode(p) for p in prompts]
        n = len(prompt_token_ids)
        if isinstance(sampling_params, SamplingParams) or \
                sampling_params is None:
            sampling_params = [sampling_params or SamplingParams()] * n

        requests: list[Request] = []
        for ids, sp in zip(prompt_token_ids, sampling_params):
            # n > 1: one engine request per completion.
            for i in range(sp.n):
                rid = f"req-{self._next_id}"
                self._next_id += 1
                sub = sp
                if sp.n > 1:
                    sub = dataclasses.replace(
                        sp, n=1,
                        seed=sp.seed + i if sp.seed is not None else None)
                requests.append(
                    self.engine.add_request(rid, list(ids), sub))

        while self.engine.has_unfinished:
            self.engine.step()

        outputs = []
        for req in requests:
            text = req.final_text  # set when a string stop truncated
            if text is None and self.tokenizer is not None:
                text = self.tokenizer.decode(req.output_token_ids)
            outputs.append(RequestOutput(
                req_id=req.req_id,
                prompt_token_ids=req.prompt_token_ids,
                token_ids=list(req.output_token_ids),
                text=text,
                finish_reason=req.status.name.lower(),
                num_accepted_draft_tokens=req.num_accepted_draft_tokens,
                num_draft_tokens=req.num_draft_tokens,
                logprobs=(req.output_logprobs[:len(req.output_token_ids)]
                          if req.output_logprobs else None),
            ))
        return outputs

    def close(self) -> None:
        """Release the engine's host resources (the suffix prompt-tree
        worker pool); idempotent."""
        self.engine.close()

    def calibrate_kv_scales(self, prompt_token_ids,
                            margin: float = 1.0) -> np.ndarray:
        """Calibrate the fp8 KV cache's per-layer scales from data.

        Prefills ``prompt_token_ids`` once (one output token each), reads
        each layer's K and V amax from the cache (:func:`fp8_kv_scales`)
        and keeps the resulting scales for every later write and read.
        This is how fp8-KV checkpoints ship ``k_scale`` / ``v_scale``;
        for checkpoints without them it derives them.  Returns the
        [L, 2] scales."""
        runner = self.engine.runner
        if runner.kv.dtype != torch.float8_e4m3fn:
            raise ValueError("kv cache is not fp8; nothing to calibrate")
        old = runner.kv_scale.clone()
        self.generate(prompt_token_ids=prompt_token_ids,
                      sampling_params=SamplingParams(max_tokens=1))
        scales = fp8_kv_scales(runner.kv, old, margin)
        runner.kv_scale = torch.from_numpy(scales).to(runner.device)
        return scales
