"""Encoder runner: batched one-shot embedding forward with shape buckets.

Counterpart of ``arcticinference_tpu/engine/encoder.py``.  The decode
engine's paged machinery is dead weight for encoders, so ``LLM`` and the
OpenAI server route encoder architectures (``module.IS_ENCODER``) here
instead of ``LLMEngine``.  Shapes are bucketed as in the JAX package (a
power-of-two batch up to ``max_num_seqs``, a power-of-two token length
from 16 up to ``min(max_model_len, max_position_embeddings)``), so the
same prompt list splits into the same device batches; pooling runs on
the device, so only ``[B, D]`` comes back to the host.
"""

from __future__ import annotations

from typing import Iterator, Union

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.models.loader import load_model
from arcticinference_tpu_torch.utils import resolve_device


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class EncoderRunner:

    def __init__(self, config: EngineConfig,
                 device: Union[str, torch.device, None] = None):
        if config.parallel.world_size > 1:
            # The JAX EncoderRunner runs one device whatever the config
            # says; the port refuses rather than run a mesh config there.
            raise NotImplementedError(
                "encoder models run on one device; a parallel config of "
                f"world size {config.parallel.world_size} does not apply")
        self.config = config
        self.device = resolve_device(device)
        self.module, self.arch, self.params = load_model(config.model,
                                                         self.device)
        self.max_len = min(config.model.max_model_len,
                           getattr(self.arch, "max_position_embeddings",
                                   config.model.max_model_len))
        self.max_batch = config.scheduler.max_num_seqs

    def batches(self, prompt_token_ids) -> Iterator[list[list[int]]]:
        """The device batches of a prompt list, each prompt truncated to
        ``max_len``: a batch closes before the prompt that would take its
        bucketed tokens past ``max_num_batched_tokens`` or its size past
        ``max_num_seqs``."""
        budget = self.config.scheduler.max_num_batched_tokens
        batch: list[list[int]] = []
        total = 0
        for ids in prompt_token_ids:
            ids = list(ids)[: self.max_len]
            cost = _bucket(max(len(ids), 1), 16, self.max_len)
            if batch and (total + cost > budget
                          or len(batch) >= self.max_batch):
                yield batch
                batch, total = [], 0
            batch.append(ids)
            total += cost
        if batch:
            yield batch

    def bucket(self, batch: list[list[int]]) -> tuple[int, int]:
        """(rows, tokens) of the padded device batch for ``batch``."""
        return (_bucket(len(batch), 1, self.max_batch),
                _bucket(max(len(x) for x in batch), 16, self.max_len))

    def inputs(self, batch: list[list[int]]) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
        """The padded ``input_ids`` and ``attention_mask`` [B, T] of
        ``batch`` on the device."""
        b, t = self.bucket(batch)
        ids = np.full((b, t), self.arch.pad_token_id, np.int32)
        mask = np.zeros((b, t), np.int32)
        for i, x in enumerate(batch):
            ids[i, : len(x)] = x
            mask[i, : len(x)] = 1
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @torch.inference_mode()
    def pooled(self, ids: torch.Tensor, mask: torch.Tensor,
               pooling: str = "mean", normalize: bool = True
               ) -> torch.Tensor:
        """Forward and pooling of one padded batch: float32 [B, D] on the
        device (nothing is read back)."""
        h = self.module.forward(self.params, self.arch,
                                {"input_ids": ids, "attention_mask": mask})
        return self.module.pool(h, mask, method=pooling, normalize=normalize)

    def encode(self, prompt_token_ids, pooling: str = "mean",
               normalize: bool = True) -> list[np.ndarray]:
        """One float32 embedding per prompt, in order."""
        out: list[np.ndarray] = []
        for batch in self.batches(prompt_token_ids):
            pooled = self.pooled(*self.inputs(batch), pooling,
                                 normalize).cpu().numpy()
            out.extend(pooled[i] for i in range(len(batch)))
        return out
