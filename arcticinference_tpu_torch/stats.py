"""Engine metrics.

Speculative-decoding acceptance accounting mirrors the reference's
``SpecDecodingStats`` with its variable-draft-length extension (reference
``vllm/stats.py:26-69``): per-position acceptance arrays grow on demand
because suffix drafts have no fixed length.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class SpecDecodingStats:
    num_drafts: int = 0
    num_draft_tokens: int = 0
    num_accepted_tokens: int = 0
    # accepted count per draft position (grows with longest draft seen)
    num_accepted_tokens_per_pos: list[int] = field(default_factory=list)

    def observe(self, num_draft_tokens: int, num_accepted: int) -> None:
        self.num_drafts += 1
        self.num_draft_tokens += num_draft_tokens
        self.num_accepted_tokens += num_accepted
        if num_draft_tokens > len(self.num_accepted_tokens_per_pos):
            self.num_accepted_tokens_per_pos.extend(
                [0] * (num_draft_tokens
                       - len(self.num_accepted_tokens_per_pos)))
        for i in range(num_accepted):
            self.num_accepted_tokens_per_pos[i] += 1

    @property
    def mean_accepted_per_draft(self) -> float:
        if self.num_drafts == 0:
            return 0.0
        return self.num_accepted_tokens / self.num_drafts

    @property
    def acceptance_rate(self) -> float:
        if self.num_draft_tokens == 0:
            return 0.0
        return self.num_accepted_tokens / self.num_draft_tokens

    def summary(self) -> dict:
        return {
            "num_drafts": self.num_drafts,
            "num_draft_tokens": self.num_draft_tokens,
            "num_accepted_tokens": self.num_accepted_tokens,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "mean_accepted_per_draft":
                round(self.mean_accepted_per_draft, 4),
            "per_pos": list(self.num_accepted_tokens_per_pos),
        }


@dataclass
class EngineStats:
    """Rolling engine counters for the logging loop."""

    start_time: float = field(default_factory=time.time)
    num_steps: int = 0
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0
    num_finished: int = 0

    def tokens_per_second(self) -> float:
        dt = time.time() - self.start_time
        return self.num_generated_tokens / dt if dt > 0 else 0.0


class StepTimeStats:
    """Bounded per-step wall-time histogram, split by step kind (the
    port's synchronous step records ``decode`` for pure-decode steps,
    ``verify`` for steps that verify drafts without prompt rows and
    ``mixed`` for the others; an iteration of the fused decode loop
    records ``fused``, with the tokens its drains committed), with each
    kind's total time and tokens emitted.

    The reference has no engine-side timing of its own (SURVEY §5.1 —
    it leans on vLLM's profiler); here per-step timing is first-class
    so /metrics can answer "what is this engine doing right now"
    without a trace."""

    def __init__(self, window: int = 2048) -> None:
        from collections import deque

        self.window = window
        self._times: dict[str, object] = {}
        self._counts: dict[str, int] = {}
        self._total_s: dict[str, float] = {}
        self._tokens: dict[str, int] = {}

    def observe(self, kind: str, seconds: float, tokens: int = 0) -> None:
        from collections import deque

        dq = self._times.get(kind)
        if dq is None:
            dq = self._times[kind] = deque(maxlen=self.window)
        dq.append(seconds)
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self._total_s[kind] = self._total_s.get(kind, 0.0) + seconds
        self._tokens[kind] = self._tokens.get(kind, 0) + tokens

    def summary(self) -> dict:
        out = {}
        for kind, dq in self._times.items():
            xs = sorted(dq)
            n = len(xs)
            if not n:
                continue
            out[kind] = {
                "count": self._counts[kind],
                "p50_ms": round(xs[n // 2] * 1e3, 2),
                "p90_ms": round(xs[min(n - 1, (n * 9) // 10)] * 1e3, 2),
                "p99_ms": round(xs[min(n - 1, (n * 99) // 100)] * 1e3, 2),
                "max_ms": round(xs[-1] * 1e3, 2),
                "total_s": self._total_s[kind],
                "tokens": self._tokens[kind],
            }
        return out
