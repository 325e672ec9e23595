"""Offline suffix-decoding simulator.

Counterpart of ``arcticinference_tpu/spec/simulator.py`` over the port's
suffix cache (the reference's ``common/suffix_cache/simulator.py``):
replay ground-truth (prompt, response) pairs against a SuffixCache and
measure what speculation would have achieved — accepted tokens per step,
acceptance rate, per-request speedup estimate — without any accelerator.
Used to tune ``max_spec_tokens / max_spec_factor / min_token_prob`` before
serving, and as a quality oracle in tests.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache


@dataclass
class RequestSim:
    req_id: str
    prompt: list[int]
    response: list[int]
    steps: int = 0
    accepted: int = 0
    drafted: int = 0
    spec_time_s: float = 0.0

    @property
    def mean_accepted_per_step(self) -> float:
        return self.accepted / self.steps if self.steps else 0.0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def est_speedup(self) -> float:
        """Tokens emitted per model step vs 1 for plain decoding."""
        return (len(self.response) / self.steps) if self.steps else 1.0


@dataclass
class SimulationResult:
    requests: list[RequestSim] = field(default_factory=list)

    def summary(self) -> dict:
        total_steps = sum(r.steps for r in self.requests)
        total_tokens = sum(len(r.response) for r in self.requests)
        total_acc = sum(r.accepted for r in self.requests)
        total_drafted = sum(r.drafted for r in self.requests)
        spec_time = sum(r.spec_time_s for r in self.requests)
        return {
            "num_requests": len(self.requests),
            "total_tokens": total_tokens,
            "total_steps": total_steps,
            "mean_accepted_per_step":
                round(total_acc / total_steps, 4) if total_steps else 0.0,
            "acceptance_rate":
                round(total_acc / total_drafted, 4) if total_drafted
                else 0.0,
            "est_speedup":
                round(total_tokens / total_steps, 4) if total_steps
                else 1.0,
            "spec_time_per_step_us":
                round(spec_time / total_steps * 1e6, 1) if total_steps
                else 0.0,
        }

    def per_request(self) -> list[dict]:
        return [{
            "req_id": r.req_id,
            "response_tokens": len(r.response),
            "steps": r.steps,
            "mean_accepted_per_step": round(r.mean_accepted_per_step, 3),
            "acceptance_rate": round(r.acceptance_rate, 3),
            "est_speedup": round(r.est_speedup, 3),
        } for r in self.requests]


def suffix_decode_sim(
    cache: SuffixCache,
    req: RequestSim,
    max_spec_tokens: int = 16,
    max_spec_factor: float = 1.0,
    max_spec_offset: float = 0.0,
    min_token_prob: float = 0.1,
) -> None:
    """Replay one request: at each step speculate, accept the matching
    prefix (greedy ground truth), advance by accepted+1."""
    cache.cache_prompt(req.req_id, req.prompt)
    pos = 0
    resp = req.response
    generated: list[int] = []
    while pos < len(resp):
        pattern = (req.prompt + generated)[-cache.max_depth:]
        t0 = time.perf_counter()
        result = cache.speculate(
            req.req_id, pattern,
            max_spec_tokens=max_spec_tokens,
            max_spec_factor=max_spec_factor,
            max_spec_offset=max_spec_offset,
            min_token_prob=min_token_prob)
        req.spec_time_s += time.perf_counter() - t0
        n_acc = 0
        for i, tok in enumerate(result.token_ids):
            if pos + i < len(resp) and tok == resp[pos + i]:
                n_acc += 1
            else:
                break
        req.drafted += len(result.token_ids)
        req.accepted += n_acc
        req.steps += 1
        advance = n_acc + 1  # accepted + the model's own next token
        new = resp[pos:pos + advance]
        generated.extend(new)
        cache.update_response(req.req_id, new)
        pos += advance
    cache.evict_prompt(req.req_id)


def simulate(
    dataset: Iterable[tuple[Sequence[int], Sequence[int]]],
    max_depth: int = 64,
    max_spec_tokens: int = 16,
    max_spec_factor: float = 1.0,
    max_spec_offset: float = 0.0,
    min_token_prob: float = 0.1,
) -> SimulationResult:
    """Run the simulator over (prompt, response) token-id pairs."""
    cache = SuffixCache(max_depth=max_depth)
    result = SimulationResult()
    for i, (prompt, response) in enumerate(dataset):
        req = RequestSim(req_id=f"sim-{i}", prompt=list(prompt),
                         response=list(response))
        suffix_decode_sim(cache, req, max_spec_tokens, max_spec_factor,
                          max_spec_offset, min_token_prob)
        result.requests.append(req)
    return result


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Suffix-decoding offline simulator: feed a JSONL "
                    "dataset of {prompt_token_ids, response_token_ids}")
    parser.add_argument("dataset")
    parser.add_argument("--max-depth", type=int, default=64)
    parser.add_argument("--max-spec-tokens", type=int, default=16)
    parser.add_argument("--max-spec-factor", type=float, default=1.0)
    parser.add_argument("--min-token-prob", type=float, default=0.1)
    parser.add_argument("--per-request", action="store_true")
    args = parser.parse_args()

    def rows():
        with open(args.dataset) as f:
            for line in f:
                d = json.loads(line)
                yield d["prompt_token_ids"], d["response_token_ids"]

    res = simulate(rows(), max_depth=args.max_depth,
                   max_spec_tokens=args.max_spec_tokens,
                   max_spec_factor=args.max_spec_factor,
                   min_token_prob=args.min_token_prob)
    print(json.dumps(res.summary(), indent=2))
    if args.per_request:
        for row in res.per_request():
            print(json.dumps(row))


if __name__ == "__main__":
    main()
