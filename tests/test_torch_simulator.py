"""The port's offline suffix-decoding simulator (``spec/simulator.py``)
against the JAX package's.

The JAX tests' cases (repetitive responses accelerate, random ones do
not, a response that echoes its prompt drafts from the prompt tree), and
on several datasets the simulators' statistics (every field of
``summary()`` but the host-time one, and every ``per_request()`` row)
equal the JAX simulator's: the port's native suffix tree against the JAX
package's native tree, and the port's Python twin against the JAX
package's twin (``ARCTIC_TPU_PURE_PYTHON_SUFFIX=1``).  The CLI reads a
JSONL dataset.
"""

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from arcticinference_tpu.spec.simulator import simulate as jax_simulate
from arcticinference_tpu_torch.spec.simulator import simulate

REPO = Path(__file__).resolve().parents[1]


def test_repetitive_responses_accelerate():
    # The second identical response drafts almost entirely from the
    # first one via the global tree.
    prompt = list(range(100, 120))
    response = [1, 2, 3, 4, 5] * 8
    res = simulate([(prompt, response), (prompt, response)],
                   max_depth=32, max_spec_tokens=8, max_spec_factor=4.0)
    per = res.per_request()
    assert per[1]["est_speedup"] > per[0]["est_speedup"]
    assert per[1]["est_speedup"] > 2.0
    assert res.summary()["total_tokens"] == 80


def test_random_responses_no_benefit():
    rng = random.Random(0)
    rows = [([rng.randrange(1000) for _ in range(20)],
             [rng.randrange(1000) for _ in range(30)])
            for _ in range(3)]
    assert simulate(rows, max_depth=16).summary()["est_speedup"] < 1.5


def test_prompt_echo_is_fast():
    prompt = list(range(50))
    res = simulate([(prompt, list(range(50)))], max_depth=64,
                   max_spec_tokens=16, max_spec_factor=8.0)
    assert res.per_request()[0]["est_speedup"] > 3.0


def _dataset(kind: str, seed: int = 0):
    rng = random.Random(seed)
    if kind == "agentic":
        # Re-queries: a few templates with small edits, responses that
        # repeat earlier responses and copy spans of their prompts.
        base = [[rng.randrange(200) for _ in range(40)] for _ in range(3)]
        rows = []
        for i in range(12):
            p = list(base[i % 3])
            p[rng.randrange(40)] = rng.randrange(200)
            r = p[5:25] + [rng.randrange(200) for _ in range(rng.randrange(
                2, 12))] + base[(i + 1) % 3][:15]
            rows.append((p, r))
        return rows
    if kind == "random":
        return [([rng.randrange(5000) for _ in range(30)],
                 [rng.randrange(5000) for _ in range(40)])
                for _ in range(6)]
    return [(list(range(i, i + 20)), [7, 8, 9, 10] * (5 + i))
            for i in range(5)]


KNOBS = [dict(max_depth=64, max_spec_tokens=16, max_spec_factor=1.0,
              min_token_prob=0.1),
         dict(max_depth=16, max_spec_tokens=8, max_spec_factor=4.0,
              max_spec_offset=2.0, min_token_prob=0.0)]


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("kind", ["agentic", "random", "repeat"])
@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_statistics_equal_the_jax_simulator(monkeypatch, twin, kind,
                                            knobs):
    from arcticinference_tpu.spec.suffix_cache import (
        SuffixCache as JaxSuffixCache)
    from arcticinference_tpu_torch.spec.suffix_cache import SuffixCache

    if twin:
        monkeypatch.setenv("ARCTIC_TPU_PURE_PYTHON_SUFFIX", "1")
    assert SuffixCache(16).is_native() == JaxSuffixCache(16).is_native() \
        == (not twin)
    rows = _dataset(kind)
    res = simulate(rows, **KNOBS[knobs])
    ref = jax_simulate(rows, **KNOBS[knobs])
    got, want = res.summary(), ref.summary()
    got.pop("spec_time_per_step_us")
    want.pop("spec_time_per_step_us")
    assert got == want
    assert res.per_request() == ref.per_request()
    assert [(r.steps, r.accepted, r.drafted) for r in res.requests] == \
        [(r.steps, r.accepted, r.drafted) for r in ref.requests]


def test_cli_reads_jsonl(tmp_path):
    path = tmp_path / "data.jsonl"
    rows = _dataset("agentic")
    path.write_text("".join(json.dumps({"prompt_token_ids": p,
                                        "response_token_ids": r}) + "\n"
                            for p, r in rows))
    out = subprocess.run(
        [sys.executable, "-m", "arcticinference_tpu_torch", "simulate",
         str(path), "--per-request"], capture_output=True, text=True,
        cwd=str(REPO), check=True).stdout
    summary, end = json.JSONDecoder().raw_decode(out)
    want = jax_simulate(rows).summary()
    for k in ("num_requests", "total_tokens", "total_steps",
              "mean_accepted_per_step", "acceptance_rate", "est_speedup"):
        assert summary[k] == want[k], k
    per = [json.loads(line) for line in out[end:].splitlines() if line]
    assert [r["steps"] for r in per] == \
        [r["steps"] for r in jax_simulate(rows).per_request()]
