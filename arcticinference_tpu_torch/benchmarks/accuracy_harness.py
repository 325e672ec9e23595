"""lm_eval-style accuracy harness over offline task files, on the port.

Counterpart of the JAX package's ``benchmarks/accuracy_harness.py`` (the
reference scores its serving configs with lm_eval and a json-mode task
against live servers).  A task is a JSON document

    {"name": ..., "type": "multiple_choice" | "generate" | "json",
     "items": [...]}

with token-id items:

- multiple_choice: {"prompt_token_ids", "choices_token_ids": [[...], ...],
  "answer": int}, scored by summed continuation logprob; metric
  ``accuracy``;
- generate: {"prompt_token_ids", "expected_token_ids" | "expected_regex",
  "max_tokens"}, greedy; metric ``match`` (token prefix, or the regex on
  the text);
- json: {"prompt_token_ids", "schema", "max_tokens"}, schema-guided;
  metric ``conformance`` (parses as JSON, required keys typed).

Two clients: :class:`LocalClient` over an in-process port ``LLM``
(``LLM.score``, ``LLM.generate``, ``serving/structured.
make_guided_decoder``), :class:`HTTPClient` over the port's OpenAI server
(scoring by ``echo`` with ``max_tokens: 0``).  :func:`run_suite` returns
plain rows sorted by (config, task); no ``pandas``.

:func:`markov_tasks` builds the JAX accuracy test's three tasks from the
tiny checkpoint's held-out ids; :func:`matrix_failures` checks its bars.
"""

from __future__ import annotations

import json
import re
import urllib.request
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class Task:
    name: str
    type: str
    items: list[dict]


def load_task(path) -> Task:
    with open(path) as f:
        d = json.load(f)
    return Task(name=d["name"], type=d["type"], items=d["items"])


class LocalClient:
    """In-process client over a port ``LLM``."""

    def __init__(self, llm):
        self.llm = llm

    def continuation_logprob(self, prompt_ids, cont_ids) -> float:
        lp = self.llm.score([list(prompt_ids) + list(cont_ids)])[0]
        return float(lp[len(prompt_ids) - 1:].sum())

    def generate(self, prompt_ids, max_tokens: int,
                 schema: Optional[dict] = None):
        from arcticinference_tpu_torch.engine.request import SamplingParams
        from arcticinference_tpu_torch.serving.structured import (
            make_guided_decoder)

        guided = None
        if schema is not None:
            guided = make_guided_decoder(self.llm.tokenizer,
                                         {"json": schema})
        sp = SamplingParams(max_tokens=max_tokens,
                            ignore_eos=schema is None, guided=guided)
        out = self.llm.generate(prompt_token_ids=[list(prompt_ids)],
                                sampling_params=sp)[0]
        return out.token_ids, out.text


class HTTPClient:
    """Client of an OpenAI-compatible server's ``/v1/completions``."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _post(self, body: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + "/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def continuation_logprob(self, prompt_ids, cont_ids) -> float:
        full = list(prompt_ids) + list(cont_ids)
        resp = self._post({"prompt_token_ids": full, "echo": True,
                           "max_tokens": 0})
        lps = resp["choices"][0]["logprobs"]["token_logprobs"]
        return float(sum(lps[len(prompt_ids):]))

    def generate(self, prompt_ids, max_tokens: int,
                 schema: Optional[dict] = None):
        body: dict[str, Any] = {"prompt_token_ids": list(prompt_ids),
                                "max_tokens": max_tokens}
        if schema is not None:
            body["response_format"] = {
                "type": "json_schema",
                "json_schema": {"schema": schema}}
        else:
            body["ignore_eos"] = True
        c = self._post(body)["choices"][0]
        return c.get("token_ids", []), c.get("text", "")


def _json_conforms(text: str, schema: dict) -> bool:
    try:
        obj = json.loads(text)
    except ValueError:
        return False
    if schema.get("type") == "object":
        if not isinstance(obj, dict):
            return False
        props = schema.get("properties", {})
        for key in schema.get("required", []):
            if key not in obj:
                return False
            want = props.get(key, {}).get("type")
            if want == "integer" and not isinstance(obj[key], int):
                return False
            if want == "string" and not isinstance(obj[key], str):
                return False
            if want == "number" and not isinstance(obj[key],
                                                   (int, float)):
                return False
    return True


def run_task(client, task: Task) -> dict:
    """Score one task: {"task", "type", "metric", "value", "n"}."""
    n = len(task.items)
    if task.type == "multiple_choice":
        correct = 0
        for it in task.items:
            scores = [client.continuation_logprob(it["prompt_token_ids"], c)
                      for c in it["choices_token_ids"]]
            if max(range(len(scores)), key=scores.__getitem__) == \
                    it["answer"]:
                correct += 1
        return dict(task=task.name, type=task.type, metric="accuracy",
                    value=correct / n, n=n)
    if task.type == "generate":
        hits = 0
        for it in task.items:
            toks, text = client.generate(it["prompt_token_ids"],
                                         it.get("max_tokens", 8))
            if "expected_token_ids" in it:
                want = it["expected_token_ids"]
                hits += toks[:len(want)] == list(want)
            else:
                hits += bool(re.search(it["expected_regex"], text or ""))
        return dict(task=task.name, type=task.type, metric="match",
                    value=hits / n, n=n)
    if task.type == "json":
        ok = 0
        for it in task.items:
            _, text = client.generate(it["prompt_token_ids"],
                                      it.get("max_tokens", 48),
                                      schema=it["schema"])
            ok += _json_conforms(text or "", it["schema"])
        return dict(task=task.name, type=task.type, metric="conformance",
                    value=ok / n, n=n)
    raise ValueError(f"unknown task type {task.type!r}")


def run_suite(clients: dict, tasks: list) -> list[dict]:
    """Every (config, task) pair scored: one row per pair (:func:`run_task`
    plus ``config``), sorted by (config, task)."""
    rows = []
    for cfg_name, client in clients.items():
        for task in tasks:
            rows.append(dict(run_task(client, task), config=cfg_name))
    return sorted(rows, key=lambda r: (r["config"], r["task"]))


def value(rows: list[dict], config: str, task: str) -> float:
    """The metric of (``config``, ``task``) in ``rows``."""
    return next(r["value"] for r in rows
                if r["config"] == config and r["task"] == task)


# --------------------------------------------------------------------- #
# The tasks and bars of the JAX accuracy test, on the tiny checkpoint
# --------------------------------------------------------------------- #

JSON_SCHEMA = {"type": "object",
               "properties": {"count": {"type": "integer"}},
               "required": ["count"]}


def markov_tasks(heldout, rng: np.random.Generator) -> list[Task]:
    """Multiple-choice, generate and json tasks from the held-out ids, as
    the JAX test builds them (``tests/benchmarks/test_accuracy.py``; it
    draws from ``default_rng(5)``)."""
    heldout = np.asarray(heldout)
    mc_items = []
    for _ in range(20):
        p = int(rng.integers(0, len(heldout) - 24))
        prompt = heldout[p:p + 12].tolist()
        true = heldout[p + 12:p + 16].tolist()
        wrong = [int(rng.integers(32, 127)) for _ in true]
        answer = int(rng.integers(0, 2))
        choices = [true, wrong] if answer == 0 else [wrong, true]
        mc_items.append(dict(prompt_token_ids=prompt,
                             choices_token_ids=choices, answer=answer))
    gen_items = []
    for _ in range(20):
        p = int(rng.integers(0, len(heldout) - 20))
        gen_items.append(dict(prompt_token_ids=heldout[p:p + 12].tolist(),
                              expected_token_ids=heldout[p + 12:p + 14]
                              .tolist(), max_tokens=2))
    json_items = [dict(prompt_token_ids=heldout[i:i + 8].tolist(),
                       schema=JSON_SCHEMA, max_tokens=32)
                  for i in range(0, 40, 8)]
    return [Task("markov_mc", "multiple_choice", mc_items),
            Task("markov_gen", "generate", gen_items),
            Task("json_mode", "json", json_items)]


def matrix_failures(rows: list[dict], base: str = "bf16",
                    quantized=("fp8", "int8")) -> list[str]:
    """The JAX accuracy test's bars: ``base`` multiple choice >= 0.8 and
    generate >= 0.3; each quantized config within 0.15 (multiple choice)
    and 0.25 (generate) of ``base``; json conformance 1.0 everywhere."""
    out = []
    mc, gen = value(rows, base, "markov_mc"), value(rows, base, "markov_gen")
    if not mc >= 0.8:
        out.append(f"{base} markov_mc {mc} < 0.8")
    if not gen >= 0.3:
        out.append(f"{base} markov_gen {gen} < 0.3")
    for cfg in quantized:
        if not value(rows, cfg, "markov_mc") >= mc - 0.15:
            out.append(f"{cfg} markov_mc more than 0.15 below {base}")
        if not value(rows, cfg, "markov_gen") >= gen - 0.25:
            out.append(f"{cfg} markov_gen more than 0.25 below {base}")
    for cfg in (base, *quantized):
        if value(rows, cfg, "json_mode") != 1.0:
            out.append(f"{cfg} json_mode conformance "
                       f"{value(rows, cfg, 'json_mode')} != 1.0")
    return out
