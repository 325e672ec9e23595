"""The port's Dynasor (``dynasor/``) against the JAX package's.

- A table of answers through the evaluator (``math_equal``,
  ``extract_boxed``, ``extract_answer``, ``normalize_answer``) and the
  certainty logic (``should_early_exit``, ``majority_answer``,
  ``answer_entropy``): the port's functions give the JAX functions'
  results exactly, and those of the JAX tests' cases.
- The proxy on the port's HTTP layer against the JAX tests' fake backend
  (``aiohttp``, chunked SSE): it exits early once the probes agree and
  streams the whole chain of thought when they never do; a streamed chat
  passes through as SSE; /v1/completions passes through to a port server
  (plain and streamed) with the backend's tokens; /health follows the
  backend.
"""

import asyncio
import json

import pytest

from arcticinference_tpu.dynasor import entropy as jentropy
from arcticinference_tpu.dynasor import evaluator as jevaluator
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.dynasor import entropy, evaluator
from arcticinference_tpu_torch.dynasor.proxy import DynasorProxy
from arcticinference_tpu_torch.serving import http
from arcticinference_tpu_torch.serving.openai_server import OpenAIServer

from tests.test_torch_engine import TINY, config_dict

test_utils = pytest.importorskip("aiohttp.test_utils")
from tests.test_dynasor import FakeBackend  # noqa: E402

# (a, b, math_equal) from the JAX tests, and a few more.
EQUAL_CASES = [
    ("42", "42", True), ("42", "42.0", True), ("1/2", "0.5", True),
    (r"\frac{1}{2}", "0.5", True), (r"\frac{3}{4}", "6/8", True),
    ("50%", "0.5", True), ("1,234", "1234", True), ("42", "43", False),
    ("x+1", "1+x", True), (r"2\pi", "2*pi", True), ("", "", True),
    (None, "5", False), ("(1, 2)", "(1,2)", True),
    ("(1/2, 3)", "(0.5, 3.0)", True), ("[0, \\frac{1}{2}]", "[0, 0.5]", True),
    ("x = 5", "5", True), ("f(x)=2", "2", True),
    ("1\\frac{1}{2}", "1.5", True), ("2 \\pm \\sqrt{4}", "(0, 4)", True),
    ("3 \\pm 1", "4", True), ("Yes", "yes", True), ("90^\\circ", "90", True),
    ("50\\%", "0.5", True), ("(1, 2)", "(1, 3)", False),
    ("(1, 2)", "(1, 2, 3)", False), ("x = 5", "6", False),
    ("3 \\pm 1", "5", False), ("Yes", "No", False), ("(1, 2)", "3", False),
    ("\\frac{\\sqrt{2}}{2}", "\\frac{1}{\\sqrt{2}}", True),
    ("\\frac{1}{\\sqrt{3}}", "\\frac{\\sqrt{3}}{3}", True),
    ("2\\sqrt{2}", "\\sqrt{8}", True), ("\\frac{6}{4}", "\\frac{3}{2}", True),
    ("e^{2}", "e^2", True), ("twenty-three", "23", True),
    ("one hundred and five", "105", True), ("two thousand", "2000", True),
    ("25", "0.25", True), ("0.25", "25", True), ("12.5\\%", "0.125", True),
    ("\\begin{pmatrix}1&2\\\\3&4\\end{pmatrix}",
     "\\begin{bmatrix}1&2\\\\3&4\\end{bmatrix}", True),
    ("\\begin{pmatrix}\\frac{1}{2}\\\\1\\end{pmatrix}",
     "\\begin{pmatrix}0.5\\\\1.0\\end{pmatrix}", True),
    ("\\begin{pmatrix}1\\\\2\\end{pmatrix}", "(1, 2)", True),
    ("\\sqrt{2}", "2", False), ("twenty-three", "24", False),
    ("\\begin{pmatrix}1&2\\\\3&4\\end{pmatrix}",
     "\\begin{pmatrix}1&2\\\\3&5\\end{pmatrix}", False),
    ("\\begin{pmatrix}1\\\\2\\end{pmatrix}", "(1, 2, 3)", False),
    ("one hundred and five", "twenty", False),
]
# More pairs, held to the JAX function alone.
MORE_PAIRS = [("\\dfrac{2}{3}", "0.6667"), ("-7", "-7.0"),
              ("\\text{ four }", "4"), ("3.14159", "\\pi"),
              ("1e3", "1000"), ("\\{1, 2\\}", "(1, 2)")]


@pytest.mark.parametrize("a,b,eq", EQUAL_CASES + [
    (a, b, None) for a, b in MORE_PAIRS])
def test_math_equal_matches_jax(a, b, eq):
    got = evaluator.math_equal(a, b)
    assert got == jevaluator.math_equal(a, b)
    assert eq is None or got == eq


TEXTS = [
    r"so \boxed{42}", r"\boxed{\frac{1}{2}}", "no box",
    r"\boxed{1} then \boxed{2}", "the answer is 7", r"thus \boxed{9}",
    r"\boxed{x^{2}+1} done", "Final answer: 12.5%", r"\fbox{3}",
    "The answer is $\\frac{3}{4}$.", "", r"\boxed{", "answer: (1, 2)",
]


@pytest.mark.parametrize("text", TEXTS)
def test_extraction_matches_jax(text):
    assert evaluator.extract_boxed(text) == jevaluator.extract_boxed(text)
    assert evaluator.extract_answer(text) == jevaluator.extract_answer(text)
    assert evaluator.normalize_answer(text) == \
        jevaluator.normalize_answer(text)


CERTAINTY_CASES = [
    (["41", "42", "42"], ["41}", "42}", "42}"], 2),
    (["41", "42", "42"], ["41}", "42}", "42}"], 3),
    (["42", "42"], ["42} wait, but maybe", "42}"], 2),
    ([None, None], ["", ""], 2),
    (["1/2", "0.5"], ["1/2}", "0.5}"], 2),
    (["3", "3", "3"], ["3}", "3} hmm", "3}"], 2),
    (["7"], ["7}"], 1),
    (["x+1", "1+x", "1 + x"], ["a", "b", "c"], 3),
]


@pytest.mark.parametrize("answers,texts,window", CERTAINTY_CASES)
def test_certainty_matches_jax(answers, texts, window):
    assert entropy.should_early_exit(answers, texts, window) == \
        jentropy.should_early_exit(answers, texts, window)
    assert entropy.majority_answer(answers) == \
        jentropy.majority_answer(answers)
    assert entropy.answer_entropy(answers) == \
        jentropy.answer_entropy(answers)


def test_certainty_cases_of_the_jax_tests():
    answers, texts = ["41", "42", "42"], ["41}", "42}", "42}"]
    assert entropy.should_early_exit(answers, texts, window=2)
    assert not entropy.should_early_exit(answers, texts, window=3)
    assert not entropy.should_early_exit(
        ["42", "42"], ["42} wait, but maybe", "42}"], window=2)
    assert not entropy.should_early_exit([None, None], ["", ""], 2)
    assert evaluator.math_equal(
        entropy.majority_answer(["1/2", "0.5", "3"]), "0.5")
    assert entropy.answer_entropy(["5", "5", "5"]) == 0.0
    assert entropy.answer_entropy(["5", "6"]) > 0.0


@pytest.fixture()
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def _with_backend(loop, backend, go, **proxy_kw):
    """Serve the aiohttp ``backend`` and a port proxy in front of it; run
    ``go(proxy_url)``."""
    async def run():
        ts = test_utils.TestServer(backend.app)
        await ts.start_server()
        proxy = DynasorProxy(str(ts.make_url("")).rstrip("/"), **proxy_kw)
        port = await proxy.app.start("127.0.0.1", 0)
        try:
            return await go(f"http://127.0.0.1:{port}")
        finally:
            await proxy.app.stop()
            await ts.close()

    return loop.run_until_complete(run())


async def _chat(url, body):
    async with http.post(url + "/v1/chat/completions", json=body,
                         timeout=60) as r:
        return r.status, r.headers.get("content-type", ""), await r.read()


def test_proxy_early_exit(loop):
    backend = FakeBackend(cot_tokens=500, probe_answer="42")
    status, _, raw = _with_backend(loop, backend, lambda url: _chat(url, {
        "messages": [{"role": "user", "content": "hard math"}],
        "max_tokens": 500}), probe_interval=20, certainty_window=2)
    data = json.loads(raw)
    assert status == 200
    assert data["dynasor"]["early_exit"] is True
    assert "\\boxed{42}" in data["choices"][0]["message"]["content"]
    # Early exit means far fewer than 500 steps streamed.
    assert data["choices"][0]["message"]["content"].count("step") < 400
    assert backend.probe_calls >= 2


def test_proxy_no_exit_when_uncertain(loop):
    backend = FakeBackend(cot_tokens=60, probe_answer="")
    _, _, raw = _with_backend(loop, backend, lambda url: _chat(url, {
        "messages": [{"role": "user", "content": "hard math"}]}),
        probe_interval=20, certainty_window=2)
    data = json.loads(raw)
    assert data["dynasor"]["early_exit"] is False
    assert data["choices"][0]["message"]["content"].count("step") == 60


def test_proxy_streams_chat(loop):
    backend = FakeBackend(cot_tokens=60, probe_answer="")
    status, ctype, raw = _with_backend(loop, backend, lambda url: _chat(
        url, {"messages": [{"role": "user", "content": "q"}],
              "stream": True}), probe_interval=20)
    assert status == 200 and "text/event-stream" in ctype
    events = [line[6:] for line in raw.decode().splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert "".join(d["delta"]["content"] for d in deltas).count("step") \
        == 60
    assert deltas[-1]["finish_reason"] == "stop"
    assert backend.probe_calls >= 1


def test_proxy_passes_completions_through(loop):
    srv = OpenAIServer(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
                       device="cpu")

    async def run():
        bport = await srv.app.start("127.0.0.1", 0)
        burl = f"http://127.0.0.1:{bport}"
        proxy = DynasorProxy(burl)
        url = f"http://127.0.0.1:{await proxy.app.start('127.0.0.1', 0)}"
        body = {"prompt_token_ids": [3, 14, 15], "max_tokens": 4}
        try:
            async with http.post(burl + "/v1/completions", json=body) as r:
                direct = await r.json()
            async with http.post(url + "/v1/completions", json=body) as r:
                plain = await r.json()
            async with http.post(url + "/v1/completions",
                                 json=dict(body, stream=True)) as r:
                streamed = [json.loads(line[6:])
                            async for line in r.iter_lines()
                            if line.startswith(b"data: {")]
            async with http.get(url + "/health") as r:
                up = await r.json()
            await srv.app.stop()
            async with http.get(url + "/health") as r:
                down = await r.json()
        finally:
            await proxy.app.stop()
            await srv.app.stop()
        return direct, plain, streamed, up, down

    direct, plain, streamed, up, down = loop.run_until_complete(run())
    ids = direct["choices"][0]["token_ids"]
    assert len(ids) == 4 and plain["choices"][0]["token_ids"] == ids
    assert [t for c in streamed for t in c["choices"][0]["token_ids"]] == ids
    assert up == {"status": "ok"} and down == {"status": "backend_down"}
