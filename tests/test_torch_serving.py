"""The port's OpenAI server against the JAX package's.

- On the trained tiny checkpoint (float32, its HF byte tokenizer), the
  port's server (``serving/openai_server.py`` on the standard-library
  HTTP layer) and the JAX server (``aiohttp``, in-process) receive the
  same requests: greedy token ids, ``finish_reason``, ``usage`` and text
  are equal (the JAX run's top-2 logprob margin is checked at every token
  first, so a near tie cannot make the comparison flaky), streamed ids
  joined are equal, ``logprobs`` and ``echo`` scoring agree to 1e-4,
  chat completions and guided choice / regex / ``json_object`` over the
  ``ByteTokenizer`` (padded to 256 ids) give equal ids, and the error statuses and bodies
  (missing prompt, ``stream`` with ``n > 1``, embeddings on a causal
  server, an engine abort) and the ``/metrics`` keys are equal.  Seeded
  sampling draws from ``torch.Generator``s, not the JAX PRNG: an
  ``n: 2`` seeded request's choices equal the port's own seeded runs.
- The port alone: /start_profile -> /stop_profile writes a trace, a
  double start answers 400; a client that disconnects aborts its engine
  request (non-streaming and streaming); a dead engine answers 503 and a
  stalled one 503 ``stalled``; ``mark_dead`` fails live streams.
- The card's machine: with ``aiohttp``, ``transformers``, ``tokenizers``,
  ``grpc`` and ``jax`` blocked, every module of the port imports and
  ``python -m arcticinference_tpu_torch serve --device cpu`` answers
  /health, a token-id completion and an SSE stream, and exits on
  SIGTERM.
"""

import asyncio
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.async_engine import AsyncLLMEngine
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.serving import http, openai_server
from arcticinference_tpu_torch.serving.openai_server import OpenAIServer

from tests.test_torch_engine import TINY, config_dict, trained  # noqa: F401
from tests.test_torch_guided_dfa import ByteTokenizer

test_utils = pytest.importorskip("aiohttp.test_utils")

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's side: its steps are hundreds of
    small ops, for which a thread pool only adds synchronisation."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


class Pair:
    """The JAX server and the port's, on one event loop."""

    def __init__(self, loop, jax_srv, port_srv, jax_url, port_url, prompts):
        self.loop = loop
        self.jax, self.port = jax_srv, port_srv
        self.urls = {"jax": jax_url, "port": port_url}
        self.prompts = prompts

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    async def post(self, side, path, body=None, raw=False):
        async with http.post(self.urls[side] + path, json=body,
                             timeout=120) as r:
            data = await r.read()
            ctype = r.headers.get("content-type", "")
        return r.status, ctype, data if raw else json.loads(data)

    async def both(self, path, body):
        """The same request to both servers at once: (jax, port)."""
        return await asyncio.gather(self.post("jax", path, body),
                                    self.post("port", path, body))

    async def check_margins(self, prompt, body):
        """The JAX engine's top-2 logprob margin at every token of the
        greedy run ``body`` asks for (its ids are also returned)."""
        srv = self.jax
        sp = srv._sampling_from(dict(body, logprobs=2))
        ids, _, lps = await srv._collect(prompt, sp,
                                         f"margin-{time.time_ns()}")
        for top in lps:
            vals = sorted(top.values(), reverse=True)
            assert len(vals) < 2 or vals[0] - vals[1] > 1e-4, \
                "near tie in the JAX run"
        return ids


@pytest.fixture(scope="module")
def pair(trained, loop):  # noqa: F811
    from arcticinference_tpu.serving.openai_server import (
        OpenAIServer as JaxServer)

    path, heldout = trained
    d = config_dict(model=path)
    jax_srv = JaxServer(jcfg.EngineConfig.from_dict(d),
                        served_model_name="tiny")
    port_srv = OpenAIServer(tcfg.EngineConfig.from_dict(d),
                            served_model_name="tiny", device="cpu")

    async def start():
        ts = test_utils.TestServer(jax_srv.app)
        await ts.start_server()
        port = await port_srv.app.start("127.0.0.1", 0)
        return ts, str(ts.make_url("")).rstrip("/"), \
            f"http://127.0.0.1:{port}"

    ts, jurl, turl = loop.run_until_complete(start())
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 25), (120, 30), (300, 8))]
    yield Pair(loop, jax_srv, port_srv, jurl, turl, prompts)
    loop.run_until_complete(ts.close())
    loop.run_until_complete(port_srv.app.stop())
    jax_srv.engine.close()


def test_health_and_models_match_jax(pair):
    async def go():
        for path in ("/health", "/v1/models"):
            out = []
            for side in ("jax", "port"):
                async with http.get(pair.urls[side] + path) as r:
                    out.append((r.status, await r.json()))
            assert out[0] == out[1], path

    pair.run(go())


def test_greedy_completions_match_jax(pair):
    async def go():
        body = dict(max_tokens=12)
        for p in pair.prompts:
            await pair.check_margins(p, body)
        res = await asyncio.gather(*[
            pair.both("/v1/completions", dict(body, prompt_token_ids=p))
            for p in pair.prompts])
        for (js, _, j), (ts, _, t) in res:
            assert js == ts == 200
            jc, tc = j["choices"][0], t["choices"][0]
            assert tc["token_ids"] == jc["token_ids"]
            assert tc["finish_reason"] == jc["finish_reason"] == "length"
            assert tc["text"] == jc["text"]
            assert t["usage"] == j["usage"]
            assert t["object"] == j["object"] and t["model"] == j["model"]

    pair.run(go())


def test_logprobs_match_jax(pair):
    async def go():
        p = pair.prompts[1]
        body = dict(prompt_token_ids=p, max_tokens=6, logprobs=3)
        await pair.check_margins(p, body)
        (_, _, j), (_, _, t) = await pair.both("/v1/completions", body)
        jl, tl = j["choices"][0]["logprobs"], t["choices"][0]["logprobs"]
        assert tl["tokens"] == jl["tokens"]
        np.testing.assert_allclose(tl["token_logprobs"],
                                   jl["token_logprobs"], atol=1e-4)
        for jt, tt in zip(jl["top_logprobs"], tl["top_logprobs"]):
            assert tt.keys() == jt.keys()
            for k in jt:
                assert abs(tt[k] - jt[k]) <= 1e-4

    pair.run(go())


def _events(raw: bytes) -> list:
    return [line[6:] for line in raw.decode().splitlines()
            if line.startswith("data: ")]


def test_streamed_ids_match_jax(pair):
    async def go():
        p = pair.prompts[2]
        await pair.check_margins(p, dict(max_tokens=10))
        body = dict(prompt_token_ids=p, max_tokens=10, stream=True)
        res = await asyncio.gather(
            pair.post("jax", "/v1/completions", body, raw=True),
            pair.post("port", "/v1/completions", body, raw=True))
        joined = []
        for status, ctype, raw in res:
            assert status == 200 and "text/event-stream" in ctype
            events = _events(raw)
            assert events[-1] == "[DONE]"
            chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
            joined.append(([t for c in chunks for t in c["token_ids"]],
                           chunks[-1]["finish_reason"],
                           "".join(c["text"] for c in chunks)))
        assert joined[1] == joined[0]
        assert len(joined[1][0]) == 10 and joined[1][1] == "length"

    pair.run(go())


def test_text_and_chat_prompts_match_jax(pair):
    async def go():
        tok = pair.port.tokenizer
        text = tok.decode(pair.prompts[0])
        await pair.check_margins(tok.encode(text), dict(max_tokens=8))
        (_, _, j), (_, _, t) = await pair.both(
            "/v1/completions", dict(prompt=text, max_tokens=8))
        assert t["choices"] == j["choices"] and t["usage"] == j["usage"]
        msgs = [{"role": "user", "content": text}]
        chat_ids = tok.encode(f"user: {text}\nassistant:")
        await pair.check_margins(chat_ids, dict(max_tokens=8))
        (js, _, j), (ts, _, t) = await pair.both(
            "/v1/chat/completions", dict(messages=msgs, max_tokens=8))
        assert js == ts == 200
        assert t["choices"] == j["choices"] and t["usage"] == j["usage"]
        assert t["object"] == j["object"] == "chat.completion"

    pair.run(go())


def test_n2_fan_out(pair):
    """Greedy ``n: 2``: two equal choices, as the JAX server's.  Seeded
    ``n: 2``: the same structure, and choice i equals the port's own
    single request with seed + i."""
    async def go():
        p = pair.prompts[3]
        await pair.check_margins(p, dict(max_tokens=5))
        body = dict(prompt_token_ids=p, max_tokens=5, n=2)
        (_, _, j), (_, _, t) = await pair.both("/v1/completions", body)
        assert [c["token_ids"] for c in t["choices"]] == \
            [c["token_ids"] for c in j["choices"]]
        assert t["usage"] == j["usage"]
        seeded = dict(body, temperature=0.9, seed=11)
        (_, _, j), (_, _, t) = await pair.both("/v1/completions", seeded)
        assert [c["index"] for c in t["choices"]] == [0, 1]
        assert t["usage"] == j["usage"]
        for i, c in enumerate(t["choices"]):
            _, _, one = await pair.post("port", "/v1/completions", dict(
                seeded, n=1, seed=11 + i))
            assert one["choices"][0]["token_ids"] == c["token_ids"]

    pair.run(go())


def test_echo_scoring_matches_jax(pair):
    async def go():
        for p in pair.prompts[:2]:
            body = dict(prompt_token_ids=p, max_tokens=0, echo=True)
            (js, _, j), (ts, _, t) = await pair.both("/v1/completions",
                                                     body)
            assert js == ts == 200
            jc, tc = j["choices"][0], t["choices"][0]
            assert tc["token_ids"] == jc["token_ids"] == p
            assert tc["logprobs"]["tokens"] == jc["logprobs"]["tokens"]
            jl, tl = (jc["logprobs"]["token_logprobs"],
                      tc["logprobs"]["token_logprobs"])
            assert tl[0] is None and jl[0] is None
            np.testing.assert_allclose(tl[1:], jl[1:], atol=1e-4)
            assert t["usage"] == j["usage"]

    pair.run(go())


class PaddedByteTokenizer(ByteTokenizer):
    """The ``ByteTokenizer`` padded with empty strings to the trained
    checkpoint's 256 ids."""

    def __init__(self):
        super().__init__()
        self.vocab += [""] * (256 - len(self.vocab))


GUIDED_BODIES = {
    "choice": dict(guided_choice=["alpha", "beta", "gamma"]),
    "regex": dict(guided_regex=r"id-\d+"),
    "json_object": dict(response_format={"type": "json_object"}),
}


@pytest.mark.parametrize("kind", sorted(GUIDED_BODIES))
def test_guided_outputs_match_jax(pair, kind):
    async def go():
        for srv in (pair.jax, pair.port):
            srv.tokenizer = PaddedByteTokenizer()
        try:
            body = dict(prompt_token_ids=pair.prompts[0], max_tokens=24,
                        **GUIDED_BODIES[kind])
            await pair.check_margins(pair.prompts[0], body)
            (js, _, j), (ts, _, t) = await pair.both("/v1/completions",
                                                     body)
        finally:
            for srv in (pair.jax, pair.port):
                srv.tokenizer = srv.engine.engine.tokenizer
        assert js == ts == 200
        assert t["choices"][0]["token_ids"] == j["choices"][0]["token_ids"]
        assert t["choices"][0]["text"] == j["choices"][0]["text"]
        text = t["choices"][0]["text"]
        if kind == "choice":
            assert text in ("alpha", "beta", "gamma")
        elif kind == "regex":
            assert __import__("re").fullmatch(r"id-\d+", text)
        elif t["choices"][0]["finish_reason"] == "stop":
            json.loads(text)

    pair.run(go())


def _abort_scheduled(engine):
    """Make ``engine`` abort every running request after its next step
    (as a stranded guided request is); returns the original step."""
    orig = engine.step

    def step():
        finished = orig()
        for r in list(engine.scheduler.running):
            if engine.abort_request(r.req_id) is not None:
                finished.append(r)
        return finished

    engine.step = step
    return orig


ERROR_CASES = {
    "missing prompt": ("/v1/completions", dict(max_tokens=2)),
    "stream with n > 1": ("/v1/completions", dict(
        prompt_token_ids=[1, 2], n=2, stream=True)),
    "embeddings on a causal server": ("/v1/embeddings",
                                      dict(input=[[1, 2]])),
    "missing messages": ("/v1/chat/completions", dict(max_tokens=2)),
    "engine abort": ("/v1/completions", dict(prompt_token_ids=[1, 2, 3],
                                             max_tokens=8)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_statuses_and_bodies_match_jax(pair, case):
    path, body = ERROR_CASES[case]
    engines = [pair.jax.engine.engine, pair.port.engine.engine]
    saved = [_abort_scheduled(e) for e in engines] \
        if case == "engine abort" else None
    try:
        async def go():
            return await asyncio.gather(
                pair.post("jax", path, body, raw=True),
                pair.post("port", path, body, raw=True))

        res = pair.run(go())
    finally:
        if saved:
            for e, orig in zip(engines, saved):
                e.step = orig
    (js, jct, jb), (ts, tct, tb) = res
    assert ts == js and ts in (400, 500)
    assert tb == jb
    assert tct.split(";")[0] == jct.split(";")[0]
    assert case != "engine abort" or ts == 500


def test_metrics_keys_match_jax(pair):
    async def go():
        out = []
        for side in ("jax", "port"):
            async with http.get(pair.urls[side] + "/metrics") as r:
                out.append(await r.json())
        assert out[1].keys() == out[0].keys()
        assert out[1]["num_steps"] > 0 and out[1]["num_finished"] > 0

    pair.run(go())


def test_profile_trace_roundtrip(pair, tmp_path):
    async def go():
        d = str(tmp_path / "trace")
        status, _, _ = await pair.post("port", "/start_profile",
                                       dict(trace_dir=d))
        assert status == 200
        status, _, err = await pair.post("port", "/start_profile",
                                         dict(trace_dir=d))
        assert status == 400 and "already" in err["error"]
        status, _, _ = await pair.post("port", "/v1/completions", dict(
            prompt_token_ids=pair.prompts[3], max_tokens=3))
        assert status == 200
        status, _, _ = await pair.post("port", "/stop_profile")
        assert status == 200
        traces = list(Path(d).glob("*.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        # The steps' host ops (the profiler runs on the step thread).
        assert any(e.get("name", "").startswith("aten::") for e in events)

    pair.run(go())


async def _wait_idle(srv, timeout=5.0) -> float:
    eng = srv.engine.engine
    t0 = time.time()
    while time.time() - t0 < timeout:
        if not eng.scheduler.running and not eng.scheduler.waiting:
            return time.time() - t0
        await asyncio.sleep(0.02)
    raise AssertionError("engine request not aborted")


@pytest.mark.parametrize("stream", [False, True])
def test_client_disconnect_aborts_engine_request(pair, stream):
    """The client closes its connection mid-request: the HTTP layer
    cancels the handler, which aborts the engine request."""
    async def go():
        srv = pair.port
        aborted = []
        orig = srv.engine.abort

        async def spy(rid):
            aborted.append(rid)
            await orig(rid)

        srv.engine.abort = spy
        try:
            port = int(pair.urls["port"].rsplit(":", 1)[1])
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            body = json.dumps(dict(prompt_token_ids=[5, 6, 7],
                                   max_tokens=200, ignore_eos=True,
                                   stream=stream)).encode()
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body),
                                                           body))
            await writer.drain()
            if stream:
                await reader.readuntil(b"data: ")   # the first chunk
            else:
                eng = srv.engine.engine
                while not eng.scheduler.running:
                    await asyncio.sleep(0.01)
            writer.close()
            await _wait_idle(srv)
            assert len(aborted) == 1 and aborted[0].startswith("cmpl-")
        finally:
            srv.engine.abort = orig

    pair.run(go())


@pytest.fixture(scope="module")
def tiny_server(loop):
    srv = OpenAIServer(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
                       device="cpu")
    port = loop.run_until_complete(srv.app.start("127.0.0.1", 0))
    yield srv, f"http://127.0.0.1:{port}"
    loop.run_until_complete(srv.app.stop())


def test_stalled_then_dead_engine_answers_503(tiny_server, loop):
    srv, url = tiny_server

    async def health():
        async with http.get(url + "/health") as r:
            return r.status, await r.json()

    async def go():
        assert await health() == (200, {"status": "ok"})
        eng = srv.engine
        eng.stall_timeout_s = -1.0
        with eng._engine_lock:     # unfinished work, no progress stamp
            eng.engine.add_request("held", [1, 2, 3],
                                   SamplingParams(max_tokens=4))
            assert await health() == (503, {"status": "stalled"})
            eng.engine.abort_request("held")
        eng.stall_timeout_s = 60.0
        eng.mark_dead("test-induced failure")
        assert await health() == (503, {"status": "engine_error",
                                        "reason": "test-induced failure"})
        async with http.post(url + "/v1/completions", json=dict(
                prompt_token_ids=[1], max_tokens=1)) as r:
            assert r.status == 500

    loop.run_until_complete(go())


def test_mark_dead_fails_streams_and_rejects():
    eng = AsyncLLMEngine(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
                         device="cpu")

    async def run():
        chunks = []

        async def consume():
            async for c in eng.generate(
                    [5, 6, 7],
                    SamplingParams(max_tokens=2000, ignore_eos=True),
                    "victim"):
                chunks.append(c)

        task = asyncio.create_task(consume())
        while not chunks:
            await asyncio.sleep(0.01)
        eng.mark_dead("test-induced failure")
        await asyncio.wait_for(task, timeout=10)
        return chunks

    try:
        chunks = asyncio.new_event_loop().run_until_complete(run())
        assert chunks[-1].finished
        assert chunks[-1].finish_reason == "engine_error"
        with pytest.raises(RuntimeError, match="dead"):
            asyncio.new_event_loop().run_until_complete(
                eng.generate([1, 2], None, "after").__anext__())
    finally:
        eng.close()
    assert not eng._thread.is_alive()


BLOCKER = """
import importlib.abc, sys
BLOCKED = ("aiohttp", "transformers", "tokenizers", "grpc", "jax",
           "jaxlib", "arcticinference_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, Block())
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_on_the_cpu_with_packages_blocked(tmp_path):
    """What the card's machine sees: none of the blocked packages.  Every
    module of the port imports; ``serve --device cpu`` answers /health, a
    token-id completion and an SSE stream, and exits on SIGTERM."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(config_dict(hf=TINY)))
    port = _free_port()
    code = BLOCKER + f"""
import importlib, pkgutil, runpy
import arcticinference_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):
    importlib.import_module(m.name)
sys.argv = ["arcticinference_tpu_torch", "serve", "--device", "cpu",
            "--config", {str(cfg)!r}, "--port", "{port}",
            "--host", "127.0.0.1"]
runpy.run_module("arcticinference_tpu_torch", run_name="__main__")
"""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    url = f"http://127.0.0.1:{port}"

    async def go():
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                async with http.get(url + "/health", timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.time() < deadline, "server did not come up"
            await asyncio.sleep(0.2)
        async with http.post(url + "/v1/completions", json=dict(
                prompt_token_ids=[3, 14, 15, 92], max_tokens=4)) as r:
            data = await r.json()
        assert data["choices"][0]["finish_reason"] == "length"
        assert len(data["choices"][0]["token_ids"]) == 4
        async with http.post(url + "/v1/completions", json=dict(
                prompt_token_ids=[3, 14, 15, 92], max_tokens=3,
                stream=True)) as r:
            assert r.headers["transfer-encoding"] == "chunked"
            events = [line async for line in r.iter_lines()
                      if line.startswith(b"data: ")]
        assert events[-1] == b"data: [DONE]\n"
        ids = [t for e in events[:-1]
               for t in json.loads(e[6:])["choices"][0]["token_ids"]]
        assert ids == data["choices"][0]["token_ids"][:3]

    try:
        asyncio.run(go())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_encoder_architecture_is_refused():
    """An encoder deployment builds the encoder runner and no engine; the
    generate routes refuse it with the JAX server's 400 (its
    /v1/embeddings bodies: ``tests/test_torch_serving_embed.py``)."""
    conf = tcfg.EngineConfig.from_dict(dict(config_dict(hf=TINY), model=dict(
        config_dict(hf=TINY)["model"], model="bert")))
    srv = OpenAIServer(conf, device="cpu")
    assert srv.engine is None and srv.encoder is not None
    for route in (srv.completions, srv.chat_completions):
        resp = asyncio.run(route(None))
        assert resp.status == 400
        assert json.loads(resp.body) == {
            "error": "encoder-only model: use /v1/embeddings"}


@pytest.mark.parametrize("flag", [
    ["--multihost-coordinator", "10.0.0.1:1234"],
    ["--multihost-num-processes=2"], ["--multihost-process-id", "1"],
    ["--multihost-leader", "10.0.0.1"], ["--multihost-channel-port", "1"]])
def test_multihost_flags_are_refused_by_name(flag):
    """A ``--multihost-*`` flag without the rest of a served mesh (more
    than one process and a coordinator) is refused by name; the served
    mesh itself: ``tests/test_torch_multihost.py``."""
    with pytest.raises(ValueError,
                       match=flag[0].split("=")[0] + ": multi-host"):
        openai_server.make_server(["--device", "cpu"] + flag)


def test_malformed_requests_get_status_errors(tiny_server, loop):
    """Outside input the HTTP layer refuses: a malformed request line or
    Content-Length (400), an unknown path (404) or method (405), a body
    that is not JSON (400)."""
    srv, url = tiny_server
    port = int(url.rsplit(":", 1)[1])

    async def raw(data: bytes) -> bytes:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(data)
        await writer.drain()
        out = await reader.readuntil(b"\r\n")
        writer.close()
        return out

    async def go():
        assert b" 400 " in await raw(b"GARBAGE\r\n\r\n")
        assert b" 400 " in await raw(b"POST /v1/completions HTTP/1.1\r\n"
                                     b"Content-Length: x\r\n\r\n")
        assert b" 404 " in await raw(b"GET /nope HTTP/1.1\r\n\r\n")
        assert b" 405 " in await raw(b"GET /v1/completions HTTP/1.1\r\n\r\n")
        assert b" 400 " in await raw(b"POST /v1/completions HTTP/1.1\r\n"
                                     b"Content-Length: 3\r\n\r\n{x]")

    loop.run_until_complete(go())
