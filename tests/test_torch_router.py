"""The port's replica router (``serving/router.py``) on its
standard-library HTTP layer: the JAX router's cases
(``tests/test_router.py``, ``tests/test_failure_detection.py``) on
in-process port servers (a tiny random model on the CPU) and fake
backends.

- round robin spreads requests over two replicas; least-loaded and
  random pick healthy replicas only;
- SSE streams pass through (also from an ``aiohttp`` backend, the JAX
  server, which sends its stream chunked);
- a dead backend fails over to a healthy one and is marked unhealthy;
- no healthy replica answers 503 on the proxy routes, /health and
  /v1/models;
- spawned replicas that wedge or exit are restarted, unmanaged backends
  never are; ``spawn_replicas`` launches the port's ``serve`` command.
"""

import asyncio
import json
import subprocess
import sys
import time

import pytest

from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.serving import http
from arcticinference_tpu_torch.serving.openai_server import OpenAIServer
from arcticinference_tpu_torch.serving.router import (LLMRouter,
                                                      spawn_replicas)

from tests.test_torch_engine import TINY, config_dict
from tests.test_torch_serving import _free_port


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def replicas(loop):
    servers, urls = [], []
    for _ in range(2):
        srv = OpenAIServer(tcfg.EngineConfig.from_dict(config_dict(hf=TINY)),
                           device="cpu")
        port = loop.run_until_complete(srv.app.start("127.0.0.1", 0))
        servers.append(srv)
        urls.append(f"http://127.0.0.1:{port}")
    yield servers, urls
    for srv in servers:
        loop.run_until_complete(srv.app.stop())


def _run(loop, router, coro_fn, ready=True):
    async def run():
        port = await router.app.start("127.0.0.1", 0)
        try:
            if ready:
                await router.wait_ready(min_replicas=1, timeout=60)
            return await coro_fn(f"http://127.0.0.1:{port}")
        finally:
            await router.app.stop()

    return loop.run_until_complete(run())


async def _post(url, body):
    async with http.post(url + "/v1/completions", json=body,
                         timeout=60) as r:
        return r.status, r.headers.get("content-type", ""), await r.read()


async def _replicas(url):
    async with http.get(url + "/replicas") as r:
        return await r.json()


def test_round_robin_spreads_load(replicas, loop):
    _, urls = replicas
    router = LLMRouter(urls, policy="round_robin", health_interval=30.0)

    async def go(url):
        for i in range(4):
            status, _, raw = await _post(url, {
                "prompt_token_ids": [3 + i, 14, 15], "max_tokens": 3})
            assert status == 200
            assert len(json.loads(raw)["choices"][0]["token_ids"]) == 3
        return await _replicas(url)

    info = _run(loop, router, go)
    counts = [rep["total_requests"] for rep in info["replicas"]]
    assert counts == [2, 2]           # alternated between both replicas
    assert info["policy"] == "round_robin"


@pytest.mark.parametrize("policy", ["least_loaded", "random"])
def test_other_policies_pick_healthy_replicas(replicas, loop, policy):
    _, urls = replicas
    dead = f"http://127.0.0.1:{_free_port()}"
    router = LLMRouter([dead, *urls], policy=policy, health_interval=30.0)

    async def go(url):
        for i in range(4):
            status, _, _ = await _post(url, {
                "prompt_token_ids": [5, 6 + i], "max_tokens": 2})
            assert status == 200
        async with http.get(url + "/v1/models") as r:
            assert r.status == 200
            assert (await r.json())["object"] == "list"
        return await _replicas(url)

    info = _run(loop, router, go)
    assert info["replicas"][0]["total_requests"] == 0
    assert sum(r["total_requests"] for r in info["replicas"]) == 4


def _sse_ids(raw: bytes) -> list:
    chunks = [json.loads(line[len("data: "):])
              for line in raw.decode().splitlines()
              if line.startswith("data: ") and "[DONE]" not in line]
    return [t for c in chunks for t in c["choices"][0].get("token_ids", [])]


def test_streaming_proxies_sse(replicas, loop):
    _, urls = replicas
    router = LLMRouter(urls, health_interval=30.0)

    async def go(url):
        status, ctype, raw = await _post(url, {
            "prompt_token_ids": [3, 14, 15], "max_tokens": 4,
            "stream": True})
        assert status == 200 and "text/event-stream" in ctype
        assert raw.decode().rstrip().endswith("data: [DONE]")
        return len(_sse_ids(raw))

    assert _run(loop, router, go) == 4


def test_streams_from_an_aiohttp_backend(loop):
    """The JAX server (aiohttp: chunked SSE) behind the port's router:
    the stream arrives whole, with the backend's tokens."""
    test_utils = pytest.importorskip("aiohttp.test_utils")
    from arcticinference_tpu import config as jcfg
    from arcticinference_tpu.serving.openai_server import (
        OpenAIServer as JaxServer)

    jax_srv = JaxServer(jcfg.EngineConfig.from_dict(config_dict(hf=TINY)))

    async def start():
        ts = test_utils.TestServer(jax_srv.app)
        await ts.start_server()
        return ts, str(ts.make_url("")).rstrip("/")

    ts, jurl = loop.run_until_complete(start())
    body = {"prompt_token_ids": [3, 14, 15], "max_tokens": 5,
            "stream": True}
    try:
        direct = loop.run_until_complete(_post(jurl, body))
        routed = _run(loop, LLMRouter([jurl], health_interval=30.0),
                      lambda url: _post(url, body))
        plain = _run(loop, LLMRouter([jurl], health_interval=30.0),
                     lambda url: _post(url, dict(body, stream=False)))
    finally:
        loop.run_until_complete(ts.close())
        jax_srv.engine.close()
    assert routed[0] == direct[0] == 200
    assert len(_sse_ids(routed[2])) == 5
    assert _sse_ids(routed[2]) == _sse_ids(direct[2])
    assert json.loads(plain[2])["choices"][0]["token_ids"] == \
        _sse_ids(direct[2])


def test_failover_to_healthy_replica(replicas, loop):
    _, urls = replicas
    dead_port = _free_port()
    # The first backend does not exist: the router must fail over.
    router = LLMRouter([f"http://127.0.0.1:{dead_port}", urls[0]],
                       policy="round_robin", health_interval=30.0)

    async def go(url):
        ok = 0
        for i in range(3):
            status, _, _ = await _post(url, {
                "prompt_token_ids": [5, 6 + i], "max_tokens": 2})
            ok += status == 200
        return ok, await _replicas(url)

    ok, info = _run(loop, router, go)
    assert ok == 3
    dead = [rep for rep in info["replicas"]
            if str(dead_port) in rep["url"]][0]
    assert not dead["healthy"]


def test_no_healthy_replicas_503(loop):
    router = LLMRouter([f"http://127.0.0.1:{_free_port()}"],
                       health_interval=30.0)

    async def go(url):
        status, _, body = await _post(url, {"prompt_token_ids": [1],
                                            "max_tokens": 1})
        async with http.get(url + "/health") as h:
            health = (h.status, await h.json())
        async with http.get(url + "/v1/models") as m:
            models = m.status
        return status, body, health, models

    status, body, health, models = _run(loop, router, go, ready=False)
    assert (status, body) == (503, b"no healthy replicas")
    assert health == (503, {"healthy_replicas": 0, "total_replicas": 1})
    assert models == 503


def _sleeper():
    return [sys.executable, "-c", "import time; time.sleep(600)"]


def test_wedged_replica_restarted():
    router = LLMRouter(["http://127.0.0.1:1"], restart_after=0.5)
    b = router.backends[0]
    # A "replica" that never serves HTTP (wedged from birth).
    b.spawn_cmd = _sleeper()
    b.proc = subprocess.Popen(b.spawn_cmd)
    try:
        b.unhealthy_since = time.time() - 1.0
        old = b.proc
        router._maybe_restart(b)
        assert b.restarts == 1
        assert old.poll() is not None          # killed
        assert b.proc is not old and b.proc.poll() is None
    finally:
        if b.proc and b.proc.poll() is None:
            b.proc.kill()
            b.proc.wait()


def test_exited_replica_restarted():
    router = LLMRouter(["http://127.0.0.1:1"], restart_after=600)
    b = router.backends[0]
    b.spawn_cmd = _sleeper()
    b.proc = subprocess.Popen([sys.executable, "-c", "pass"])
    b.proc.wait()
    try:
        router._maybe_restart(b)   # exited -> restart regardless
        assert b.restarts == 1 and b.proc.poll() is None
    finally:
        if b.proc and b.proc.poll() is None:
            b.proc.kill()
            b.proc.wait()


def test_unmanaged_backend_never_restarted():
    router = LLMRouter(["http://remote:9"], restart_after=0.0)
    b = router.backends[0]
    b.unhealthy_since = time.time() - 100
    router._maybe_restart(b)
    assert b.restarts == 0


def test_spawn_replicas_runs_the_ports_serve_command(tmp_path,
                                                    monkeypatch):
    launched = []

    class FakePopen:
        def __init__(self, cmd, env=None):
            launched.append((cmd, env))

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    backends = spawn_replicas(str(tmp_path / "c.json"), 2, 9100,
                              device="cpu")
    assert [b.url for b in backends] == ["http://127.0.0.1:9100",
                                         "http://127.0.0.1:9101"]
    cmd, env = launched[1]
    assert cmd[1:4] == ["-m", "arcticinference_tpu_torch", "serve"]
    assert cmd[cmd.index("--port") + 1] == "9101"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert env == backends[1].spawn_env
    assert backends[1].spawn_cmd == cmd


def test_spawned_replicas_take_one_card_each(tmp_path, monkeypatch):
    launched = []

    class FakePopen:
        def __init__(self, cmd, env=None):
            launched.append(cmd)

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    spawn_replicas(str(tmp_path / "c.json"), 3, 9100)
    assert [c[c.index("--device") + 1] for c in launched] == [
        "cuda:0", "cuda:1", "cuda:2"]
