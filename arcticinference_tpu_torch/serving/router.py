"""Data-parallel replica router for the port's serving surface.

Counterpart of ``arcticinference_tpu/serving/router.py``, on the port's
standard-library HTTP layer (``serving/http.py``): N independent engine
replicas (each an ``openai_server`` process on its own card) behind one
OpenAI-compatible endpoint, with a health loop, round-robin /
least-loaded / random selection, load accounting, failover and restart
of spawned replicas that exit or wedge.

Backends are local subprocesses (``--spawn N``) or other hosts
(``--backends http://host-a:8000,http://host-b:8000``).  Streaming
requests are proxied chunk by chunk; a failed request is retried on
another healthy replica only if no bytes have been forwarded yet.

    python -m arcticinference_tpu_torch.serving.router \\
        --backends http://127.0.0.1:8000,http://127.0.0.1:8001 --port 8080
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from arcticinference_tpu_torch.serving import http
from arcticinference_tpu_torch.serving.http import (App, HTTPError, Request,
                                                    Response, StreamResponse,
                                                    json_response)

logger = logging.getLogger("arcticinference_tpu_torch.router")

_PROXY_ROUTES = ("/v1/completions", "/v1/chat/completions")


@dataclass
class Backend:
    url: str
    healthy: bool = False
    inflight: int = 0
    total_requests: int = 0
    failures: int = 0
    proc: Optional[subprocess.Popen] = None
    last_check: float = field(default=0.0)
    # Wedge detection and restart (spawned replicas only): a replica that
    # stays unhealthy (a "stalled" 503 from a wedged step thread
    # included) past restart_after is killed and spawned again.
    unhealthy_since: float = 0.0
    restarts: int = 0
    spawn_cmd: Optional[list] = None
    spawn_env: Optional[dict] = None


class LLMRouter:

    def __init__(self, backends: list[str], policy: str = "round_robin",
                 health_interval: float = 2.0, retries: int = 2,
                 request_timeout: float = 600.0,
                 restart_after: float = 30.0):
        if policy not in ("round_robin", "least_loaded", "random"):
            raise ValueError(f"unknown policy {policy!r}")
        self.backends = [Backend(url=u.rstrip("/")) for u in backends]
        self.policy = policy
        self.health_interval = health_interval
        self.restart_after = restart_after
        self.retries = retries
        self.request_timeout = request_timeout
        self._rr = itertools.count()
        self._health_task: Optional[asyncio.Task] = None
        self.app = App()
        self.app.add_route("GET", "/health", self.health)
        self.app.add_route("GET", "/replicas", self.replicas)
        self.app.add_route("GET", "/v1/models", self.models)
        for route in _PROXY_ROUTES:
            self.app.add_route("POST", route, self.proxy)
        self.app.on_startup.append(self._on_startup)
        self.app.on_cleanup.append(self._on_cleanup)

    # -- lifecycle -------------------------------------------------------

    async def _on_startup(self, app) -> None:
        self._health_task = asyncio.create_task(self._health_loop())

    async def _on_cleanup(self, app) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            await asyncio.gather(self._health_task, return_exceptions=True)
        for b in self.backends:
            if b.proc is not None and b.proc.poll() is None:
                b.proc.terminate()

    async def _check(self, b: Backend) -> None:
        try:
            async with http.get(b.url + "/health", timeout=2.0) as resp:
                ok = resp.status == 200
                await resp.read()
        except (OSError, EOFError, ValueError):  # refused, reset, timed out
            ok = False
        if ok and not b.healthy:
            logger.info("backend %s healthy", b.url)
        if not ok and b.healthy:
            logger.warning("backend %s unhealthy", b.url)
        if not ok and b.unhealthy_since == 0.0:
            b.unhealthy_since = time.time()
        if ok:
            b.unhealthy_since = 0.0
        b.healthy = ok
        b.last_check = time.time()

    def _maybe_restart(self, b: Backend) -> None:
        """Kill and respawn a managed replica that exited or wedged."""
        if b.spawn_cmd is None:
            return
        exited = b.proc is not None and b.proc.poll() is not None
        wedged = (b.unhealthy_since > 0.0
                  and time.time() - b.unhealthy_since > self.restart_after)
        if not (exited or wedged):
            return
        logger.error("backend %s %s; restarting", b.url,
                     "exited" if exited else "wedged")
        if b.proc is not None and b.proc.poll() is None:
            b.proc.kill()
            b.proc.wait()
        b.proc = subprocess.Popen(b.spawn_cmd, env=b.spawn_env)
        b.restarts += 1
        b.healthy = False
        b.unhealthy_since = time.time()  # the grace period restarts now

    async def _health_loop(self) -> None:
        while True:
            await asyncio.gather(*(self._check(b) for b in self.backends))
            for b in self.backends:
                if not b.healthy:
                    self._maybe_restart(b)
            await asyncio.sleep(self.health_interval)

    async def wait_ready(self, min_replicas: int = 1,
                         timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            await asyncio.gather(*(self._check(b) for b in self.backends))
            if sum(b.healthy for b in self.backends) >= min_replicas:
                return
            await asyncio.sleep(1.0)
        raise TimeoutError(
            f"fewer than {min_replicas} healthy replicas after {timeout}s")

    # -- selection -------------------------------------------------------

    def select(self) -> Optional[Backend]:
        healthy = [b for b in self.backends if b.healthy]
        if not healthy:
            return None
        if self.policy == "least_loaded":
            return min(healthy, key=lambda b: b.inflight)
        if self.policy == "random":
            return random.choice(healthy)
        return healthy[next(self._rr) % len(healthy)]

    # -- handlers --------------------------------------------------------

    async def health(self, request: Request):
        n = sum(b.healthy for b in self.backends)
        return json_response(
            {"healthy_replicas": n, "total_replicas": len(self.backends)},
            status=200 if n else 503)

    async def replicas(self, request: Request):
        return json_response({
            "policy": self.policy,
            "replicas": [{
                "url": b.url, "healthy": b.healthy,
                "inflight": b.inflight,
                "total_requests": b.total_requests,
                "failures": b.failures,
                "restarts": b.restarts,
            } for b in self.backends]})

    async def models(self, request: Request):
        b = self.select()
        if b is None:
            raise HTTPError(503, "no healthy replicas")
        async with http.get(b.url + "/v1/models",
                            timeout=self.request_timeout) as resp:
            return json_response(await resp.json(), status=resp.status)

    async def proxy(self, request: Request):
        body = await request.read()
        tried: set[str] = set()
        for _ in range(self.retries + 1):
            b = self.select()
            if b is None or (b.url in tried and
                             len(tried) >= sum(x.healthy
                                               for x in self.backends)):
                break
            tried.add(b.url)
            b.inflight += 1
            b.total_requests += 1
            streamed = False
            try:
                async with http.post(
                        b.url + request.path, data=body,
                        headers={"Content-Type": "application/json"},
                        timeout=self.request_timeout) as resp:
                    ctype = resp.headers.get("content-type", "")
                    if resp.status >= 500:
                        raise RuntimeError(f"backend 5xx: {resp.status}")
                    if "text/event-stream" in ctype:
                        out = StreamResponse(
                            status=resp.status,
                            headers={"Content-Type": ctype,
                                     "Cache-Control": "no-cache"})
                        await out.prepare(request)
                        streamed = True
                        async for chunk in resp.iter_chunks():
                            await out.write(chunk)
                        await out.write_eof()
                        return out
                    return Response(await resp.read(), resp.status,
                                    "application/json")
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — retry / failover
                b.failures += 1
                b.healthy = False
                if streamed:
                    # Bytes already forwarded: cannot replay elsewhere.
                    raise HTTPError(500, "backend failed mid-stream") \
                        from exc
                logger.warning("backend %s failed (%s); retrying",
                               b.url, exc)
            finally:
                b.inflight -= 1
        raise HTTPError(503, "no healthy replicas")


# ----------------------------------------------------------------------- #
# Replica spawning (local data parallelism: one engine process per card)
# ----------------------------------------------------------------------- #

def spawn_replicas(config_path: str, num_replicas: int, base_port: int,
                   host: str = "127.0.0.1",
                   extra_env: Optional[dict] = None,
                   device: Optional[str] = None) -> list[Backend]:
    """Launch N ``python -m arcticinference_tpu_torch serve`` processes on
    consecutive ports, replica i on ``--device cuda:i`` unless ``device``
    names one device for all of them (``cpu``)."""
    backends = []
    for i in range(num_replicas):
        port = base_port + i
        env = dict(os.environ)
        if extra_env:
            env.update(extra_env)
        cmd = [sys.executable, "-m", "arcticinference_tpu_torch", "serve",
               "--config", config_path, "--port", str(port),
               "--host", host, "--device", device or f"cuda:{i}"]
        proc = subprocess.Popen(cmd, env=env)
        backends.append(Backend(url=f"http://{host}:{port}", proc=proc,
                                spawn_cmd=cmd, spawn_env=env))
    return backends


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="OpenAI-compatible DP replica router")
    parser.add_argument("--backends", default=None,
                        help="comma-separated replica URLs (remote hosts)")
    parser.add_argument("--spawn", type=int, default=0,
                        help="spawn N local replica servers")
    parser.add_argument("--config", default=None,
                        help="EngineConfig JSON for spawned replicas")
    parser.add_argument("--device", default=None,
                        help="--device of every spawned replica "
                             "(default: replica i on cuda:i)")
    parser.add_argument("--base-port", type=int, default=8100)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--policy", default="round_robin",
                        choices=["round_robin", "least_loaded", "random"])
    parser.add_argument("--health-interval", type=float, default=2.0)
    parser.add_argument("--min-replicas", type=int, default=1)
    args = parser.parse_args(argv)

    urls: list[str] = []
    spawned: list[Backend] = []
    if args.backends:
        urls.extend(u for u in args.backends.split(",") if u)
    if args.spawn:
        if not args.config:
            parser.error("--spawn requires --config")
        spawned = spawn_replicas(args.config, args.spawn, args.base_port,
                                 device=args.device)
        urls.extend(b.url for b in spawned)
    if not urls:
        parser.error("need --backends and/or --spawn")

    router = LLMRouter(urls, policy=args.policy,
                       health_interval=args.health_interval)
    for b, sb in zip(router.backends[-len(spawned):] if spawned else [],
                     spawned):
        b.proc, b.spawn_cmd, b.spawn_env = sb.proc, sb.spawn_cmd, \
            sb.spawn_env

    async def _ready(app):
        await router.wait_ready(args.min_replicas)
    router.app.on_startup.append(_ready)
    router.app.run(args.host, args.port)


if __name__ == "__main__":
    main()
