"""Replica manager: spawn N replica processes, health-check, balance.

Counterpart of ``arcticinference_tpu/embedding/replica_manager.py``, on
the port's transport.  Replicas run on consecutive ports (all on the
same card unless their arguments say otherwise); a health loop marks
them up or down, routing picks ``round_robin`` / ``least_loaded`` /
``random``, and the manager serves the same service itself, forwarding
``Encode`` to the chosen replica (like the JAX manager, it has no
``Generate``).

Failover differs from the JAX manager's on purpose: a replica is marked
down, and the request retried on another, only on a transport failure
(a refused or reset connection, a timeout, a truncated answer) or when
its process has died.  The replica's own error answer to a bad request
(a request without input: INVALID_ARGUMENT) goes back to the client
unretried and leaves the replica in rotation; the JAX manager marks
every replica that answers it down until its health loop restores them.

Run (``--device cpu`` runs the replicas on the CPU):

    python -m arcticinference_tpu_torch embed --port 50050 \\
        --num-replicas 2 --config cfg.json [--policy least_loaded]
"""

from __future__ import annotations

import argparse
import random
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

from arcticinference_tpu_torch.embedding import wire
from arcticinference_tpu_torch.embedding.replica import exit_on_sigterm
from arcticinference_tpu_torch.embedding.transport import (InferenceStub,
                                                           RpcError, Server,
                                                           StatusCode)

POLICIES = ("round_robin", "least_loaded", "random")


@dataclass
class Replica:
    port: int
    process: Optional[subprocess.Popen] = None
    healthy: bool = False
    inflight: int = 0
    stub: Optional[InferenceStub] = None

    def connect(self) -> None:
        if self.stub is None:
            self.stub = InferenceStub(f"127.0.0.1:{self.port}")

    @property
    def exited(self) -> bool:
        return self.process is not None and self.process.poll() is not None


class ReplicaManager:

    def __init__(self, base_port: int, num_replicas: int,
                 replica_args: list[str], policy: str = "round_robin",
                 spawn: bool = True, health_interval: float = 2.0,
                 startup_timeout: float = 600.0):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} is not one of {POLICIES}")
        self.policy = policy
        self.replicas = [Replica(port=base_port + i)
                         for i in range(num_replicas)]
        self._rr = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.startup_timeout = startup_timeout
        if spawn:
            for r in self.replicas:
                r.process = subprocess.Popen(
                    [sys.executable, "-m",
                     "arcticinference_tpu_torch.embedding.replica",
                     "--port", str(r.port), *replica_args])
        for r in self.replicas:
            r.connect()
        self._health_thread = threading.Thread(
            target=self._health_loop, args=(health_interval,), daemon=True)
        self._health_thread.start()

    # -- health ---------------------------------------------------------

    def _check(self, r: Replica) -> bool:
        try:
            return bool(r.stub.HealthCheck(wire.HealthCheckRequest(),
                                           timeout=2).healthy)
        except RpcError:
            return False

    def _health_loop(self, interval: float) -> None:
        while not self._stop.is_set():
            for r in self.replicas:
                r.healthy = not r.exited and self._check(r)
            self._stop.wait(interval)

    def wait_ready(self, min_replicas: int = 1) -> None:
        deadline = time.time() + self.startup_timeout
        while time.time() < deadline:
            for r in self.replicas:
                if r.exited:
                    raise RuntimeError(
                        f"replica :{r.port} exited prematurely "
                        f"(code {r.process.returncode})")
            up = [r for r in self.replicas if self._check(r)]
            if len(up) >= min_replicas:
                for r in up:
                    r.healthy = True
                return
            time.sleep(1.0)
        raise TimeoutError("replicas did not become healthy in time")

    # -- routing --------------------------------------------------------

    def select(self) -> Replica:
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            if not healthy:
                raise RuntimeError("no healthy replicas")
            if self.policy == "round_robin":
                r = healthy[self._rr % len(healthy)]
                self._rr += 1
            elif self.policy == "least_loaded":
                r = min(healthy, key=lambda x: x.inflight)
            else:
                r = random.choice(healthy)
            r.inflight += 1
            return r

    def release(self, r: Replica) -> None:
        with self._lock:
            r.inflight = max(0, r.inflight - 1)

    def route_encode(self, request, retries: int = 2):
        """Encode on a selected replica; on a transport failure the
        replica is marked down and the request retried on another (up to
        ``retries`` times).  The replica's own error answer is raised
        as it is."""
        last_err = None
        for _ in range(retries + 1):
            r = self.select()
            try:
                return r.stub.Encode(request, timeout=300)
            except RpcError as e:
                if not e.transport:
                    raise
                last_err = e
                r.healthy = False
            finally:
                self.release(r)
        raise last_err

    def shutdown(self) -> None:
        self._stop.set()
        for r in self.replicas:
            if r.process is not None and r.process.poll() is None:
                r.process.terminate()
        for r in self.replicas:
            if r.process is not None:
                try:
                    r.process.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    r.process.kill()
                    r.process.wait()


class ManagerServicer:
    """The same service, requests routed to the replicas."""

    def __init__(self, manager: ReplicaManager):
        self.manager = manager

    def Encode(self, request, context):  # noqa: N802 — the RPC's name
        try:
            return self.manager.route_encode(request)
        except RpcError as e:
            context.abort(e.code(), e.details())
        except RuntimeError as e:
            context.abort(StatusCode.UNAVAILABLE, str(e))

    def Abort(self, request, context):  # noqa: N802
        ok = False
        for r in self.manager.replicas:
            if r.healthy:
                try:
                    ok = r.stub.Abort(request, timeout=5).aborted or ok
                except RpcError:
                    pass
        return wire.AbortResponse(aborted=ok)

    def GetReplicaInfo(self, request, context):  # noqa: N802
        total_reqs = total_toks = active = 0
        model = ""
        for r in self.manager.replicas:
            if not r.healthy:
                continue
            try:
                info = r.stub.GetReplicaInfo(request, timeout=5)
            except RpcError:
                continue
            model = info.model
            active += info.active_requests
            total_reqs += info.total_requests
            total_toks += info.total_tokens
        return wire.ReplicaInfoResponse(
            model=model, active_requests=active,
            total_requests=total_reqs, total_tokens=total_toks)

    def HealthCheck(self, request, context):  # noqa: N802
        return wire.HealthCheckResponse(
            healthy=any(r.healthy for r in self.manager.replicas))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Embedding replica manager of the PyTorch port")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--num-replicas", type=int, default=1)
    parser.add_argument("--replica-base-port", type=int, default=None)
    parser.add_argument("--policy", default="round_robin", choices=POLICIES)
    parser.add_argument("--model", default=None)
    parser.add_argument("--config", default=None,
                        help="EngineConfig JSON file of the replicas")
    parser.add_argument("--device", default=None,
                        help="the replicas' device (their default: cuda:0)")
    parser.add_argument("--host", default="0.0.0.0")
    args = parser.parse_args(argv)

    replica_args = ["--host", "127.0.0.1"]
    for flag, val in (("--model", args.model), ("--config", args.config),
                      ("--device", args.device)):
        if val:
            replica_args += [flag, val]
    base = args.replica_base_port or args.port + 1
    exit_on_sigterm()
    manager = ReplicaManager(base, args.num_replicas, replica_args,
                             policy=args.policy)
    server = Server(max_workers=16)
    try:
        manager.wait_ready(min_replicas=args.num_replicas)
        server.add_servicer(ManagerServicer(manager))
        port = server.start(args.host, args.port)
        print(f"manager ready on :{port} ({args.num_replicas} replicas)",
              flush=True)
        server.wait_for_termination()
    finally:
        server.stop()
        manager.shutdown()


if __name__ == "__main__":
    main()
