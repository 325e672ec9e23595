"""Start a world of ranks from one process.

The JAX package drives a mesh from one controller; a ``torch.distributed``
mesh is one process per rank.  :class:`World` starts ``nprocs`` rank
processes (``torch.multiprocessing``, spawn), joins them in a process
group on the caller's backend over a free port of 127.0.0.1, and then
runs functions on them: :meth:`World.run` sends a picklable function and
its arguments to the chosen ranks and returns each rank's result, or
raises with the failing rank's traceback.  Every wait has a deadline,
so a rank that diverges fails the call instead of hanging it.
:func:`spawn` is the one-shot form.

Outside this helper a world is any launcher's (``torchrun
--nproc-per-node N``): the port only needs ``torch.distributed``
initialized before ``LLM`` is built.

    from arcticinference_tpu_torch.parallel.world import spawn
    outs = spawn(my_rank_fn, 2, args=(cfg_dict,), backend="gloo")

A rank function runs with ``torch.distributed`` initialized; ranks
outside a call's ``ranks`` sit idle, and :func:`subgroup` gives the
group of the ranks that run it.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from multiprocessing import connection as mp_connection

from arcticinference_tpu_torch.parallel.mesh import group_of

#: Seconds a call may take on every rank before the world is torn down.
DEFAULT_CALL_TIMEOUT_S = 600.0

def free_port() -> int:
    """A TCP port of 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def subgroup(ranks: Sequence[int]):
    """The process group of global ``ranks`` (the default group when it
    is all of them), made once per process by its members only
    (``mesh.group_of``)."""
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return group_of(ranks)


def _rank_main(rank: int, nprocs: int, port: int, backend: str,
               timeout_s: float, threads: Optional[int], conn) -> None:
    if threads:
        torch.set_num_threads(threads)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout_s))
        conn.send(("ok", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except BaseException:
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``nprocs`` rank processes joined in one process group; see the
    module docstring.  ``threads`` sets each rank's intra-op threads;
    ``timeout_s`` bounds the process group's collectives and every
    call's wait."""

    def __init__(self, nprocs: int, backend: str = "gloo",
                 timeout_s: float = DEFAULT_CALL_TIMEOUT_S,
                 threads: Optional[int] = None):
        self.nprocs = nprocs
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        port = free_port()
        self._conns, self._procs = [], []
        for r in range(nprocs):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, nprocs, port, backend, timeout_s,
                                  threads, child))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._broken: Optional[str] = None
        self._gather(range(nprocs), timeout_s, "start")

    def _gather(self, ranks, timeout_s: float, what: str) -> list:
        """Each rank's answer; the first failure (or the deadline) tears
        the world down and raises, without waiting for the others."""
        deadline = time.monotonic() + timeout_s
        pending = {self._conns[r]: r for r in ranks}
        out = {}
        error = None
        while pending and error is None:
            left = deadline - time.monotonic()
            ready = mp_connection.wait(list(pending), max(left, 0.0))
            if not ready:
                error = (f"ranks {sorted(pending.values())}: no answer "
                         f"within {timeout_s} s ({what})")
                break
            for conn in ready:
                r = pending.pop(conn)
                try:
                    status, val = conn.recv()
                except (EOFError, OSError):
                    status, val = "err", "the process exited"
                if status != "ok":
                    error = f"rank {r} failed ({what}):\n{val}"
                    break
                out[r] = val
        if error is not None:
            self._broken = error
            self.close()
            raise RuntimeError(error)
        return [out[r] for r in ranks]

    def run(self, fn: Callable, *args, ranks: Optional[Sequence[int]] = None,
            timeout_s: Optional[float] = None, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on each of ``ranks`` (default: all),
        results in rank order.  A failing rank, or any rank past the
        deadline, tears the world down and raises."""
        if self._broken is not None:
            raise RuntimeError(f"the world is down: {self._broken}")
        ranks = list(range(self.nprocs)) if ranks is None else list(ranks)
        for r in ranks:
            self._conns[r].send((fn, args, kwargs))
        return self._gather(ranks, timeout_s or self.timeout_s, fn.__name__)

    def close(self) -> None:
        """Stop every rank (idempotent)."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 10
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.1))
            if p.is_alive():
                p.kill()
                p.join(5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        if self._broken is None:
            self._broken = "closed"

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          backend: str = "gloo", timeout_s: float = DEFAULT_CALL_TIMEOUT_S,
          threads: Optional[int] = None) -> list:
    """Start ``nprocs`` ranks, run ``fn(*args)`` on each with
    ``torch.distributed`` initialized, stop them, and return the results
    in rank order (or raise with the failing rank's traceback)."""
    with World(nprocs, backend, timeout_s, threads) as world:
        return world.run(fn, *args)
