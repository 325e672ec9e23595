"""Serving one mesh from one process: the leader's step broadcast, the
follower mirror and the watchdog.

Counterpart of ``arcticinference_tpu/parallel/multihost.py``.  The JAX
package drives a mesh from one controller, so its server needs a channel
only across hosts.  Here every rank is a process of its own
(``parallel/world.py``), so any served mesh, on one host or several, runs
this way:

- process 0 (the **leader**) runs the scheduler, the HTTP front end and
  the step loop;
- every other process (a **follower**) runs :func:`follower_serve`: it
  receives each device step's host inputs over a TCP channel and issues
  the same step, so every rank joins every collective of the forward.

The channel carries length-prefixed pickles over TCP, not a collective:
a follower blocked in a collective gives no sign of life, while the
channel's heartbeats do.  The leader's watchdog reads them and reports a
follower lost by EOF or by heartbeat silence; the server then fails its
requests (``AsyncLLMEngine.mark_dead``) instead of leaving them waiting
on a collective that never completes.  A follower that loses its leader
raises ``ConnectionError`` (the ``serve`` command exits 3).

What the leader broadcasts, and the follower replays:

- ``dispatch``: a step's arrays and shapes, the mesh mode's token count,
  whether it passes tokens through from the previous step's vector, and
  for a sampled step the state of the engine's ``torch.Generator`` (the
  follower loads it before its launch, so no draw of the leader's alone
  shifts the follower's stream) (``ModelRunner.dispatch``);
- ``fused`` / ``fused_exit``: a fused decode step's program key and
  uploads, the loop's state and its generator's seed at entry, the block
  table when it changed (``engine/fused_decode.py``);
- ``propose``: a drafter's rows after a synchronous step (a tied
  drafter's head is the target's tp-cut LM head, whose logits are
  gathered);
- ``stop``: the leader closed the channel.

Entries that run device work outside these (scoring, full logits, causal
encode) refuse on a served mesh (``ModelRunner.check_unmirrored``).  With
in-engine dp or a pipeline the broadcast is the same: a ``dispatch``
carries the whole step's dp-layout arrays and each follower uploads its
own dp group's slice of them; the fused loop's state stays whole on
every rank, each running its group's slots and its stage's layers.
"""

from __future__ import annotations

import datetime
import io
import logging
import os
import pickle
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from arcticinference_tpu_torch.utils import resolve_device

logger = logging.getLogger("arcticinference_tpu_torch")

_LEN = struct.Struct("<Q")

#: Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 600.0


# --------------------------------------------------------------------- #
# The process group
# --------------------------------------------------------------------- #

def _local_ranks(num_processes: int, process_id: int) -> tuple[int, int]:
    """(processes on this host, this process's index among them):
    ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` when a launcher sets them, else
    one host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return local, int(os.environ.get("LOCAL_RANK", process_id % local))


def choose_backend(device: torch.device, num_processes: int) -> str:
    """``gloo`` on the CPU and for ranks that share a card (NCCL refuses
    two ranks on one device), ``nccl`` when every rank of this host has a
    card of its own.  Every rank derives the same answer from its host's
    card count, with no flag."""
    if device.type != "cuda":
        return "gloo"
    local, _ = _local_ranks(num_processes, 0)
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def rank_device(device: Union[str, torch.device, None], num_processes: int,
                process_id: int) -> torch.device:
    """The process's device: ``device`` when given, else its own card
    ``cuda:<local rank>`` when each local rank has one, else ``cuda:0``,
    which the ranks then share."""
    if device is None:
        local, local_rank = _local_ranks(num_processes, process_id)
        own = torch.cuda.is_available() and \
            torch.cuda.device_count() >= local
        device = f"cuda:{local_rank if own else 0}"
    return resolve_device(device)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               device: Union[str, torch.device, None] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group at ``coordinator_address``
    (``host:port`` of process 0) on :func:`choose_backend`'s backend, with
    a finite ``timeout_s`` for every collective; returns the process's
    device (:func:`rank_device`).  NCCL that cannot start raises: nothing
    falls back to gloo."""
    dev = rank_device(device, num_processes, process_id)
    backend = choose_backend(dev, num_processes)
    kw = {}
    if backend == "nccl":
        _, local_rank = _local_ranks(num_processes, process_id)
        if dev.index != local_rank:
            raise ValueError(
                f"NCCL runs each rank on its own card: process {process_id} "
                f"asked for {dev}, its card is cuda:{local_rank} (omit "
                "--device, or give each process its own card)")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    # NCCL connects lazily: a barrier makes a failure show here.
    dist.barrier()
    logger.info("multihost: process %d/%d on %s over %s", process_id,
                num_processes, dev, backend)
    return dev


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_leader() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# --------------------------------------------------------------------- #
# Step broadcast channel (leader -> followers, pickled, length-prefixed)
# --------------------------------------------------------------------- #

def _send_msg(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    while buf.tell() < n:
        try:
            chunk = conn.recv(n - buf.tell())
        except OSError as e:
            raise ConnectionError(f"channel lost: {e}") from e
        if not chunk:
            raise ConnectionError("channel closed")
        buf.write(chunk)
    return buf.getvalue()


class LeaderChannel:
    """Accepts one connection per follower; :meth:`broadcast` fans a
    message out to all of them.

    Followers send a one-byte heartbeat upstream every
    :attr:`HB_INTERVAL` seconds; :meth:`start_watchdog` watches for EOF (a
    follower that died) or heartbeat silence (one that is wedged)."""

    HB_INTERVAL = 2.0

    def __init__(self, num_followers: int, port: int,
                 bind_host: str = "0.0.0.0", accept_timeout: float = 300.0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind_host, port))
        self._srv.listen(num_followers)
        self._srv.settimeout(accept_timeout)
        self.conns: list[socket.socket] = []
        self._num = num_followers
        self._lock = threading.Lock()
        self._watchdog: Optional[threading.Thread] = None
        self._stop_watchdog = threading.Event()
        #: why the watchdog gave up on a follower (None while all live).
        self.failed: Optional[str] = None
        #: messages sent, by kind, and the bytes of the last of each kind.
        self.sent: dict[str, int] = {}
        self.last_bytes: dict[str, int] = {}

    def wait_connected(self) -> None:
        """Block until every follower has connected (``accept_timeout``
        bounds each wait)."""
        while len(self.conns) < self._num:
            conn, addr = self._srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            logger.info("follower connected from %s", addr)
            self.conns.append(conn)

    def start_watchdog(self, on_failure: Callable[[int, str], Any],
                       timeout: float = 15.0) -> None:
        """Watch the followers' liveness on a thread; ``on_failure(index,
        reason)`` is called once, for the first follower lost
        (``"disconnected"`` or ``"heartbeat timeout"``)."""

        def run():
            last_hb = {i: time.monotonic() for i in range(len(self.conns))}
            fd_to_idx = {c.fileno(): i for i, c in enumerate(self.conns)}
            while not self._stop_watchdog.is_set():
                try:
                    readable, _, _ = select.select(self.conns, [], [], 0.5)
                except (OSError, ValueError):
                    return                      # the channel was closed
                if self._stop_watchdog.is_set():
                    return
                now = time.monotonic()
                for conn in readable:
                    idx = fd_to_idx.get(conn.fileno(), -1)
                    try:
                        data = conn.recv(4096)
                    except OSError:
                        data = b""
                    if not data:
                        self._fail(on_failure, idx, "disconnected")
                        return
                    last_hb[idx] = now
                for idx, t in last_hb.items():
                    if now - t > timeout:
                        self._fail(on_failure, idx, "heartbeat timeout",
                                   f" (silent for {now - t:.1f} s)")
                        return

        self._watchdog = threading.Thread(target=run, daemon=True,
                                          name="mh-watchdog")
        self._watchdog.start()

    def _fail(self, on_failure, idx: int, reason: str, detail: str = ""):
        self.failed = f"follower {idx} {reason}{detail}"
        logger.error("multihost watchdog: %s", self.failed)
        on_failure(idx, reason)

    def broadcast(self, msg: dict) -> None:
        """Send ``msg`` (a dict with a ``kind``) to every follower."""
        payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        kind = msg.get("kind", "")
        with self._lock:
            for conn in self.conns:
                _send_msg(conn, payload)
            self.sent[kind] = self.sent.get(kind, 0) + 1
            self.last_bytes[kind] = _LEN.size + len(payload)

    def close(self) -> None:
        """Broadcast ``stop`` (the followers return from
        :func:`follower_serve`) and close every socket; idempotent."""
        self._stop_watchdog.set()
        try:
            self.broadcast({"kind": "stop"})
        except OSError:
            pass
        for conn in self.conns:
            conn.close()
        self.conns = []
        self._srv.close()


class FollowerChannel:
    """The follower's end: connects to the leader (retrying until
    ``connect_timeout``), receives its messages and, with ``heartbeat``,
    sends one byte upstream every ``LeaderChannel.HB_INTERVAL`` seconds
    from a thread of its own."""

    def __init__(self, leader_host: str, port: int,
                 connect_timeout: float = 300.0, heartbeat: bool = True):
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._conn = socket.create_connection(
                    (leader_host, port), timeout=5.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conn.settimeout(None)
        self._closed = threading.Event()
        if heartbeat:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="mh-heartbeat").start()

    def _heartbeat_loop(self) -> None:
        while not self._closed.is_set():
            try:
                self._conn.sendall(b"h")
            except OSError:
                return
            self._closed.wait(LeaderChannel.HB_INTERVAL)

    def leader_gone(self, wait: float = 1.0) -> bool:
        """Whether the leader closed the channel (EOF within ``wait``
        seconds, with no message pending)."""
        ready, _, _ = select.select([self._conn], [], [], wait)
        if not ready:
            return False
        try:
            return self._conn.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True

    def recv(self) -> dict:
        """The next message; ``ConnectionError`` when the leader is
        gone."""
        n = _LEN.unpack(_recv_exact(self._conn, _LEN.size))[0]
        return pickle.loads(_recv_exact(self._conn, n))

    def close(self) -> None:
        self._closed.set()
        self._conn.close()


# --------------------------------------------------------------------- #
# Follower mirror loop
# --------------------------------------------------------------------- #

def follower_serve(engine, channel: FollowerChannel) -> dict:
    """Replay every device step the leader broadcasts on this rank's
    ``engine`` (an ``LLMEngine`` built from the leader's config) until
    ``stop``; returns the count of each message kind replayed.
    ``ConnectionError`` when the leader is lost: its channel closes, or a
    step's collective fails and the channel is found closed.

    The follower carries only the previous dispatch's output vector (the
    pipelined step's passthrough source: the leader's ``prev_tokens`` is
    always its previous dispatch's vector, so replaying the dispatches in
    order reproduces it), that dispatch's sample rows (a drafter's input)
    and, while the leader's fused loop is active, the loop's state."""
    mirror = _Mirror(engine)
    counts: dict[str, int] = {}
    while True:
        try:
            msg = channel.recv()
        except ConnectionError as e:
            # A follower with no leader can only deadlock the next
            # collective: leave loudly instead.
            logger.error("follower: leader channel lost (%s)", e)
            raise
        kind = msg.get("kind")
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "stop":
            logger.info("follower: stop received")
            return counts
        try:
            mirror.replay(msg)
        except Exception as e:
            if channel.leader_gone():
                logger.error("follower: leader lost during a step (%s)", e)
                raise ConnectionError(f"leader lost: {e}") from e
            raise


class _Mirror:
    """A follower's replay of the leader's messages on its engine."""

    def __init__(self, engine):
        self.engine = engine
        self.runner = engine.runner
        self.drafter = engine._drafter
        self.last_tokens = self.last_rows = None
        self.fused_state = self.fused_bt = None
        self.fused_fns: dict = {}

    def _upload(self, x) -> torch.Tensor:
        return self.runner.upload_array(np.asarray(x))

    def replay(self, msg: dict) -> None:
        kind = msg["kind"]
        if kind == "dispatch":
            self._dispatch(msg)
        elif kind == "propose":
            idx_tok = self._upload(msg["idx_tok"])
            self.drafter.generate(self.drafter.params, idx_tok[1],
                                  self.last_rows[idx_tok[0].long()])
        elif kind == "fused":
            self._fused(msg)
        elif kind == "fused_exit":
            self.fused_state = self.fused_bt = None
        else:
            logger.warning("follower: unknown message kind %r", kind)

    def _dispatch(self, msg: dict) -> None:
        from arcticinference_tpu_torch.engine.runner import StepInputs

        si = StepInputs(arrays=msg["arrays"], t_pad=msg["t_pad"],
                        s_pad=msg["s_pad"], attn_qb=msg["attn_qb"],
                        sample_row_start=[], sample_row_count=[],
                        total_tokens=msg["total_tokens"])
        gen = self.engine._generator
        if msg["gen_state"] is not None:
            gen.set_state(torch.from_numpy(msg["gen_state"]))
        self.last_tokens, self.last_rows = self.runner.dispatch(
            si, gen, msg["need_topk"],
            prev_tokens=self.last_tokens if msg["use_prev"] else None,
            _mirror=True)

    def _fused(self, msg: dict) -> None:
        from arcticinference_tpu_torch.engine.fused_decode import (
            build_fused_step)

        runner, drafter = self.runner, self.drafter
        if msg["state"] is not None:
            self.fused_state = {k: self._upload(v)
                                for k, v in msg["state"].items()}
            gen = torch.Generator(device=runner.device)
            gen.manual_seed(msg["gen_seed"])
            self.fused_state["generator"] = gen
        if msg["bt"] is not None:
            self.fused_bt = self._upload(msg["bt"])
        key = (msg["b"], msg["k"], msg["need_sampling"], msg["wide"])
        fn = self.fused_fns.get(key)
        if fn is None:
            fn = self.fused_fns[key] = build_fused_step(
                runner, drafter, msg["k"], msg["need_sampling"], msg["eos"],
                use_suffix=msg["use_suffix"], path_len_max=msg["plen"],
                ring_w=msg["ring_w"], wide=msg["wide"])
        h_pack = None if msg["paths"] is None else self._upload(msg["paths"])
        self.fused_state, telem, _ = fn(
            None if drafter is None else drafter.params, self.fused_state,
            self.fused_bt, h_pack)
        runner.fold_digest(telem)
