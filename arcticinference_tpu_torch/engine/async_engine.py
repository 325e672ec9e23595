"""Async engine: a background step loop and per-request token streams.

The port's counterpart of ``arcticinference_tpu/engine/async_engine.py``
(the role vLLM's AsyncLLMEngine plays for the reference's servers).  The
blocking step loop runs on a thread of its own; token deltas reach each
request's ``asyncio.Queue`` through ``loop.call_soon_threadsafe``.

Every engine mutation (``add_request``, ``abort_request``, a step, a
score, the profiler's start and stop) runs behind ``_engine_lock``, so
the device work of the step thread and of other threads is enqueued on
the device's one default stream in a fixed order; the pipelined step's
events (``engine/engine.py``) are recorded on that stream too.
:meth:`AsyncLLMEngine.call_on_engine_thread` runs a function on the step
thread between steps: the server starts and stops ``torch.profiler``
there, so a trace holds the steps' host ops beside every kernel.

On a served mesh (``parallel/multihost.py``) the engine is the leader's:
the runner's channel broadcasts every device step to the followers,
:meth:`AsyncLLMEngine.close` closes it (the followers get ``stop``), and
the channel's watchdog calls :meth:`AsyncLLMEngine.mark_dead` when a
follower is lost.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
import traceback
import uuid
from collections import deque
from dataclasses import dataclass
from typing import AsyncIterator, Optional, Union

import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.engine.engine import LLMEngine, PENDING_TOKEN
from arcticinference_tpu_torch.engine.request import Request, SamplingParams

logger = logging.getLogger("arcticinference_tpu_torch")


@dataclass
class StreamChunk:
    req_id: str
    new_token_ids: list[int]
    finished: bool
    finish_reason: Optional[str] = None
    logprobs: Optional[list] = None


class AsyncLLMEngine:

    def __init__(self, config: EngineConfig,
                 device: Union[str, torch.device, None] = None,
                 group=None):
        self.dead = False
        self.dead_reason: Optional[str] = None
        # Engine-loop liveness stamp: a wedged device step stops
        # advancing it, which /health surfaces as "stalled" so routers
        # pull the replica.
        self.last_progress = time.time()
        self.stall_timeout_s = 60.0
        self.engine = LLMEngine(config, device=device, group=group)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queues: dict[str, asyncio.Queue] = {}
        self._sent_len: dict[str, int] = {}
        self._lock = threading.Lock()
        self._engine_lock = threading.Lock()  # serialises engine mutation
        # (function, args, future) to run on the step thread.
        self._calls: deque = deque()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-step")
        self._thread.start()

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)
        self.engine.close()
        ch = self.engine.runner.mh_channel
        if ch is not None:
            ch.close()          # broadcasts stop: the followers return

    def attach_channel(self, channel) -> None:
        """Serve a mesh: broadcast every step over the leader's
        ``channel`` (its followers connected) and mark the engine dead
        when its watchdog loses a follower."""
        with self._engine_lock:
            self.engine.runner.mh_channel = channel
        channel.start_watchdog(
            lambda idx, reason: self.mark_dead(f"follower {idx} {reason}"))

    # -- background loop (engine thread) --------------------------------

    def _fail_streams(self) -> None:
        with self._lock:
            for req_id, q in self._queues.items():
                self._push(q, StreamChunk(req_id, [], True, "engine_error"))
            self._queues.clear()

    def mark_dead(self, reason: str) -> None:
        """Fail the engine from outside: reject new requests and error
        every live stream.  A step blocked on the device cannot be
        cancelled, but clients see a clean error instead of a hang."""
        logger.error("engine marked dead: %s", reason)
        self.dead = True
        self.dead_reason = reason
        self._fail_streams()

    @property
    def stalled(self) -> bool:
        return (self.engine.has_unfinished
                and time.time() - self.last_progress > self.stall_timeout_s)

    def call_on_engine_thread(self, fn, *args) -> concurrent.futures.Future:
        """Run ``fn(*args)`` on the step thread, between steps and behind
        the engine lock; the future holds its result or exception."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._calls.append((fn, args, fut))
        self._wake.set()
        return fut

    def _run_calls(self) -> None:
        while self._calls:
            fn, args, fut = self._calls.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                with self._engine_lock:
                    result = fn(*args)
            except Exception as e:  # noqa: BLE001 — handed to the caller
                fut.set_exception(e)
            else:
                fut.set_result(result)

    def _run(self) -> None:
        while not self._stop:
            self.last_progress = time.time()
            self._run_calls()
            if not self.engine.has_unfinished:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                with self._engine_lock:
                    finished = {r.req_id: r for r in self.engine.step()}
            except Exception:  # noqa: BLE001 — engine died; fail streams
                logger.error("engine step failed:\n%s",
                             traceback.format_exc())
                self.dead = True
                self._fail_streams()
                return
            with self._lock:
                items = list(self._queues.items())
            for req_id, q in items:
                req = finished.get(req_id)
                if req is None:
                    req = self._find_request(req_id)
                    if req is None:
                        continue
                sent = self._sent_len.get(req_id, 0)
                out = req.output_token_ids
                # Only the host-known prefix is streamable (the pipelined
                # step leaves placeholders for tokens still on the device).
                try:
                    visible = out.index(PENDING_TOKEN)
                except ValueError:
                    visible = len(out)
                new = out[sent:visible]
                done = req.status.is_finished
                if new or done:
                    self._sent_len[req_id] = sent + len(new)
                    self._push(q, StreamChunk(
                        req_id=req_id, new_token_ids=list(new),
                        finished=done,
                        finish_reason=(req.status.name.lower()
                                       if done else None),
                        logprobs=(list(req.output_logprobs)
                                  if done and req.output_logprobs
                                  else None)))
                if done:
                    with self._lock:
                        self._queues.pop(req_id, None)
                        self._sent_len.pop(req_id, None)

    def _find_request(self, req_id: str) -> Optional[Request]:
        for r in (*self.engine.scheduler.running,
                  *self.engine.scheduler.waiting):
            if r.req_id == req_id:
                return r
        return None

    def _push(self, q: asyncio.Queue, chunk: StreamChunk) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(q.put_nowait, chunk)

    # -- client API (event loop) -----------------------------------------

    async def generate(
        self,
        prompt_token_ids: list[int],
        sampling: Optional[SamplingParams] = None,
        req_id: Optional[str] = None,
    ) -> AsyncIterator[StreamChunk]:
        """Submit a request; yields StreamChunks until finished."""
        if self.dead:
            raise RuntimeError("engine is dead (see server logs)")
        self._loop = asyncio.get_running_loop()
        req_id = req_id or f"req-{uuid.uuid4().hex[:12]}"
        q: asyncio.Queue = asyncio.Queue()
        with self._lock:
            self._queues[req_id] = q
            self._sent_len[req_id] = 0
        with self._engine_lock:
            self.engine.add_request(req_id, prompt_token_ids, sampling)
        self._wake.set()
        while True:
            chunk = await q.get()
            yield chunk
            if chunk.finished:
                return

    async def abort(self, req_id: str) -> None:
        with self._engine_lock:
            self.engine.abort_request(req_id)
        with self._lock:
            q = self._queues.pop(req_id, None)
            self._sent_len.pop(req_id, None)
        if q is not None:
            self._push(q, StreamChunk(req_id, [], True, "aborted"))
