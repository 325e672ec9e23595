"""The embedding service's transport: gRPC's framing over HTTP/1.1.

Counterpart of ``arcticinference_tpu/embedding/codegen.py`` (the service
glue and the stubs).  The JAX fleet speaks gRPC; the card's machine has
no ``grpc`` package, so the port carries the same messages
(``wire.py``), methods and status codes over the port's standard-library
HTTP layer (``serving/http.py``).  This is the one deliberate difference
from the JAX fleet:

- each RPC is ``POST /arcticinference_tpu.embedding.InferenceService/
  <Method>``;
- a body is gRPC's length-prefixed message framing: one flag byte (0)
  and a 4-byte big-endian length before each message's bytes;
- a unary answer is one frame; ``Generate`` answers a chunked stream of
  frames, one per ``GenerateResponse``;
- an error is an HTTP error status whose JSON body carries the gRPC
  status code and details (``{"code": 3, "details": "..."}``); an error
  after a stream has begun is a last frame with flag ``0x80`` holding
  the same JSON.

:class:`RpcError` tells a peer's own error answer (``transport`` false:
the replica refused the request) from a transport failure (``transport``
true: refused or reset connection, timeout, truncated answer), which is
what a manager's failover needs.

Server side: :class:`Server` (``add_servicer``, ``start``, ``stop``,
``wait_for_termination``, as a ``grpc.server``) runs each unary method
of a servicer on a thread pool, with a :class:`ServicerContext` whose
``abort(code, details)`` ends the call with that status.  Client side:
:class:`InferenceStub` (blocking, one shared background event loop) and
:class:`AsyncInferenceStub` (``await``), one method per RPC.
"""

from __future__ import annotations

import asyncio
import json
import struct
import threading
from concurrent import futures
from enum import IntEnum
from typing import AsyncIterator, Iterator, Optional

from arcticinference_tpu_torch.embedding import wire
from arcticinference_tpu_torch.serving import http

SERVICE_NAME = "arcticinference_tpu.embedding.InferenceService"
CONTENT_TYPE = "application/octet-stream"

#: Unary methods and server-streaming methods: (request, response) types.
METHODS = {
    "Encode": (wire.EncodeRequest, wire.EncodeResponse),
    "Abort": (wire.AbortRequest, wire.AbortResponse),
    "GetReplicaInfo": (wire.ReplicaInfoRequest, wire.ReplicaInfoResponse),
    "HealthCheck": (wire.HealthCheckRequest, wire.HealthCheckResponse),
}
STREAM_METHODS = {"Generate": (wire.GenerateRequest, wire.GenerateResponse)}

_TRAILER = 0x80


class StatusCode(IntEnum):
    """The gRPC status codes the service uses."""
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14


# The HTTP status of each code's error answer (gRPC's own mapping).
_HTTP_STATUS = {1: 499, 3: 400, 4: 504, 12: 501, 13: 500, 14: 503}
_CODE_OF_HTTP = {404: 12, 405: 12, 400: 3, 413: 3, 503: 14, 504: 4}


class RpcError(Exception):
    """A call that ended without its answer.  ``code()`` and
    ``details()`` as ``grpc.RpcError``; ``transport`` is true when no
    answer came from the peer at all."""

    def __init__(self, code: int, details: str, transport: bool = False):
        super().__init__(f"status {int(code)}: {details}")
        self._code = int(code)
        self._details = details
        self.transport = transport

    def code(self) -> int:
        return self._code

    def details(self) -> str:
        return self._details


class ServicerContext:
    """What a servicer method gets beside its request."""

    def abort(self, code: int, details: str):
        raise RpcError(code, details)


def frame(data: bytes, flag: int = 0) -> bytes:
    return struct.pack(">BI", flag, len(data)) + data


def unframe(buf: bytes) -> Iterator[tuple[int, bytes]]:
    """(flag, message bytes) of each frame in ``buf``."""
    pos = 0
    while pos < len(buf):
        if pos + 5 > len(buf):
            raise ValueError("truncated frame header")
        flag, n = struct.unpack_from(">BI", buf, pos)
        pos += 5
        if pos + n > len(buf):
            raise ValueError("truncated frame")
        yield flag, buf[pos:pos + n]
        pos += n


def _error_body(code: int, details: str) -> bytes:
    return json.dumps({"code": int(code), "details": details}).encode()


def _error_response(e: RpcError) -> http.Response:
    return http.Response(_error_body(e.code(), e.details()),
                         _HTTP_STATUS.get(e.code(), 500),
                         "application/json")


def _peer_error(status: int, body: bytes) -> RpcError:
    """The RpcError of an error answer: its JSON code and details, or
    for a body without them (the HTTP layer's own 404 / 405 / 400) the
    code of its status."""
    try:
        obj = json.loads(body)
        return RpcError(int(obj["code"]), str(obj["details"]))
    except (ValueError, KeyError, TypeError):
        return RpcError(_CODE_OF_HTTP.get(status, StatusCode.UNKNOWN),
                        body.decode("utf-8", "replace"))


def _unexpected(e: BaseException) -> RpcError:
    return RpcError(StatusCode.UNKNOWN,
                    f"Exception calling application: {e}")


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

class _Stream:
    """A servicer's response generator driven from the event loop: each
    ``next`` and the final ``close`` run on the pool, one at a time."""

    _END = object()

    def __init__(self, gen, pool):
        self._gen = gen
        self._pool = pool
        self._lock = threading.Lock()

    def _next(self):
        with self._lock:
            return next(self._gen, self._END)

    def _close(self):
        with self._lock:
            self._gen.close()

    async def next(self):
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, self._next)

    def close(self) -> None:
        try:
            self._pool.submit(self._close)
        except RuntimeError:     # the pool is shut down: nothing runs it
            pass


def _request_message(body: bytes, req_type) -> wire.Message:
    """The one framed message of a request body (RpcError INTERNAL for a
    malformed one, as gRPC answers a message it cannot parse)."""
    try:
        (_, data), = unframe(body)
        return req_type.FromString(data)
    except ValueError as e:
        raise RpcError(StatusCode.INTERNAL,
                       f"bad request message: {e}") from e


def _unary_handler(fn, req_type, pool):
    async def handler(request: http.Request):
        try:
            msg = _request_message(request.body, req_type)
            resp = await asyncio.get_running_loop().run_in_executor(
                pool, fn, msg, ServicerContext())
        except RpcError as e:
            return _error_response(e)
        except Exception as e:  # noqa: BLE001 — a servicer fault
            return _error_response(_unexpected(e))
        return http.Response(frame(resp.SerializeToString()), 200,
                             CONTENT_TYPE)
    return handler


def _stream_handler(fn, req_type, pool):
    async def handler(request: http.Request):
        try:
            msg = _request_message(request.body, req_type)
        except RpcError as e:
            return _error_response(e)
        stream = _Stream(fn(msg, ServicerContext()), pool)
        try:
            try:
                item = await stream.next()
            except RpcError as e:
                return _error_response(e)
            except Exception as e:  # noqa: BLE001
                return _error_response(_unexpected(e))
            resp = http.StreamResponse(headers={
                "Content-Type": CONTENT_TYPE})
            await resp.prepare(request)
            while item is not _Stream._END:
                await resp.write(frame(item.SerializeToString()))
                try:
                    item = await stream.next()
                except Exception as e:  # noqa: BLE001 — after the head
                    err = e if isinstance(e, RpcError) else _unexpected(e)
                    await resp.write(frame(
                        _error_body(err.code(), err.details()), _TRAILER))
                    break
            return resp
        finally:
            # Ends the servicer's generator (its ``finally`` blocks run),
            # also when the client left and the handler was cancelled.
            stream.close()
    return handler


class Server:
    """The service on the port's HTTP layer, run on an event loop of its
    own thread; servicer methods run on a pool of ``max_workers``."""

    def __init__(self, max_workers: int = 8):
        self.pool = futures.ThreadPoolExecutor(max_workers=max_workers)
        self.app = http.App()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def add_servicer(self, servicer) -> None:
        """Routes for every method ``servicer`` has (the manager has no
        ``Generate``: its route then answers 404, UNIMPLEMENTED)."""
        for table, make in ((METHODS, _unary_handler),
                            (STREAM_METHODS, _stream_handler)):
            for name, (req_type, _) in table.items():
                fn = getattr(servicer, name, None)
                if fn is not None:
                    self.app.add_route("POST", f"/{SERVICE_NAME}/{name}",
                                       make(fn, req_type, self.pool))

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on (``host``, ``port``); returns the bound port
        (``port=0`` picks a free one)."""
        self._loop = asyncio.new_event_loop()
        bound: futures.Future = futures.Future()

        def run():
            asyncio.set_event_loop(self._loop)
            try:
                bound.set_result(self._loop.run_until_complete(
                    self.app.start(host, port)))
            except BaseException as e:  # noqa: BLE001 — handed back
                bound.set_exception(e)
                return
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="embedding-server")
        self._thread.start()
        return bound.result()

    def stop(self, grace: Optional[float] = None) -> None:
        """Stop listening, end open calls and the pool; idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._loop is not None and self._loop.is_running():
            asyncio.run_coroutine_threadsafe(
                self.app.stop(), self._loop).result(timeout=grace or 30)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=30)
        self.pool.shutdown(wait=False, cancel_futures=True)

    def wait_for_termination(self, timeout: Optional[float] = None) -> bool:
        """Block until :meth:`stop`; returns whether it was stopped."""
        return self._stopped.wait(timeout)


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------

_TRANSPORT_ERRORS = (OSError, EOFError, ValueError)


async def _frames(target: str, method: str, req: wire.Message,
                  timeout: Optional[float]) -> AsyncIterator[bytes]:
    """POST ``req`` to ``method``; the answer's messages as they arrive.
    A peer's error answer raises its RpcError; a failed connection, a
    timeout or a truncated answer a transport RpcError."""
    url = f"http://{target}/{SERVICE_NAME}/{method}"
    try:
        async with http.post(url, data=frame(req.SerializeToString()),
                             headers={"Content-Type": CONTENT_TYPE},
                             timeout=timeout) as r:
            if r.status != 200:
                raise _peer_error(r.status, await r.read())
            buf = b""
            async for data in r.iter_chunks():
                buf += data
                while len(buf) >= 5:
                    flag, n = struct.unpack_from(">BI", buf)
                    if len(buf) < 5 + n:
                        break
                    payload, buf = buf[5:5 + n], buf[5 + n:]
                    if flag & _TRAILER:
                        raise _peer_error(500, payload)
                    yield payload
            if buf:
                raise ValueError("truncated frame at the end of an answer")
    except asyncio.TimeoutError as e:
        raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                       f"{method} to {target}: deadline exceeded",
                       transport=True) from e
    except _TRANSPORT_ERRORS as e:
        raise RpcError(StatusCode.UNAVAILABLE,
                       f"{method} to {target}: {type(e).__name__}: {e}",
                       transport=True) from e


async def unary(target: str, method: str, req: wire.Message,
                timeout: Optional[float] = None) -> wire.Message:
    answers = [p async for p in _frames(target, method, req, timeout)]
    if len(answers) != 1:
        raise RpcError(StatusCode.UNAVAILABLE,
                       f"{method} to {target}: {len(answers)} messages in "
                       "a unary answer", transport=True)
    return METHODS[method][1].FromString(answers[0])


async def server_stream(target: str, method: str, req: wire.Message,
                        timeout: Optional[float] = None
                        ) -> AsyncIterator[wire.Message]:
    """The messages of a streaming answer as they arrive."""
    resp_type = STREAM_METHODS[method][1]
    async for payload in _frames(target, method, req, timeout):
        yield resp_type.FromString(payload)


class AsyncInferenceStub:
    """``await stub.Encode(request, timeout=...)``; ``async for`` over
    ``stub.Generate(request, timeout=...)``."""

    def __init__(self, target: str):
        self.target = target
        for name in METHODS:
            setattr(self, name, self._unary(name))

    def _unary(self, name):
        async def call(request, timeout: Optional[float] = None):
            return await unary(self.target, name, request, timeout)
        return call

    def Generate(self, request, timeout: Optional[float] = None):  # noqa: N802
        return server_stream(self.target, "Generate", request, timeout)


_bg_lock = threading.Lock()
_bg_loop: Optional[asyncio.AbstractEventLoop] = None


def background_loop() -> asyncio.AbstractEventLoop:
    """The event loop, on a daemon thread of its own, that carries every
    blocking stub's calls in this process."""
    global _bg_loop
    with _bg_lock:
        if _bg_loop is None:
            loop = asyncio.new_event_loop()
            threading.Thread(target=loop.run_forever, daemon=True,
                             name="embedding-client").start()
            _bg_loop = loop
        return _bg_loop


class InferenceStub:
    """Blocking twin of :class:`AsyncInferenceStub`: ``stub.Encode(
    request, timeout=...)``, ``for resp in stub.Generate(request)``."""

    def __init__(self, target: str):
        self.target = target
        self._async = AsyncInferenceStub(target)
        for name in METHODS:
            setattr(self, name, self._unary(name))

    def _unary(self, name):
        acall = getattr(self._async, name)

        def call(request, timeout: Optional[float] = None):
            return asyncio.run_coroutine_threadsafe(
                acall(request, timeout), background_loop()).result()
        return call

    def Generate(self, request, timeout: Optional[float] = None  # noqa: N802
                 ) -> Iterator[wire.GenerateResponse]:
        loop = background_loop()
        agen = self._async.Generate(request, timeout)
        try:
            while True:
                try:
                    yield asyncio.run_coroutine_threadsafe(
                        agen.__anext__(), loop).result()
                except StopAsyncIteration:
                    return
        finally:
            asyncio.run_coroutine_threadsafe(agen.aclose(), loop).result()
