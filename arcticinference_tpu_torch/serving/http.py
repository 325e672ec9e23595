"""HTTP/1.1 on the standard library's asyncio streams.

The JAX package's server, router and Dynasor proxy are built on
``aiohttp``; the port serves the same routes on ``asyncio.start_server``
and calls backends with ``asyncio.open_connection`` (as ``st_io.py``
stands in for ``safetensors``), so it needs no package beyond torch.

Server side (:class:`App`): routes by (method, path) to
``async def handler(request) -> Response | StreamResponse``; JSON request
bodies by ``Content-Length`` (or chunked); JSON responses
(:func:`json_response`); :class:`HTTPError` for status errors with the
bodies the JAX handlers return; :class:`StreamResponse` for SSE
(``text/event-stream``, sent chunked).  Connections are kept alive
between requests.  While a handler runs, its connection is watched for
the client closing it: the handler's task is then cancelled, as
``aiohttp`` does, so a handler releases what it holds (an engine request)
in its ``CancelledError`` path.

Client side (:func:`request`): GET or POST, one connection per request,
the response read by ``Content-Length``, ``Transfer-Encoding: chunked``
or until the server closes; the body whole (``read`` / ``json``) or as
it arrives (``iter_chunks`` / ``iter_lines``).
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
import signal
import traceback
from http import HTTPStatus
from typing import Any, AsyncIterator, Awaitable, Callable, Optional, Union
from urllib.parse import urlsplit

logger = logging.getLogger("arcticinference_tpu_torch.http")

#: Longest request or status line plus headers accepted.
MAX_HEAD_BYTES = 1 << 16
#: Largest request body accepted.
MAX_BODY_BYTES = 64 << 20
#: How often a running handler's connection is checked for the client
#: having closed it.
DISCONNECT_POLL_S = 0.05

_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json; charset=utf-8"


def _phrase(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class HTTPError(Exception):
    """A status error; ``text`` is the body, sent as ``content_type``."""

    def __init__(self, status: int, text: Optional[str] = None,
                 content_type: str = _TEXT):
        super().__init__(status, text)
        self.status = status
        self.text = f"{status}: {_phrase(status)}" if text is None else text
        self.content_type = content_type


class Response:

    def __init__(self, body: Union[bytes, str] = b"", status: int = 200,
                 content_type: str = _TEXT,
                 headers: Optional[dict] = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(data: Any, status: int = 200) -> Response:
    return Response(_json.dumps(data), status, _JSON)


async def _read_chunked(reader: asyncio.StreamReader, limit: int
                        ) -> AsyncIterator[bytes]:
    """The pieces of a chunked body (RFC 9112 §7.1); trailers skipped."""
    total = 0
    while True:
        line = await reader.readline()
        if not line:
            raise asyncio.IncompleteReadError(b"", None)
        size = int(line.split(b";", 1)[0].strip() or b"0", 16)
        if size == 0:
            while (await reader.readline()).strip():
                pass
            return
        total += size
        if total > limit:
            raise HTTPError(413)
        data = await reader.readexactly(size)
        await reader.readexactly(2)
        yield data


def _parse_head(head: bytes) -> tuple[str, dict[str, str]]:
    """(start line, headers with lower-case names)."""
    lines = head.decode("latin-1").split("\r\n")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HTTPError(400, "malformed header line")
        headers[name.strip().lower()] = value.strip()
    return lines[0], headers


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

class Request:

    def __init__(self, method: str, target: str, version: str,
                 headers: dict[str, str], body: bytes):
        self.method = method
        self.path = urlsplit(target).path
        self.version = version
        self.headers = headers
        self.body = body
        self.writer: Optional[asyncio.StreamWriter] = None
        # Set once a StreamResponse has sent its head on this request.
        self.response_started = False

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    async def read(self) -> bytes:
        return self.body

    async def json(self) -> Any:
        try:
            return _json.loads(self.body or b"null")
        except ValueError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


def _head_bytes(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {_phrase(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response written as it is produced (chunked transfer coding):
    ``await prepare(request)``, ``await write(data)`` any number of times,
    ``await write_eof()``."""

    def __init__(self, status: int = 200, headers: Optional[dict] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self.prepared = False
        self.finished = False

    async def prepare(self, request: Request) -> None:
        self._writer = request.writer
        headers = {"Content-Type": _TEXT, **self.headers,
                   "Transfer-Encoding": "chunked"}
        self._writer.write(_head_bytes(self.status, headers))
        self.prepared = request.response_started = True
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        w = self._writer
        if w.is_closing():
            raise ConnectionResetError("client closed the connection")
        w.write(b"%x\r\n%s\r\n" % (len(data), data))
        await w.drain()

    async def write_eof(self) -> None:
        if self.finished:
            return
        self.finished = True
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class App:
    """Routes and lifecycle hooks; :meth:`start` serves them on a port,
    :meth:`run` until SIGINT or SIGTERM."""

    def __init__(self):
        self.routes: dict[tuple[str, str], Handler] = {}
        self.on_startup: list[Callable[["App"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["App"], Awaitable[None]]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.Task] = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes[(method.upper(), path)] = handler

    # -- lifecycle -------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Run the startup hooks, then listen; returns the bound port
        (``port=0`` picks a free one)."""
        for hook in self.on_startup:
            await hook(self)
        self._server = await asyncio.start_server(
            self._serve_connection, host, port, limit=MAX_HEAD_BYTES)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop listening, cancel open connections, run the cleanup
        hooks."""
        if self._server is not None:
            self._server.close()
            self._server = None
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        for hook in self.on_cleanup:
            await hook(self)

    def run(self, host: str, port: int) -> None:
        """Serve until SIGINT or SIGTERM, then :meth:`stop`."""

        async def main():
            stopping = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stopping.set)
            bound = await self.start(host, port)
            print(f"serving on http://{host}:{bound}", flush=True)
            try:
                await stopping.wait()
            finally:
                await self.stop()

        asyncio.run(main())

    # -- connections -----------------------------------------------------

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except HTTPError as e:
                    await self._send(writer, Response(e.text, e.status,
                                                      e.content_type), False)
                    break
                if request is None:
                    break
                request.writer = writer
                if not await self._dispatch(request, reader, writer):
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise HTTPError(400, "incomplete request head") from e
            return None
        except asyncio.LimitOverrunError as e:
            raise HTTPError(431) from e
        line, headers = _parse_head(head[:-4])
        try:
            method, target, version = line.split(" ")
        except ValueError as e:
            raise HTTPError(400, "malformed request line") from e
        if headers.get("transfer-encoding", "").lower() == "chunked":
            body = b"".join([p async for p in
                             _read_chunked(reader, MAX_BODY_BYTES)])
        else:
            try:
                n = int(headers.get("content-length", "0") or 0)
            except ValueError as e:
                raise HTTPError(400, "malformed Content-Length") from e
            if n < 0 or n > MAX_BODY_BYTES:
                raise HTTPError(413)
            body = await reader.readexactly(n) if n else b""
        return Request(method.upper(), target, version, headers, body)

    async def _dispatch(self, request: Request, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> bool:
        """Run the request's handler and send what it returns; returns
        whether the connection stays open."""
        handler = self.routes.get((request.method, request.path))
        if handler is None:
            known = any(path == request.path for _, path in self.routes)
            status = 405 if known else 404
            await self._send(writer, Response(
                f"{status}: {_phrase(status)}", status), request.keep_alive)
            return request.keep_alive
        task = asyncio.ensure_future(self._call(handler, request))
        watch = asyncio.ensure_future(self._client_gone(reader))
        try:
            await asyncio.wait({task, watch},
                               return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            task.cancel()
            raise
        finally:
            watch.cancel()
        if not task.done():
            # The client closed the connection: cancel the handler (it
            # aborts its engine request) and drop the connection.
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            return False
        resp = task.result()
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                raise RuntimeError("handler returned an unprepared stream")
            await resp.write_eof()
            return request.keep_alive
        if request.response_started:
            # A stream failed after its head went out: no status can be
            # sent any more, so the connection ends the response.
            return False
        await self._send(writer, resp, request.keep_alive)
        return request.keep_alive

    @staticmethod
    async def _call(handler: Handler, request: Request):
        try:
            return await handler(request)
        except HTTPError as e:
            return Response(e.text, e.status, e.content_type)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 — a handler's fault is a 500
            logger.error("error handling %s %s:\n%s", request.method,
                         request.path, traceback.format_exc())
            return Response("500 Internal Server Error\n\n"
                            "Server got itself in trouble", 500)

    @staticmethod
    async def _client_gone(reader: asyncio.StreamReader) -> None:
        """Returns once the client has closed its side of the connection
        (nothing is read: a request body was read whole before)."""
        while not reader.at_eof():
            await asyncio.sleep(DISCONNECT_POLL_S)

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, resp: Response,
                    keep_alive: bool) -> None:
        headers = {"Content-Type": resp.content_type, **resp.headers,
                   "Content-Length": str(len(resp.body)),
                   "Connection": "keep-alive" if keep_alive else "close"}
        writer.write(_head_bytes(resp.status, headers) + resp.body)
        await writer.drain()


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------

class ClientResponse:
    """A response whose head has been read; read its body once, whole or
    as it arrives.  Closing it closes the connection."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, status: int,
                 headers: dict[str, str], deadline: Optional[float]):
        self._reader = reader
        self._writer = writer
        self.status = status
        self.headers = headers
        self._deadline = deadline

    async def _timed(self, aw):
        if self._deadline is None:
            return await aw
        left = self._deadline - asyncio.get_running_loop().time()
        return await asyncio.wait_for(aw, max(left, 0.0))

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        """The body's bytes as they arrive (chunked coding removed)."""
        r = self._reader
        if self.headers.get("transfer-encoding", "").lower() == "chunked":
            pieces = _read_chunked(r, 1 << 40).__aiter__()
            while True:
                try:
                    yield await self._timed(pieces.__anext__())
                except StopAsyncIteration:
                    return
        elif "content-length" in self.headers:
            left = int(self.headers["content-length"])
            while left:
                data = await self._timed(r.read(min(left, 1 << 16)))
                if not data:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(data)
                yield data
        else:
            while True:
                data = await self._timed(r.read(1 << 16))
                if not data:
                    return
                yield data

    async def iter_lines(self) -> AsyncIterator[bytes]:
        """The body split after each ``\\n`` (the newline kept), as
        ``aiohttp``'s ``async for line in response.content``."""
        buf = b""
        async for data in self.iter_chunks():
            buf += data
            while True:
                i = buf.find(b"\n")
                if i < 0:
                    break
                yield buf[:i + 1]
                buf = buf[i + 1:]
        if buf:
            yield buf

    async def read(self) -> bytes:
        return b"".join([d async for d in self.iter_chunks()])

    async def json(self) -> Any:
        return _json.loads(await self.read())

    def close(self) -> None:
        self._writer.close()


class _RequestContext:
    """``async with request(...) as resp``: the response, closed at the
    end of the block."""

    def __init__(self, coro):
        self._coro = coro
        self._resp: Optional[ClientResponse] = None

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.close()


async def _request(method: str, url: str, body: Optional[bytes],
                   headers: dict, timeout: Optional[float]
                   ) -> ClientResponse:
    parts = urlsplit(url)
    if parts.scheme != "http":
        raise ValueError(f"only http:// URLs are supported, not {url!r}")
    host, port = parts.hostname, parts.port or 80
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout

    async def connect_and_head():
        reader, writer = await asyncio.open_connection(
            host, port, limit=MAX_HEAD_BYTES)
        try:
            hdrs = {"Host": f"{host}:{port}", "Accept": "*/*", **headers,
                    "Content-Length": str(len(body or b"")),
                    "Connection": "close"}
            lines = [f"{method} {path} HTTP/1.1"]
            lines += [f"{k}: {v}" for k, v in hdrs.items()]
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                         + (body or b""))
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            line, resp_headers = _parse_head(head[:-4])
            parts = line.split(" ", 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise ValueError(f"malformed status line {line!r}")
            status = int(parts[1])
        except BaseException:
            writer.close()
            raise
        return ClientResponse(reader, writer, status, resp_headers,
                              deadline)

    if timeout is None:
        return await connect_and_head()
    return await asyncio.wait_for(connect_and_head(), timeout)


def request(method: str, url: str, *, json: Any = None,
            data: Optional[bytes] = None, headers: Optional[dict] = None,
            timeout: Optional[float] = None) -> _RequestContext:
    """Send one request; ``json`` is encoded as the body (else ``data``).
    ``timeout`` bounds the whole exchange, body reads included."""
    hdrs = dict(headers or {})
    if json is not None:
        data = _json.dumps(json).encode()
        hdrs.setdefault("Content-Type", "application/json")
    return _RequestContext(_request(method.upper(), url, data, hdrs,
                                    timeout))


def get(url: str, **kw) -> _RequestContext:
    return request("GET", url, **kw)


def post(url: str, **kw) -> _RequestContext:
    return request("POST", url, **kw)
