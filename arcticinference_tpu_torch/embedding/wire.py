"""The protobuf wire format of ``proto/inference.proto``, by hand.

The card's machine has no ``protobuf`` (nor ``grpc``), so the port writes
and reads the eleven messages of the embedding service itself, byte for
byte as protobuf's ``SerializeToString`` does for proto3 messages:

- fields in field-number order, a field at its default (0, 0.0, false,
  empty string or bytes, no items) left out;
- ``int32`` / ``int64`` / ``bool`` as varints, a negative integer as the
  10-byte varint of its 64-bit two's complement (``int64 seed = -1``);
- ``string``, ``bytes`` and sub-messages length-delimited;
- ``float`` as little-endian ``fixed32``;
- ``repeated int32`` packed into one length-delimited field.

The parser takes any field order, takes a ``repeated int32`` packed or
one item at a time, and keeps the last value of a repeated scalar field,
as protobuf does; it keeps unknown fields' bytes and writes them back
after the known ones, as protobuf does.  Embeddings stay raw
little-endian float32 bytes and token ids packed little-endian int32
bytes (``TokenIds``, ``GenerateRequest.token_id_bytes_i32``), as in the
JAX package.

Each message class takes its fields as keyword arguments, has them as
attributes and offers protobuf's ``SerializeToString`` and
``FromString``, so servicer code reads like the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Any, ClassVar

# Wire types.
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


def _varint(n: int) -> bytes:
    n &= _MASK64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _signed(n: int, bits: int) -> int:
    """The two's-complement value of the low ``bits`` bits of ``n``."""
    n &= (1 << bits) - 1
    return n - (1 << bits) if n >> (bits - 1) else n


def _tag(number: int, wire_type: int) -> bytes:
    return _varint(number << 3 | wire_type)


_SCALAR_DEFAULTS = {"string": "", "bytes": b"", "int32": 0, "int64": 0,
                    "bool": False, "float": 0.0}


class Message:
    """Base of the messages: ``FIELDS`` is a tuple of (number, name,
    kind, repeated), kind a scalar type name or a message class."""

    FIELDS: ClassVar[tuple] = ()

    def __init__(self, **kw: Any):
        for number, name, kind, repeated in self.FIELDS:
            if name in kw:
                val = kw.pop(name)
                setattr(self, name, list(val) if repeated else val)
            else:
                setattr(self, name, [] if repeated else (
                    _SCALAR_DEFAULTS[kind] if isinstance(kind, str)
                    else None))
        if kw:
            raise TypeError(f"{type(self).__name__} has no fields "
                            f"{sorted(kw)}")
        self._unknown = b""

    def __repr__(self) -> str:
        body = ", ".join(f"{f[1]}={getattr(self, f[1])!r}"
                         for f in self.FIELDS)
        return f"{type(self).__name__}({body})"

    # -- writing ---------------------------------------------------------

    def SerializeToString(self) -> bytes:  # noqa: N802 — protobuf's name
        out = bytearray()
        for number, name, kind, repeated in self.FIELDS:
            val = getattr(self, name)
            if repeated:
                if not val:
                    continue
                if kind == "int32":
                    packed = b"".join(_varint(int(v)) for v in val)
                    out += _tag(number, _LEN) + _varint(len(packed)) + packed
                else:
                    for v in val:
                        out += _field(number, kind, v, always=True)
            else:
                out += _field(number, kind, val, always=False)
        return bytes(out) + self._unknown

    # -- reading ---------------------------------------------------------

    @classmethod
    def FromString(cls, buf: bytes) -> "Message":  # noqa: N802
        by_number = {f[0]: f for f in cls.FIELDS}
        msg = cls()
        buf = bytes(buf)
        pos = 0
        while pos < len(buf):
            start = pos
            key, pos = _read_varint(buf, pos)
            number, wt = key >> 3, key & 7
            if wt == _VARINT:
                raw, pos = _read_varint(buf, pos)
            elif wt == _I64:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wt == _I32:
                raw, pos = buf[pos:pos + 4], pos + 4
            elif wt == _LEN:
                n, pos = _read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if pos > len(buf):
                raise ValueError(f"truncated {cls.__name__}")
            field = by_number.get(number)
            if field is None:
                msg._unknown += buf[start:pos]
                continue
            _, name, kind, repeated = field
            if repeated and kind == "int32" and wt == _LEN:
                items, p = [], 0
                while p < len(raw):
                    v, p = _read_varint(raw, p)
                    items.append(_signed(v, 32))
                getattr(msg, name).extend(items)
                continue
            val = _decode(kind, wt, raw, cls.__name__, name)
            if repeated:
                getattr(msg, name).append(val)
            else:
                setattr(msg, name, val)
        return msg


def _field(number: int, kind, val, always: bool) -> bytes:
    """One field's bytes; empty when it holds its default (and is not
    an item of a repeated field)."""
    if isinstance(kind, type):
        if val is None:
            return b""
        body = val.SerializeToString()
        return _tag(number, _LEN) + _varint(len(body)) + body
    if kind in ("string", "bytes"):
        data = val.encode() if kind == "string" else bytes(val)
        if not data and not always:
            return b""
        return _tag(number, _LEN) + _varint(len(data)) + data
    if kind == "float":
        data = struct.pack("<f", val)
        if data == b"\0\0\0\0" and not always:   # +0.0; -0.0 is written
            return b""
        return _tag(number, _I32) + data
    n = int(val)
    if n == 0 and not always:
        return b""
    return _tag(number, _VARINT) + _varint(n)


def _decode(kind, wt: int, raw, msg_name: str, name: str):
    want = (_LEN if isinstance(kind, type) or kind in ("string", "bytes")
            else _I32 if kind == "float" else _VARINT)
    if wt != want:
        raise ValueError(f"{msg_name}.{name}: wire type {wt}, expected "
                         f"{want}")
    if isinstance(kind, type):
        return kind.FromString(raw)
    if kind == "string":
        return raw.decode()
    if kind == "bytes":
        return bytes(raw)
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "bool":
        return raw != 0
    return _signed(raw, 32 if kind == "int32" else 64)


# -- the messages of proto/inference.proto ---------------------------------

class TokenIds(Message):
    FIELDS = ((1, "token_id_bytes_i32", "bytes", False),)


class EncodeRequest(Message):
    FIELDS = ((1, "request_id", "string", False),
              (2, "prompts", "string", True),
              (3, "token_ids", TokenIds, True),
              (4, "pooling", "string", False))


class EncodeResponse(Message):
    FIELDS = ((1, "request_id", "string", False),
              (2, "embeddings", "bytes", True),
              (3, "dim", "int32", False))


class AbortRequest(Message):
    FIELDS = ((1, "request_id", "string", False),)


class AbortResponse(Message):
    FIELDS = ((1, "aborted", "bool", False),)


class ReplicaInfoRequest(Message):
    FIELDS = ()


class ReplicaInfoResponse(Message):
    FIELDS = ((1, "model", "string", False),
              (2, "active_requests", "int32", False),
              (3, "total_requests", "int64", False),
              (4, "total_tokens", "int64", False))


class HealthCheckRequest(Message):
    FIELDS = ()


class HealthCheckResponse(Message):
    FIELDS = ((1, "healthy", "bool", False),)


class GenerateRequest(Message):
    FIELDS = ((1, "request_id", "string", False),
              (2, "prompt", "string", False),
              (3, "token_id_bytes_i32", "bytes", False),
              (4, "max_tokens", "int32", False),
              (5, "temperature", "float", False),
              (6, "top_p", "float", False),
              (7, "top_k", "int32", False),
              (8, "ignore_eos", "bool", False),
              (9, "stop", "string", True),
              (10, "seed", "int64", False))


class GenerateResponse(Message):
    FIELDS = ((1, "request_id", "string", False),
              (2, "token_ids", "int32", True),
              (3, "text_delta", "string", False),
              (4, "finished", "bool", False),
              (5, "finish_reason", "string", False))


MESSAGES = (TokenIds, EncodeRequest, EncodeResponse, AbortRequest,
            AbortResponse, ReplicaInfoRequest, ReplicaInfoResponse,
            HealthCheckRequest, HealthCheckResponse, GenerateRequest,
            GenerateResponse)
