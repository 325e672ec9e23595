"""Blocking and async clients of the embedding service.

Counterpart of ``arcticinference_tpu/embedding/client.py``: ``embed``,
``generate``, ``abort``, ``info``, ``health`` and ``close`` against a
replica or a manager (``host:port``), on the port's transport
(``transport.py``, over ``serving/http.py``'s client).  Failed calls
raise :class:`~arcticinference_tpu_torch.embedding.transport.RpcError`
with the service's status code.
"""

from __future__ import annotations

import uuid
from typing import Optional, Sequence

import numpy as np

from arcticinference_tpu_torch.embedding import wire
from arcticinference_tpu_torch.embedding.transport import (
    AsyncInferenceStub, InferenceStub)


def _encode_request(prompts, token_ids, pooling, request_id):
    req = wire.EncodeRequest(
        request_id=request_id or f"emb-{uuid.uuid4().hex[:12]}",
        pooling=pooling)
    if token_ids is not None:
        req.token_ids = [wire.TokenIds(
            token_id_bytes_i32=np.asarray(ids, "<i4").tobytes())
            for ids in token_ids]
    elif prompts is not None:
        req.prompts = list(prompts)
    else:
        raise ValueError("prompts or token_ids required")
    return req


def _parse_embeddings(resp) -> list[np.ndarray]:
    return [np.frombuffer(b, dtype="<f4") for b in resp.embeddings]


def _generate_request(prompt, token_ids, max_tokens, temperature, top_p,
                      top_k, ignore_eos, stop, seed, request_id):
    kw = dict(request_id=request_id or "", max_tokens=int(max_tokens),
              temperature=float(temperature), top_p=float(top_p),
              top_k=int(top_k), ignore_eos=bool(ignore_eos),
              stop=list(stop), seed=int(seed) if seed is not None else -1)
    if token_ids is not None:
        kw["token_id_bytes_i32"] = np.asarray(token_ids, "<i4").tobytes()
    elif prompt is not None:
        kw["prompt"] = prompt
    else:
        raise ValueError("prompt or token_ids required")
    return wire.GenerateRequest(**kw)


def _parse_generate(resp) -> dict:
    return {"request_id": resp.request_id,
            "token_ids": list(resp.token_ids),
            "text_delta": resp.text_delta,
            "finished": resp.finished,
            "finish_reason": resp.finish_reason}


class InferenceClient:
    """Blocking client."""

    def __init__(self, target: str):
        self.stub = InferenceStub(target)

    def embed(self, prompts: Optional[Sequence[str]] = None,
              token_ids: Optional[Sequence[Sequence[int]]] = None,
              pooling: str = "mean", request_id: Optional[str] = None,
              timeout: float = 300.0) -> list[np.ndarray]:
        req = _encode_request(prompts, token_ids, pooling, request_id)
        return _parse_embeddings(self.stub.Encode(req, timeout=timeout))

    def generate(self, prompt=None, token_ids=None, max_tokens=128,
                 temperature=0.0, top_p=1.0, top_k=0, ignore_eos=False,
                 stop=(), seed=None, request_id=None,
                 timeout: float = 600.0):
        """Stream completions from a decoder replica; yields dicts
        {request_id, token_ids, text_delta, finished, finish_reason}."""
        req = _generate_request(prompt, token_ids, max_tokens, temperature,
                                top_p, top_k, ignore_eos, stop, seed,
                                request_id)
        for resp in self.stub.Generate(req, timeout=timeout):
            yield _parse_generate(resp)

    def abort(self, request_id: str) -> bool:
        return self.stub.Abort(wire.AbortRequest(request_id=request_id),
                               timeout=10).aborted

    def info(self) -> wire.ReplicaInfoResponse:
        return self.stub.GetReplicaInfo(wire.ReplicaInfoRequest(),
                                        timeout=10)

    def health(self) -> bool:
        try:
            return self.stub.HealthCheck(wire.HealthCheckRequest(),
                                         timeout=5).healthy
        except Exception:  # noqa: BLE001 — unreachable is unhealthy
            return False

    def close(self) -> None:
        """Nothing to release: each call opens and closes its own
        connection."""


class AsyncInferenceClient:

    def __init__(self, target: str):
        self.stub = AsyncInferenceStub(target)

    async def embed(self, prompts=None, token_ids=None,
                    pooling: str = "mean", request_id=None,
                    timeout: float = 300.0) -> list[np.ndarray]:
        req = _encode_request(prompts, token_ids, pooling, request_id)
        return _parse_embeddings(await self.stub.Encode(req,
                                                        timeout=timeout))

    async def generate(self, prompt=None, token_ids=None, max_tokens=128,
                       temperature=0.0, top_p=1.0, top_k=0,
                       ignore_eos=False, stop=(), seed=None,
                       request_id=None, timeout: float = 600.0):
        req = _generate_request(prompt, token_ids, max_tokens, temperature,
                                top_p, top_k, ignore_eos, stop, seed,
                                request_id)
        async for resp in self.stub.Generate(req, timeout=timeout):
            yield _parse_generate(resp)

    async def abort(self, request_id: str) -> bool:
        resp = await self.stub.Abort(
            wire.AbortRequest(request_id=request_id), timeout=10)
        return resp.aborted

    async def info(self) -> wire.ReplicaInfoResponse:
        return await self.stub.GetReplicaInfo(wire.ReplicaInfoRequest(),
                                              timeout=10)

    async def health(self) -> bool:
        try:
            resp = await self.stub.HealthCheck(wire.HealthCheckRequest(),
                                               timeout=5)
            return resp.healthy
        except Exception:  # noqa: BLE001
            return False

    async def close(self) -> None:
        """Nothing to release (one connection per call)."""
