"""Embedding replica: the inference service around one ``LLM``.

Counterpart of ``arcticinference_tpu/embedding/replica.py``, served on
the port's transport (``transport.py``: the same messages, methods and
status codes as the JAX replica's gRPC service, over HTTP/1.1).  Prompts
are tokenized on the replica; embeddings go back as raw little-endian
float32 bytes, one blob per prompt.  ``Generate`` streams a decoder's new
tokens as deltas.  Several replica processes per card are spawned and
balanced by ``replica_manager.py``.

Run (on ``cuda:0``; ``--device cpu`` on the CPU):

    python -m arcticinference_tpu_torch.embedding.replica --port 50051 \\
        --model <path-or-arch> [--config cfg.json] [--device cuda:0]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import uuid
from pathlib import Path
from typing import Union

import numpy as np
import torch

from arcticinference_tpu_torch.config import EngineConfig
from arcticinference_tpu_torch.embedding import wire
from arcticinference_tpu_torch.embedding.transport import (Server,
                                                           StatusCode)


class InferenceServicer:

    def __init__(self, llm, model_name: str):
        self.llm = llm
        self.model_name = model_name
        self._lock = threading.Lock()   # serialises engine access
        # Counters and the abort set: never held across engine work, so
        # Abort cannot wait behind a running encode or step.
        self._meta = threading.Lock()
        self.active = 0
        self.total_requests = 0
        self.total_tokens = 0
        self._aborted: set[str] = set()

    def Encode(self, request, context):  # noqa: N802 — the RPC's name
        if request.token_ids:
            ids = [np.frombuffer(t.token_id_bytes_i32, dtype="<i4").tolist()
                   for t in request.token_ids]
        elif request.prompts:
            if self.llm.tokenizer is None:
                context.abort(StatusCode.INTERNAL,
                              "replica has no tokenizer; send token_ids")
            ids = [self.llm.tokenizer.encode(p) for p in request.prompts]
        else:
            context.abort(StatusCode.INVALID_ARGUMENT,
                          "prompts or token_ids required")
        pooling = request.pooling or "mean"
        with self._meta:
            if request.request_id in self._aborted:
                self._aborted.discard(request.request_id)
                context.abort(StatusCode.CANCELLED, "aborted")
            self.active += 1
        try:
            with self._lock:
                embs = self.llm.encode(prompt_token_ids=ids,
                                       pooling=pooling)
        finally:
            with self._meta:
                self.active -= 1
                self.total_requests += 1
                self.total_tokens += sum(len(i) for i in ids)
        return wire.EncodeResponse(
            request_id=request.request_id,
            embeddings=[np.asarray(e, "<f4").tobytes() for e in embs],
            dim=int(embs[0].shape[-1]) if embs else 0)

    def Generate(self, request, context):  # noqa: N802
        """Streaming generation: the engine steps under the replica lock
        and each step's newly committed tokens stream back as a delta
        (tokens the pipelined step has not read back yet,
        ``PENDING_TOKEN``, wait for a later step)."""
        from arcticinference_tpu_torch.engine.engine import PENDING_TOKEN
        from arcticinference_tpu_torch.engine.request import SamplingParams

        eng = self.llm.engine
        if eng is None:
            context.abort(StatusCode.INTERNAL,
                          "encoder-only model: use Encode")
        if request.token_id_bytes_i32:
            ids = np.frombuffer(request.token_id_bytes_i32,
                                dtype="<i4").tolist()
        elif request.prompt:
            if self.llm.tokenizer is None:
                context.abort(StatusCode.INTERNAL,
                              "no tokenizer; send token_id_bytes_i32")
            ids = self.llm.tokenizer.encode(request.prompt)
        else:
            context.abort(StatusCode.INVALID_ARGUMENT,
                          "prompt or token ids required")
        sp = SamplingParams(
            max_tokens=request.max_tokens or 128,
            temperature=request.temperature,
            top_p=request.top_p or 1.0,
            top_k=request.top_k,
            ignore_eos=request.ignore_eos,
            stop=tuple(request.stop),
            seed=int(request.seed) if request.seed >= 0 else None)
        rid = request.request_id or f"gen-{uuid.uuid4().hex[:12]}"
        tok = self.llm.tokenizer
        with self._meta:
            self.active += 1
        try:
            with self._lock:
                req = eng.add_request(rid, ids, sp)
            sent = 0
            sent_text = ""
            while not req.status.is_finished:
                with self._meta:
                    aborted = rid in self._aborted
                    self._aborted.discard(rid)
                if aborted:
                    with self._lock:
                        eng.abort_request(rid)
                    yield wire.GenerateResponse(
                        request_id=rid, finished=True,
                        finish_reason="aborted")
                    return
                with self._lock:
                    eng.step()
                out = req.output_token_ids
                try:
                    known = out.index(PENDING_TOKEN)
                except ValueError:
                    known = len(out)
                new = out[sent:known]
                if new and not req.status.is_finished:
                    delta = ""
                    if tok is not None:
                        full = tok.decode(out[:known])
                        delta = full[len(sent_text):]
                        sent_text = full
                    yield wire.GenerateResponse(
                        request_id=rid, token_ids=[int(t) for t in new],
                        text_delta=delta)
                    sent = known
            delta = ""
            if tok is not None:
                full = (req.final_text if req.final_text is not None
                        else tok.decode(req.output_token_ids))
                delta = full[len(sent_text):]
            yield wire.GenerateResponse(
                request_id=rid,
                token_ids=[int(t) for t in req.output_token_ids[sent:]],
                text_delta=delta, finished=True,
                finish_reason=req.status.name.lower())
        finally:
            with self._meta:
                self.active -= 1
                self.total_requests += 1
                self.total_tokens += len(ids)

    def Abort(self, request, context):  # noqa: N802
        with self._meta:
            self._aborted.add(request.request_id)
        return wire.AbortResponse(aborted=True)

    def GetReplicaInfo(self, request, context):  # noqa: N802
        with self._meta:
            return wire.ReplicaInfoResponse(
                model=self.model_name, active_requests=self.active,
                total_requests=self.total_requests,
                total_tokens=self.total_tokens)

    def HealthCheck(self, request, context):  # noqa: N802
        return wire.HealthCheckResponse(healthy=True)


def serve(config: EngineConfig, port: int, max_workers: int = 8,
          device: Union[str, torch.device, None] = None,
          host: str = "0.0.0.0") -> tuple[Server, int]:
    """An ``LLM`` of ``config`` on ``device`` (``cuda:0`` by default)
    behind a started :class:`~transport.Server`; returns it and the
    bound port (``port=0`` picks a free one)."""
    from arcticinference_tpu_torch.engine.llm import LLM

    llm = LLM(config, device=device)
    server = Server(max_workers=max_workers)
    server.add_servicer(InferenceServicer(llm, config.model.model))
    return server, server.start(host, port)


def exit_on_sigterm() -> None:
    """SIGTERM raises ``SystemExit`` in the main thread, so the caller's
    ``finally`` blocks (stopping its server, its replicas) run."""
    def _exit(*_):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _exit)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Embedding replica of the PyTorch port")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--model", default=None)
    parser.add_argument("--config", default=None,
                        help="EngineConfig JSON file")
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:0 (default) or cpu")
    parser.add_argument("--host", default="0.0.0.0")
    args = parser.parse_args(argv)
    if args.config:
        cfg = EngineConfig.from_dict(json.loads(Path(args.config)
                                                .read_text()))
    else:
        cfg = EngineConfig()
    if args.model:
        cfg.model.model = args.model
        cfg.model.tokenizer = args.model
    exit_on_sigterm()
    server, port = serve(cfg, args.port, device=args.device, host=args.host)
    try:
        print(f"replica ready on :{port} (pid {os.getpid()})", flush=True)
        server.wait_for_termination()
    finally:
        server.stop()


if __name__ == "__main__":
    main()
