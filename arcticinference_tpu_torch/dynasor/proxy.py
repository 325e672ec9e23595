"""Dynasor proxy: an OpenAI-compatible streaming proxy with CoT early exit.

Counterpart of ``arcticinference_tpu/dynasor/proxy.py`` on the port's
standard-library HTTP layer (``serving/http.py``).  It streams a chat
completion from the backend while periodically probing it ("... **Final
Answer** \\boxed{" appended to the partial chain of thought); when the
last N probe answers agree (the certainty window), it stops the stream,
emits the converged answer and drops the backend request, which the
backend aborts when the connection closes.  /v1/completions passes
through unchanged.

Backend-agnostic: any /v1/completions-speaking server.

    python -m arcticinference_tpu_torch dynasor --backend http://...:8000 \\
        --port 8001 [--probe-interval 64] [--certainty-window 2]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
import uuid
from typing import Optional

from arcticinference_tpu_torch.dynasor.entropy import should_early_exit
from arcticinference_tpu_torch.dynasor.evaluator import extract_answer
from arcticinference_tpu_torch.serving import http
from arcticinference_tpu_torch.serving.http import (App, Request, Response,
                                                    StreamResponse,
                                                    json_response)

PROBE_SUFFIX = "... Oh, I suddenly got the answer to the whole problem, " \
               "**Final Answer**: \\boxed{"


class DynasorProxy:

    def __init__(self, backend: str, probe_interval: int = 64,
                 certainty_window: int = 2, probe_max_tokens: int = 20):
        self.backend = backend.rstrip("/")
        self.probe_interval = probe_interval
        self.certainty_window = certainty_window
        self.probe_max_tokens = probe_max_tokens
        self.app = App()
        self.app.add_route("POST", "/v1/chat/completions", self.chat)
        self.app.add_route("POST", "/v1/completions", self.completions)
        self.app.add_route("GET", "/health", self.health)

    async def health(self, request: Request):
        try:
            async with http.get(f"{self.backend}/health", timeout=5) as r:
                ok = r.status == 200
                await r.read()
        except (OSError, EOFError, ValueError):  # refused, reset, timed out
            ok = False
        return json_response({"status": "ok" if ok else "backend_down"})

    async def completions(self, request: Request):
        """Plain passthrough for non-chat completions."""
        body = await request.json()
        async with http.post(f"{self.backend}/v1/completions",
                             json=body) as r:
            if body.get("stream"):
                resp = StreamResponse(
                    headers={"Content-Type": "text/event-stream"})
                await resp.prepare(request)
                async for chunk in r.iter_chunks():
                    await resp.write(chunk)
                await resp.write_eof()
                return resp
            return Response(await r.read(), r.status, "application/json")

    # ------------------------------------------------------------------ #
    # Chat with probing
    # ------------------------------------------------------------------ #

    async def _probe(self, prompt_text: str) -> tuple[str, Optional[str]]:
        """Ask the backend to finish the CoT with the probe suffix."""
        body = {
            "prompt": prompt_text + PROBE_SUFFIX,
            "max_tokens": self.probe_max_tokens,
            "temperature": 0.0,
        }
        try:
            async with http.post(f"{self.backend}/v1/completions",
                                 json=body, timeout=120) as r:
                data = await r.json()
            text = data["choices"][0].get("text", "")
        except (OSError, EOFError, ValueError, KeyError, IndexError,
                TypeError):  # a failed probe counts as no answer
            return "", None
        return text, extract_answer("\\boxed{" + text)

    async def chat(self, request: Request):
        body = await request.json()
        messages = body.get("messages") or []
        stream = bool(body.get("stream"))
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"

        prompt_text = "\n".join(
            f"{m.get('role')}: {m.get('content')}" for m in messages
        ) + "\nassistant:"

        backend_body = {
            "prompt": prompt_text,
            "max_tokens": body.get("max_tokens", 2048),
            "temperature": body.get("temperature", 0.0),
            "stream": True,
        }

        resp = None
        if stream:
            resp = StreamResponse(headers={
                "Content-Type": "text/event-stream"})
            await resp.prepare(request)

        generated = ""
        probe_answers: list[Optional[str]] = []
        probe_texts: list[str] = []
        probe_task: Optional[asyncio.Task] = None
        exited_early = False
        tokens_seen = 0
        next_probe_at = self.probe_interval

        async def emit(delta: str, finish: Optional[str] = None):
            if resp is None:
                return
            payload = {
                "id": rid, "object": "chat.completion.chunk",
                "created": int(time.time()),
                "choices": [{"index": 0,
                             "delta": {"content": delta},
                             "finish_reason": finish}],
            }
            await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

        # A client disconnect cancels this handler mid-stream; the probe
        # in flight must not leak, and leaving the ``async with`` closes
        # the backend's connection (it aborts the request).
        try:
            async with http.post(f"{self.backend}/v1/completions",
                                 json=backend_body) as r:
                async for raw in r.iter_lines():
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[6:]
                    if data == "[DONE]":
                        break
                    chunk = json.loads(data)
                    text = chunk["choices"][0].get("text", "")
                    ntoks = len(
                        chunk["choices"][0].get("token_ids", [])) or 1
                    generated += text
                    tokens_seen += ntoks
                    await emit(text)

                    if probe_task is not None and probe_task.done():
                        ptext, ans = probe_task.result()
                        probe_texts.append(ptext)
                        probe_answers.append(ans)
                        probe_task = None
                        if should_early_exit(probe_answers, probe_texts,
                                             self.certainty_window):
                            exited_early = True
                            break
                    if tokens_seen >= next_probe_at and probe_task is None:
                        next_probe_at = tokens_seen + self.probe_interval
                        probe_task = asyncio.ensure_future(
                            self._probe(prompt_text + generated))
        finally:
            if probe_task is not None:
                probe_task.cancel()

        final_answer = probe_answers[-1] if exited_early else None
        if exited_early and final_answer:
            suffix = (f"\n\n**Final Answer** (early exit): "
                      f"\\boxed{{{final_answer}}}")
            generated += suffix
            await emit(suffix, finish="stop")
        else:
            await emit("", finish="stop")

        if resp is not None:
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        return json_response({
            "id": rid, "object": "chat.completion",
            "created": int(time.time()),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": generated},
                "finish_reason": "stop",
            }],
            "dynasor": {"early_exit": exited_early,
                        "probes": len(probe_answers)},
        })


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", required=True,
                        help="base URL of the OpenAI-compatible backend")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8001)
    parser.add_argument("--probe-interval", type=int, default=64)
    parser.add_argument("--certainty-window", type=int, default=2)
    args = parser.parse_args(argv)
    proxy = DynasorProxy(args.backend, args.probe_interval,
                         args.certainty_window)
    proxy.app.run(args.host, args.port)


if __name__ == "__main__":
    main()
