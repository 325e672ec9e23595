"""OpenAI-compatible HTTP server of the port.

Counterpart of ``arcticinference_tpu/serving/openai_server.py``, with the
same routes, bodies and semantics, served by the port's standard-library
HTTP layer (``serving/http.py``) in place of ``aiohttp``:
/v1/completions and /v1/chat/completions (SSE streaming with
``"stream": true``; ``n > 1`` fan-out; ``echo`` with ``max_tokens: 0``
scores the prompt), /v1/embeddings, /v1/models, /health, /metrics
(JSON engine stats), /start_profile and /stop_profile (a
``torch.profiler`` Chrome trace).  Guided decoding rides
``response_format`` (``json_object`` / ``json_schema``) and the
``guided_regex`` / ``guided_choice`` / ``guided_json`` fields.

An encoder deployment (BERT: ``module.IS_ENCODER``) builds the dense
``EncoderRunner`` and no ``AsyncLLMEngine``: it answers /v1/embeddings
(one device batch at a time, off the event loop), and the generate and
profile routes answer 400 as the JAX server's do; a causal deployment
answers /v1/embeddings with 400.

Run (on ``cuda:0``; ``--device cpu`` on the CPU):

    python -m arcticinference_tpu_torch serve --config config.json \\
        --port 8000 [--model DIR]

A mesh (``--tensor-parallel-size``, ``--ulysses-sequence-parallel-size``,
``--enable-shift-parallel``, or the config's ``parallel`` section, which
also takes ``data_parallel_size`` and ``pipeline_parallel_size``) is
served by one process per rank, each
started with the same command and ``--multihost-num-processes N
--multihost-process-id I --multihost-coordinator HOST:PORT`` (the
process group's rendezvous at process 0) and, for the step channel,
``--multihost-leader HOST --multihost-channel-port P`` (default 8550).
Process 0 serves HTTP: it builds the server, waits for its followers,
attaches the channel to the runner and starts the watchdog.  Every other
process builds an ``LLMEngine`` and replays the leader's steps
(``parallel/multihost.py``); it exits 3 when it loses the leader.  On a
served mesh ``echo`` scoring answers 400 (no follower mirrors it).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import sys
import tempfile
import time
import uuid
from pathlib import Path
from typing import Any, Optional, Union

import torch

from arcticinference_tpu_torch.config import (EngineConfig, ParallelConfig,
                                              SpeculativeConfig)
from arcticinference_tpu_torch.engine.async_engine import AsyncLLMEngine
from arcticinference_tpu_torch.engine.llm import (_is_encoder_arch,
                                                  load_tokenizer)
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.serving.http import (App, HTTPError, Request,
                                                    StreamResponse,
                                                    json_response)

_ENCODER_ONLY = {"error": "encoder-only model: use /v1/embeddings"}


class OpenAIServer:

    def __init__(self, config: EngineConfig,
                 served_model_name: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 group=None):
        """A mesh config makes this the leader rank of a served mesh over
        ``group`` (default: the default process group): its steps run
        on the followers too once a channel is attached
        (``AsyncLLMEngine.attach_channel``)."""
        self.config = config
        self.encoder = None
        self.engine = None
        if _is_encoder_arch(config):
            from arcticinference_tpu_torch.engine.encoder import (
                EncoderRunner)

            self.encoder = EncoderRunner(config, device=device)
            self._encode_lock = None  # made on the event loop
        else:
            self.engine = AsyncLLMEngine(config, device=device, group=group)
        self.model_name = served_model_name or config.model.model
        self.tokenizer = load_tokenizer(config)
        if self.engine is not None and self.tokenizer is not None:
            # String stop sequences are detected inside the engine loop.
            self.engine.engine.tokenizer = self.tokenizer
        self.app = App()
        for method, path, handler in (
                ("POST", "/v1/completions", self.completions),
                ("POST", "/v1/chat/completions", self.chat_completions),
                ("POST", "/v1/embeddings", self.embeddings),
                ("GET", "/v1/models", self.models),
                ("GET", "/health", self.health),
                ("GET", "/metrics", self.metrics),
                ("POST", "/start_profile", self.start_profile),
                ("POST", "/stop_profile", self.stop_profile)):
            self.app.add_route(method, path, handler)
        self.app.on_cleanup.append(self._cleanup)

    async def _cleanup(self, app) -> None:
        if self.engine is not None:
            self.engine.close()

    # -- helpers ---------------------------------------------------------

    def _sampling_from(self, body: dict[str, Any]) -> SamplingParams:
        guided = None
        fmt = body.get("response_format") or {}
        spec = None
        if fmt.get("type") == "json_object":
            spec = {"json": True}
        elif fmt.get("type") == "json_schema":
            schema = (fmt.get("json_schema") or {}).get("schema")
            spec = {"json": schema if isinstance(schema, dict) else True}
        elif body.get("guided_regex"):
            spec = {"regex": body["guided_regex"]}
        elif body.get("guided_choice"):
            spec = {"choice": body["guided_choice"]}
        elif body.get("guided_json"):
            spec = {"json": body["guided_json"]}
        if spec is not None:
            if self.tokenizer is None:
                raise HTTPError(400, "guided decoding requires a tokenizer")
            from arcticinference_tpu_torch.serving.structured import (
                make_guided_decoder)

            # The model's logits width (may exceed len(tokenizer)).
            guided = make_guided_decoder(
                self.tokenizer, spec,
                vocab_size=self.engine.engine.runner.arch.vocab_size)
        logprobs = body.get("logprobs")
        stop = body.get("stop") or ()
        if isinstance(stop, str):
            stop = (stop,)
        seed = body.get("seed")
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 128)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            min_p=float(body.get("min_p", 0.0)),
            seed=int(seed) if seed is not None else None,
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            ignore_eos=bool(body.get("ignore_eos", False)),
            stop_token_ids=tuple(body.get("stop_token_ids", ())),
            stop=tuple(str(s) for s in stop),
            n=int(body.get("n", 1)),
            guided=guided,
            logprobs=int(logprobs) if logprobs else None,
        )

    @staticmethod
    def _trim_stops(text: str, stops) -> tuple[str, bool]:
        """Cut the completion text just before the first stop sequence
        (OpenAI excludes the stop text from the response)."""
        cut = min((i for i in (text.find(s) for s in stops) if i != -1),
                  default=-1)
        return (text[:cut], True) if cut >= 0 else (text, False)

    def _encode(self, text: str) -> list[int]:
        if self.tokenizer is None:
            raise HTTPError(
                400, json.dumps({"error": "no tokenizer loaded; send "
                                          "prompt_token_ids"}),
                content_type="application/json")
        return self.tokenizer.encode(text)

    def _decode(self, ids: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    # -- endpoints -------------------------------------------------------

    async def health(self, request: Request):
        if self.engine is None:
            return json_response({"status": "ok"})
        if self.engine.dead:
            return json_response({"status": "engine_error",
                                  "reason": self.engine.dead_reason},
                                 status=503)
        if self.engine.stalled:
            # The step thread has not progressed while work is queued: a
            # wedged device step.  Routers treat 503 as unhealthy.
            return json_response({"status": "stalled"}, status=503)
        return json_response({"status": "ok"})

    async def embeddings(self, request: Request):
        """OpenAI /v1/embeddings for encoder models: ``input`` is a
        string, a list of strings, a list of token ids or a list of
        such lists; mean-pooled, L2-normalized embeddings."""
        if self.encoder is None:
            return json_response(
                {"error": "this deployment serves a causal LM; use the "
                          "offline LLM.encode API or the gRPC embedding "
                          "fleet for decoder pooling"}, status=400)
        body = await request.json()
        raw = body.get("input")
        if raw is None:
            return json_response({"error": "missing 'input'"}, status=400)
        if isinstance(raw, str):
            raw = [raw]
        if raw and isinstance(raw[0], int):
            raw = [raw]
        token_ids = [self._encode(item) if isinstance(item, str)
                     else [int(t) for t in item] for item in raw]
        if self._encode_lock is None:
            self._encode_lock = asyncio.Lock()
        async with self._encode_lock:   # one device batch at a time
            embs = await asyncio.to_thread(self.encoder.encode, token_ids)
        n = sum(len(t) for t in token_ids)
        return json_response({
            "object": "list",
            "model": self.model_name,
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in e]}
                     for i, e in enumerate(embs)],
            "usage": {"prompt_tokens": n, "total_tokens": n},
        })

    async def models(self, request: Request):
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "owned_by": "arcticinference-tpu"}],
        })

    async def metrics(self, request: Request):
        if self.engine is None:
            return json_response({"mode": "encoder"})
        eng = self.engine.engine
        st = eng.engine_stats
        return json_response({
            "num_waiting": len(eng.scheduler.waiting),
            "num_running": len(eng.scheduler.running),
            "num_steps": st.num_steps,
            "num_finished": st.num_finished,
            "num_prompt_tokens": st.num_prompt_tokens,
            "num_generated_tokens": st.num_generated_tokens,
            "num_cached_prompt_tokens":
                eng.scheduler.num_cached_prompt_tokens,
            "generation_tokens_per_s": round(st.tokens_per_second(), 2),
            "step_times": eng.step_times.summary(),
            "spec_decoding": eng.spec_stats.summary(),
        })

    async def start_profile(self, request: Request):
        """Begin a ``torch.profiler`` trace on the step thread (vLLM
        /start_profile parity); /stop_profile writes it to
        ``trace_dir``."""
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except HTTPError:
                body = {}
        trace_dir = body.get("trace_dir") or os.path.join(
            tempfile.gettempdir(), "arctic_tpu_torch_trace")
        if self.engine is None:
            return json_response({"error": "encoder mode"}, status=400)
        try:
            await asyncio.wrap_future(self.engine.call_on_engine_thread(
                self.engine.engine.start_profile, trace_dir))
        except RuntimeError as e:  # double start
            return json_response({"error": str(e)}, status=400)
        return json_response({"status": "profiling",
                              "trace_dir": trace_dir})

    async def stop_profile(self, request: Request):
        if self.engine is None:
            return json_response({"error": "encoder mode"}, status=400)
        await asyncio.wrap_future(self.engine.call_on_engine_thread(
            self.engine.engine.stop_profile))
        return json_response({"status": "ok"})

    async def completions(self, request: Request):
        if self.engine is None:
            return json_response(_ENCODER_ONLY, status=400)
        body = await request.json()
        prompt = body.get("prompt")
        prompt_ids = body.get("prompt_token_ids")
        if prompt_ids is None:
            if prompt is None:
                raise HTTPError(400, "prompt required")
            if isinstance(prompt, list):
                prompt = prompt[0]
            prompt_ids = self._encode(prompt)
        rid = f"cmpl-{uuid.uuid4().hex[:16]}"
        if body.get("echo") and int(body.get("max_tokens", 128)) == 0:
            # Prompt-logprob scoring (lm_eval loglikelihood): no
            # generation, teacher-forced per-token logprobs.
            try:
                lp = await asyncio.to_thread(self._score_sync, prompt_ids)
            except NotImplementedError as e:   # a served mesh
                return json_response({"error": str(e)}, status=400)
            return json_response({
                "id": rid, "object": "text_completion",
                "created": int(time.time()), "model": self.model_name,
                "choices": [{
                    "index": 0,
                    "text": self._decode(prompt_ids),
                    "token_ids": list(prompt_ids),
                    "logprobs": {
                        "tokens": [self._decode([t]) for t in prompt_ids],
                        "token_logprobs": [None] + [float(x) for x in lp],
                    },
                    "finish_reason": "stop",
                }],
                "usage": _usage(prompt_ids, []),
            })
        sampling = self._sampling_from(body)
        if body.get("stream"):
            if sampling.n > 1:
                raise HTTPError(400, "stream with n>1 unsupported")
            return await self._stream_completion(
                request, rid, prompt_ids, sampling, chat=False)
        fans = self._fan_out(body, sampling, rid)
        results = await asyncio.gather(*[
            self._collect(prompt_ids, sp, sub_rid)
            for sub_rid, sp in fans])
        _check_aborted(results)
        choices = []
        all_ids = []
        for i, (token_ids, finish, logprobs) in enumerate(results):
            all_ids.extend(token_ids)
            text = self._decode(token_ids)
            if sampling.stop:
                text, hit = self._trim_stops(text, sampling.stop)
                if hit:
                    finish = "finished_stopped"
            choice = {
                "index": i,
                "text": text,
                "token_ids": token_ids,
                "finish_reason": _reason(finish),
            }
            if logprobs is not None:
                choice["logprobs"] = {
                    "tokens": [self._decode([t]) for t in token_ids],
                    "token_logprobs": [lp.get(t) for t, lp in
                                       zip(token_ids, logprobs)],
                    "top_logprobs": [
                        {self._decode([t]): v for t, v in lp.items()}
                        for lp in logprobs],
                }
            choices.append(choice)
        return json_response({
            "id": rid, "object": "text_completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": choices,
            "usage": _usage(prompt_ids, all_ids),
        })

    def _score_sync(self, prompt_ids):
        """Scoring on a worker thread, behind the step loop's lock."""
        with self.engine._engine_lock:
            return self.engine.engine.score([list(prompt_ids)])[0]

    def _fan_out(self, body, sampling, rid):
        """n > 1: one engine request per choice.  Each choice gets its own
        guided decoder (stateful) and a distinct derived seed."""
        if sampling.n <= 1:
            return [(rid, sampling)]
        fans = []
        for i in range(sampling.n):
            sp = (self._sampling_from(body) if sampling.guided is not None
                  else dataclasses.replace(sampling))
            if sp.seed is not None:
                sp.seed = sp.seed + i
            fans.append((f"{rid}-{i}", sp))
        return fans

    async def chat_completions(self, request: Request):
        if self.engine is None:
            return json_response(_ENCODER_ONLY, status=400)
        body = await request.json()
        messages = body.get("messages")
        if not messages:
            raise HTTPError(400, "messages required")
        prompt_ids = self._chat_prompt_ids(messages)
        sampling = self._sampling_from(body)
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        if body.get("stream"):
            if sampling.n > 1:
                raise HTTPError(400, "stream with n>1 unsupported")
            return await self._stream_completion(
                request, rid, prompt_ids, sampling, chat=True)
        fans = self._fan_out(body, sampling, rid)
        results = await asyncio.gather(*[
            self._collect(prompt_ids, sp, sub_rid)
            for sub_rid, sp in fans])
        _check_aborted(results)
        choices = []
        all_ids = []
        for i, (token_ids, finish, _) in enumerate(results):
            all_ids.extend(token_ids)
            text = self._decode(token_ids)
            if sampling.stop:
                text, hit = self._trim_stops(text, sampling.stop)
                if hit:
                    finish = "finished_stopped"
            choices.append({
                "index": i,
                "message": {"role": "assistant", "content": text},
                "finish_reason": _reason(finish),
            })
        return json_response({
            "id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": self.model_name,
            "choices": choices,
            "usage": _usage(prompt_ids, all_ids),
        })

    def _chat_prompt_ids(self, messages: list[dict]) -> list[int]:
        if self.tokenizer is not None and \
                getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        text = "\n".join(f"{m.get('role')}: {m.get('content')}"
                         for m in messages) + "\nassistant:"
        return self._encode(text)

    async def _collect(self, prompt_ids, sampling, rid):
        token_ids: list[int] = []
        finish = None
        logprobs = None
        try:
            async for chunk in self.engine.generate(prompt_ids, sampling,
                                                    rid):
                token_ids.extend(chunk.new_token_ids)
                if chunk.finished:
                    finish = chunk.finish_reason
                    if chunk.logprobs is not None:
                        logprobs = chunk.logprobs
        except asyncio.CancelledError:
            # The client disconnected mid-request (the HTTP layer cancels
            # the handler): stop the engine-side request too.
            await self.engine.abort(rid)
            raise
        return token_ids, finish, logprobs

    async def _stream_completion(self, request, rid, prompt_ids, sampling,
                                 chat: bool):
        resp = StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        sent_text = ""
        all_ids: list[int] = []
        obj = "chat.completion.chunk" if chat else "text_completion"
        try:
            async for chunk in self.engine.generate(prompt_ids, sampling,
                                                    rid):
                all_ids.extend(chunk.new_token_ids)
                full = self._decode(all_ids)
                if sampling.stop:
                    full, _ = self._trim_stops(full, sampling.stop)
                delta_text = full[len(sent_text):]
                # Hold back partial unicode tails.
                if delta_text.endswith("�"):
                    delta_text = ""
                if delta_text:
                    sent_text = full
                payload = {
                    "id": rid, "object": obj,
                    "created": int(time.time()),
                    "model": self.model_name,
                    "choices": [
                        {"index": 0,
                         "delta": {"content": delta_text}}
                        if chat else
                        {"index": 0, "text": delta_text,
                         "token_ids": chunk.new_token_ids}],
                }
                if chunk.finished:
                    payload["choices"][0]["finish_reason"] = _reason(
                        chunk.finish_reason)
                await resp.write(
                    f"data: {json.dumps(payload)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            await self.engine.abort(rid)
            raise
        await resp.write_eof()
        return resp


def _check_aborted(results) -> None:
    """Engine-aborted generations (e.g. a guided request stranded by a
    device mask inconsistency) surface as an error response, never a
    silently truncated 200."""
    if any(finish == "finished_aborted" for _, finish, *_ in results):
        raise HTTPError(500, "generation aborted by the engine")


def _reason(finish: Optional[str]) -> str:
    if finish == "finished_length":
        return "length"
    if finish in ("finished_aborted", "engine_error"):
        # Never dress an engine abort up as a clean stop: streaming
        # clients must see the failure (non-streaming paths answer 500).
        return "error"
    return "stop"


def _usage(prompt_ids, token_ids) -> dict:
    return {
        "prompt_tokens": len(prompt_ids),
        "completion_tokens": len(token_ids),
        "total_tokens": len(prompt_ids) + len(token_ids),
    }


def build_config(args: argparse.Namespace) -> EngineConfig:
    if args.config:
        cfg = EngineConfig.from_dict(json.loads(Path(args.config)
                                                .read_text()))
    else:
        cfg = EngineConfig()
    if args.model:
        cfg.model.model = args.model
        cfg.model.tokenizer = args.model
    if args.quantization:
        cfg.model.quantization = args.quantization
    if args.max_model_len:
        cfg.model.max_model_len = args.max_model_len
    if args.max_num_seqs:
        cfg.scheduler.max_num_seqs = args.max_num_seqs
    if args.max_num_batched_tokens:
        cfg.scheduler.max_num_batched_tokens = args.max_num_batched_tokens
    if args.kv_cache_dtype:
        cfg.cache.kv_cache_dtype = args.kv_cache_dtype
    if args.block_size:
        cfg.cache.block_size = args.block_size
    # The mesh flags build the JAX CLI's ParallelConfig (served with the
    # --multihost-* flags, one process per rank).
    if (args.tensor_parallel_size or args.ulysses_sequence_parallel_size
            or args.enable_shift_parallel):
        cfg.parallel = ParallelConfig(
            tensor_parallel_size=args.tensor_parallel_size or 1,
            ulysses_sequence_parallel_size=(
                args.ulysses_sequence_parallel_size or 1),
            enable_shift_parallel=args.enable_shift_parallel,
            shift_parallel_threshold=args.shift_parallel_threshold)
    if args.speculative_config:
        cfg.speculative = SpeculativeConfig.from_json(
            args.speculative_config)
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="OpenAI-compatible server of the PyTorch port")
    parser.add_argument("--model", default=None)
    parser.add_argument("--config", default=None,
                        help="EngineConfig JSON file")
    parser.add_argument("--device", default=None,
                        help="cuda:0 by default (with --multihost-*: the "
                        "rank's own card, or cuda:0 shared), or cpu")
    parser.add_argument("--quantization", default=None)
    parser.add_argument("--speculative-config", default=None,
                        help='JSON, e.g. {"method": "suffix"}')
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-model-len", type=int, default=None)
    parser.add_argument("--max-num-seqs", type=int, default=None)
    parser.add_argument("--max-num-batched-tokens", type=int, default=None)
    parser.add_argument("--kv-cache-dtype", default=None,
                        choices=[None, "auto", "bfloat16", "fp8"])
    parser.add_argument("--block-size", type=int, default=None)
    parser.add_argument("--tensor-parallel-size", type=int, default=None)
    parser.add_argument("--ulysses-sequence-parallel-size", type=int,
                        default=None)
    parser.add_argument("--enable-shift-parallel", action="store_true")
    parser.add_argument("--shift-parallel-threshold", type=int,
                        default=512)
    # A served mesh: the same command on every rank, with its own
    # --multihost-process-id; process 0 serves HTTP, the rest replay its
    # device steps.
    parser.add_argument("--multihost-coordinator", default=None,
                        help="host:port of the process group's rendezvous "
                        "(process 0)")
    parser.add_argument("--multihost-num-processes", type=int, default=0)
    parser.add_argument("--multihost-process-id", type=int, default=0)
    parser.add_argument("--multihost-leader", default="127.0.0.1",
                        help="the leader's host, for the step channel")
    parser.add_argument("--multihost-channel-port", type=int, default=8550)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    given = [a.split("=")[0] for a in argv if a.startswith("--multihost-")]
    if args.multihost_num_processes > 1:
        if not args.multihost_coordinator:
            raise ValueError(
                "--multihost-num-processes: multi-host serving needs "
                "--multihost-coordinator HOST:PORT")
    elif given:
        raise ValueError(
            f"{given[0]}: multi-host serving needs "
            "--multihost-num-processes > 1")
    return args


def make_server(argv=None) -> tuple[OpenAIServer, argparse.Namespace]:
    """The server the command line asks for (not yet listening) and the
    parsed arguments; one process (a mesh is served by :func:`main`)."""
    args = parse_args(argv)
    device = args.device or "cuda:0"
    return OpenAIServer(build_config(args), device=device), args


def main(argv=None) -> None:
    args = parse_args(argv)
    n = args.multihost_num_processes
    if n <= 1:
        server = OpenAIServer(build_config(args),
                              device=args.device or "cuda:0")
        server.app.run(args.host, args.port)
        return
    from arcticinference_tpu_torch.parallel import multihost

    config = build_config(args)
    device = multihost.initialize(args.multihost_coordinator, n,
                                  args.multihost_process_id, args.device)
    if args.multihost_process_id != 0:
        from arcticinference_tpu_torch.engine.engine import LLMEngine

        engine = LLMEngine(config, device=device)
        channel = multihost.FollowerChannel(args.multihost_leader,
                                            args.multihost_channel_port)
        try:
            multihost.follower_serve(engine, channel)
        except ConnectionError:
            sys.exit(3)       # the leader is gone: exit, never deadlock
        return
    server = OpenAIServer(config, device=device)
    channel = multihost.LeaderChannel(n - 1, args.multihost_channel_port)
    channel.wait_connected()
    server.engine.attach_channel(channel)
    server.app.run(args.host, args.port)


if __name__ == "__main__":
    main()
