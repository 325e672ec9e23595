"""The port's embedding path and fleet against the JAX package's.

- Causal ``LLM.encode`` (mean / last pooling, with and without L2
  normalisation) within 1e-4 of the JAX ``LLM.encode`` on a tiny Llama
  (float32, the JAX weights carried across with ``params_from_jax``) and
  on tiny Qwen2 and Qwen3, on a prompt list that splits into several
  device batches; a prompt's
  embedding does not depend on its batch; a prompt past the token budget
  raises in both.  SwiftKV pools its sample rows (``last``) and refuses
  ``mean``, which needs every row.
- ``embedding/wire.py``: every message of ``inference.proto`` written
  byte for byte as protobuf's ``SerializeToString`` writes it (populated
  and empty, a negative seed and a negative int32 among them), and each
  side parses the other's bytes (skipped without ``protobuf``).
- The port's replica (``embedding/transport.py`` over HTTP/1.1) against
  the JAX replica (gRPC, in-process) on the same weights: embeddings
  within 1e-4, the status codes the JAX servicer hands ``context.abort``
  for a missing input, a text prompt without a tokenizer and an aborted
  request (3, 13 and 1; over gRPC the JAX replica's int codes reach the
  client as UNKNOWN, see ROADMAP Queue 3) with the same details, the
  info counters and health.  ``Generate`` streams ``LLM.generate``'s
  tokens in several deltas; seeded streams repeat.
- The port's manager: failover when a replica stops, a bad request
  answered with the replica's own status while every replica stays in
  rotation, ``Abort`` returning while an encode holds the engine lock,
  summed info, no ``Generate`` (UNIMPLEMENTED), the async client, the
  bench against a replica and in-process, and ``python -m
  arcticinference_tpu_torch embed`` serving through a spawned replica.
"""

import asyncio
import json
import signal
import subprocess
import sys
import threading
import time
from concurrent import futures
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.llm import LLM as JaxLLM
from arcticinference_tpu.models.loader import load_model as jax_load_model
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.embedding import wire
from arcticinference_tpu_torch.embedding.client import (AsyncInferenceClient,
                                                        InferenceClient)
from arcticinference_tpu_torch.embedding.replica import InferenceServicer
from arcticinference_tpu_torch.embedding.replica_manager import (
    ManagerServicer, Replica, ReplicaManager)
from arcticinference_tpu_torch.embedding.transport import (RpcError, Server,
                                                           StatusCode)
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.weights import params_from_jax

from tests.test_torch_engine import TINY, config_dict

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def llms():
    """The JAX LLM and the port's on the JAX weights (budget 32 tokens,
    4 sequences per batch)."""
    d = config_dict(hf=TINY)
    jconf = jcfg.EngineConfig.from_dict(d)
    jllm = JaxLLM(jconf)
    _, _, jp = jax_load_model(jconf.model)
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    tllm.engine.runner.params = tllama.fuse_params(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    yield jllm, tllm
    tllm.close()
    jllm.close()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(1, 97, n)]
            for n in (3, 17, 30, 9, 12, 5, 20, 8)]


# ---------------------------------------------------------------------------
# Causal LLM.encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_causal_encode_matches_jax(llms, prompts, pooling, normalize):
    jllm, tllm = llms
    kw = dict(normalize=True) if normalize else {}
    want = jllm.encode(prompt_token_ids=prompts, pooling=pooling, **kw)
    got = tllm.encode(prompt_token_ids=prompts, pooling=pooling, **kw)
    assert len(got) == len(prompts)
    for g, w in zip(got, want):
        assert g.shape == (TINY["hidden_size"],) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    norms = np.linalg.norm(got, axis=-1)
    # A causal LM normalizes only when asked.
    assert np.allclose(norms, 1.0, atol=1e-5) == normalize


@pytest.mark.parametrize("arch", ["qwen2", "qwen3"])
def test_causal_encode_matches_jax_on_qwen(arch, prompts):
    """Qwen2's q/k/v biases and Qwen3's per-head q/k norms on the same
    pooled path (mean, normalized)."""
    d = config_dict(arch, dict(TINY, head_dim=16))
    jconf = jcfg.EngineConfig.from_dict(d)
    jllm = JaxLLM(jconf)
    _, _, jp = jax_load_model(jconf.model)
    tllm = LLM(tcfg.EngineConfig.from_dict(d), device="cpu")
    runner = tllm.engine.runner
    runner.params = runner.module.fuse_params(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    want = jllm.encode(prompt_token_ids=prompts, normalize=True)
    got = tllm.encode(prompt_token_ids=prompts, normalize=True)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=1e-4)
    tllm.close()
    jllm.close()


def test_causal_encode_batch_independence(llms):
    _, tllm = llms
    one = tllm.encode(prompt_token_ids=[[7, 8, 9]])[0]
    many = tllm.encode(prompt_token_ids=[[1, 2], [7, 8, 9], [5] * 20,
                                         [3] * 25])[1]
    np.testing.assert_allclose(one, many, rtol=0, atol=1e-5)
    assert tllm.engine.scheduler.block_manager.num_free_blocks == \
        tllm.engine.runner.num_blocks - 1       # every block given back


def test_causal_encode_refuses_a_prompt_past_the_budget(llms):
    for llm in llms:
        with pytest.raises(ValueError, match="max_num_batched_tokens=32"):
            llm.encode(prompt_token_ids=[[1] * 33])


def test_swiftkv_encode_pools_its_sample_rows():
    hf = dict(TINY, num_hidden_layers=4, num_key_value_layers=2)
    llm = LLM(tcfg.EngineConfig.from_dict(config_dict("llama_swiftkv", hf)),
              device="cpu")
    p = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11]
    got = llm.encode(prompt_token_ids=p, pooling="last")
    for ids, g in zip(p, got):
        alone = llm.encode(prompt_token_ids=[ids], pooling="last")[0]
        np.testing.assert_allclose(g, alone, rtol=0, atol=1e-5)
    assert not np.allclose(got[0], got[1])
    with pytest.raises(NotImplementedError, match="pooling='last'"):
        llm.encode(prompt_token_ids=p, pooling="mean")
    llm.close()


# ---------------------------------------------------------------------------
# The wire format against protobuf
# ---------------------------------------------------------------------------

WIRE_CASES = {
    "TokenIds": dict(token_id_bytes_i32=np.arange(-2, 5, dtype="<i4")
                     .tobytes()),
    "EncodeRequest": dict(request_id="req-é", prompts=["a b", "", "ç"],
                          pooling="last"),
    "EncodeResponse": dict(request_id="r", embeddings=[
        np.linspace(-1, 1, 7, dtype="<f4").tobytes(), b""], dim=7),
    "AbortRequest": dict(request_id="x" * 200),
    "AbortResponse": dict(aborted=True),
    "ReplicaInfoRequest": {},
    "ReplicaInfoResponse": dict(model="m", active_requests=-3,
                                total_requests=2 ** 40, total_tokens=12345),
    "HealthCheckRequest": {},
    "HealthCheckResponse": dict(healthy=True),
    "GenerateRequest": dict(
        request_id="g", prompt="hi", token_id_bytes_i32=b"\x01\0\0\0",
        max_tokens=300, temperature=0.7, top_p=0.9, top_k=-1,
        ignore_eos=True, stop=["\n", "", "END"], seed=-1),
    "GenerateResponse": dict(request_id="g", token_ids=[5, -7, 2 ** 31 - 1,
                                                        0, 300],
                             text_delta="δ", finished=True,
                             finish_reason="finished_length"),
}


@pytest.fixture(scope="module")
def pb2():
    pytest.importorskip("google.protobuf")
    pytest.importorskip("grpc")
    from arcticinference_tpu.embedding import codegen

    return codegen.load_pb2()


@pytest.mark.parametrize("name", sorted(WIRE_CASES))
def test_wire_bytes_equal_protobuf(pb2, name):
    assert len(wire.MESSAGES) == len(WIRE_CASES) == 11
    ours, theirs = getattr(wire, name), getattr(pb2, name)
    kw = dict(WIRE_CASES[name])
    if name == "EncodeRequest":
        ids = [np.asarray([3, -1, 70000], "<i4").tobytes(), b""]
        msg = ours(token_ids=[wire.TokenIds(token_id_bytes_i32=b)
                              for b in ids], **kw)
        ref = theirs(**kw)
        for b in ids:
            ref.token_ids.append(pb2.TokenIds(token_id_bytes_i32=b))
    else:
        msg, ref = ours(**kw), theirs(**kw)
    for m, r in ((msg, ref), (ours(), theirs())):
        data = r.SerializeToString()
        assert m.SerializeToString() == data
        assert theirs.FromString(m.SerializeToString()) == r
        # Parsed: protobuf's values (floats as float32 values).
        got = ours.FromString(data)
        assert got.SerializeToString() == data
        for _, field, kind, repeated in ours.FIELDS:
            a, b = getattr(got, field), getattr(r, field)
            if kind is wire.TokenIds:
                a = [t.token_id_bytes_i32 for t in a]
                b = [t.token_id_bytes_i32 for t in b]
            assert (list(a) if repeated else a) == \
                (list(b) if repeated else b), field


def test_wire_edge_cases(pb2):
    # int64 -1: ten varint bytes; a negative int32 in a packed field too.
    assert wire.GenerateRequest(seed=-1).SerializeToString() == \
        b"\x50" + b"\xff" * 9 + b"\x01"
    data = wire.GenerateResponse(token_ids=[-1]).SerializeToString()
    assert data == b"\x12\x0a" + b"\xff" * 9 + b"\x01"
    # Unpacked items, fields out of order and an unknown field parse.
    raw = (b"\x2a\x04stop" + b"\x10\x05" + b"\x10\x06" + b"\x20\x01"
           + b"\x78\x09" + b"\x0a\x01r")
    ref = pb2.GenerateResponse.FromString(raw)
    got = wire.GenerateResponse.FromString(raw)
    assert (got.request_id, got.token_ids, got.finished,
            got.finish_reason) == (ref.request_id, list(ref.token_ids),
                                   ref.finished, ref.finish_reason)
    assert got.SerializeToString() == ref.SerializeToString()
    with pytest.raises(ValueError):
        wire.EncodeRequest.FromString(b"\x0a\x05ab")


# ---------------------------------------------------------------------------
# Replicas: the port's against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicas(llms):
    """(JAX target, port target, port servicer, port server)."""
    grpc = pytest.importorskip("grpc")
    from arcticinference_tpu.embedding import codegen
    from arcticinference_tpu.embedding.replica import (
        InferenceServicer as JaxServicer)

    jllm, tllm = llms
    jserver = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    codegen.add_servicer_to_server(JaxServicer(jllm, "tiny"), jserver)
    jport = jserver.add_insecure_port("localhost:0")
    jserver.start()
    servicer = InferenceServicer(tllm, "tiny")
    server = Server(max_workers=4)
    server.add_servicer(servicer)
    port = server.start()
    yield f"localhost:{jport}", f"127.0.0.1:{port}", servicer, server
    server.stop()
    jserver.stop(0)


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_replica_embeddings_match_jax_replica(replicas, pooling):
    from arcticinference_tpu.embedding.client import (
        InferenceClient as JaxClient)

    jtarget, target, _, _ = replicas
    ids = [[1, 2, 3], [9, 8, 7, 6], [5] * 20]
    jc = JaxClient(jtarget)
    want = jc.embed(token_ids=ids, pooling=pooling)
    jc.close()
    got = InferenceClient(target).embed(token_ids=ids, pooling=pooling)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


class _Recording:
    """A servicer context that records the code handed to ``abort``."""

    def abort(self, code, details):
        self.code, self.details = code, details
        raise RuntimeError("aborted")


@pytest.mark.parametrize("case", ["missing input", "no tokenizer",
                                  "aborted"])
def test_status_codes_match_jax(replicas, llms, pb2, case):
    import grpc

    from arcticinference_tpu.embedding.replica import (
        InferenceServicer as JaxServicer)

    jtarget, target, _, _ = replicas
    rid = f"status-{case}"
    kw = {"missing input": {}, "no tokenizer": dict(prompts=["hello"]),
          "aborted": dict(token_ids=[[1, 2]])}[case]
    # The JAX servicer's own code, in-process.
    jserv = JaxServicer(llms[0], "tiny")
    if case == "aborted":
        jserv.Abort(pb2.AbortRequest(request_id=rid), None)
    jreq = pb2.EncodeRequest(request_id=rid, prompts=kw.get("prompts", []))
    for ids in kw.get("token_ids", []):
        jreq.token_ids.append(pb2.TokenIds(
            token_id_bytes_i32=np.asarray(ids, "<i4").tobytes()))
    ctx = _Recording()
    with pytest.raises(RuntimeError, match="aborted"):
        jserv.Encode(jreq, ctx)
    # Over the wire: the JAX replica's details, and the port's.
    from arcticinference_tpu.embedding.client import (
        InferenceClient as JaxClient)

    jc = JaxClient(jtarget)
    client = InferenceClient(target)
    if case == "aborted":
        assert jc.abort(rid) and client.abort(rid)
    with pytest.raises(grpc.RpcError) as jerr:
        jc.stub.Encode(jreq, timeout=10)
    jc.close()
    req = wire.EncodeRequest.FromString(jreq.SerializeToString())
    with pytest.raises(RpcError) as err:
        client.stub.Encode(req, timeout=10)
    assert err.value.code() == ctx.code == {
        "missing input": StatusCode.INVALID_ARGUMENT,
        "no tokenizer": StatusCode.INTERNAL,
        "aborted": StatusCode.CANCELLED}[case]
    assert err.value.details() == jerr.value.details() == ctx.details
    assert not err.value.transport


def test_info_counters_and_health_match_jax(replicas):
    from arcticinference_tpu.embedding.client import (
        InferenceClient as JaxClient)

    jtarget, target, _, _ = replicas
    jc, client = JaxClient(jtarget), InferenceClient(target)
    before = [jc.info(), client.info()]
    for c in (jc, client):
        c.embed(token_ids=[[1, 2, 3], [4, 5, 6, 7]])
        c.embed(token_ids=[[1, 2]])
    after = [jc.info(), client.info()]
    for b, a in zip(before, after):
        assert (a.model, a.active_requests) == ("tiny", 0)
        assert a.total_requests - b.total_requests == 2
        assert a.total_tokens - b.total_tokens == 9
    assert jc.health() and client.health()
    jc.close()


def test_generate_stream_matches_llm_generate(replicas, llms):
    _, target, _, _ = replicas
    want = llms[1].generate(
        prompt_token_ids=[[5, 6, 7]],
        sampling_params=SamplingParams(max_tokens=8,
                                       ignore_eos=True))[0].token_ids
    toks, chunks, finish = [], 0, None
    for c in InferenceClient(target).generate(token_ids=[5, 6, 7],
                                              max_tokens=8,
                                              ignore_eos=True):
        toks.extend(c["token_ids"])
        chunks += 1
        if c["finished"]:
            finish = c["finish_reason"]
    assert toks == want
    assert chunks >= 2
    assert finish == "finished_length"


def test_generate_seeded_streams_repeat(replicas):
    _, target, _, _ = replicas
    client = InferenceClient(target)

    def run():
        return [t for c in client.generate(
            token_ids=[9, 8, 7], max_tokens=6, temperature=1.0, seed=5,
            ignore_eos=True) for t in c["token_ids"]]

    a = run()
    assert len(a) == 6 and run() == a


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

def _manager(servers, health_interval=0.2):
    mgr = ReplicaManager(0, 0, [], spawn=False,
                         health_interval=health_interval)
    for _, port in servers:
        r = Replica(port=port)
        r.connect()
        mgr.replicas.append(r)
    mgr.wait_ready(min_replicas=len(servers))
    return mgr


def _server(llm):
    servicer = InferenceServicer(llm, "tiny")
    server = Server(max_workers=4)
    server.add_servicer(servicer)
    return server, server.start()


def test_manager_fails_over_when_a_replica_stops(replicas, llms):
    _, target, _, _ = replicas
    extra = _server(llms[1])
    mgr = _manager([(None, int(target.rsplit(":", 1)[1])), extra],
                   health_interval=60)
    extra[0].stop()
    req = wire.EncodeRequest(request_id="f", token_ids=[
        wire.TokenIds(token_id_bytes_i32=np.asarray([1, 2, 3],
                                                    "<i4").tobytes())])
    for _ in range(4):
        assert len(mgr.route_encode(req).embeddings) == 1
    assert [r.healthy for r in mgr.replicas] == [True, False]
    mgr.shutdown()


def test_bad_request_keeps_every_replica_in_rotation(replicas, llms):
    """A request without input is the replica's own INVALID_ARGUMENT: it
    goes back to the client unretried, and the good request right after
    it is answered with every replica still up."""
    _, target, _, _ = replicas
    extra = _server(llms[1])
    mgr = _manager([(None, int(target.rsplit(":", 1)[1])), extra],
                   health_interval=60)
    server = Server(max_workers=4)
    server.add_servicer(ManagerServicer(mgr))
    client = InferenceClient(f"127.0.0.1:{server.start()}")
    with pytest.raises(RpcError) as err:
        client.stub.Encode(wire.EncodeRequest(request_id="bad"), timeout=10)
    assert err.value.code() == StatusCode.INVALID_ARGUMENT
    assert err.value.details() == "prompts or token_ids required"
    assert all(r.healthy for r in mgr.replicas)
    assert len(client.embed(token_ids=[[4, 5]])) == 1
    server.stop()
    extra[0].stop()
    mgr.shutdown()


def test_abort_returns_while_an_encode_holds_the_engine_lock(replicas):
    _, target, servicer, _ = replicas
    client = InferenceClient(target)
    with servicer._lock:          # as a running encode or step holds it
        t = time.perf_counter()
        assert client.abort("held")
        assert time.perf_counter() - t < 5
    with pytest.raises(RpcError) as err:
        client.embed(token_ids=[[1]], request_id="held")
    assert err.value.code() == StatusCode.CANCELLED


def test_manager_sums_info_and_has_no_generate(replicas):
    _, target, servicer, _ = replicas
    mgr = _manager([(None, int(target.rsplit(":", 1)[1]))] * 2,
                   health_interval=60)
    server = Server(max_workers=4)
    server.add_servicer(ManagerServicer(mgr))
    client = InferenceClient(f"127.0.0.1:{server.start()}")
    one = InferenceClient(target).info()
    info = client.info()
    assert (info.model, info.total_requests, info.total_tokens) == (
        "tiny", 2 * one.total_requests, 2 * one.total_tokens)
    assert client.health() and client.abort("nothing")
    with pytest.raises(RpcError) as err:
        list(client.generate(token_ids=[1, 2]))
    assert err.value.code() == StatusCode.UNIMPLEMENTED
    mgr._stop.set()
    with mgr._lock:
        for r in mgr.replicas:
            r.healthy = False
    with pytest.raises(RpcError) as err:
        client.embed(token_ids=[[1]])
    assert err.value.code() == StatusCode.UNAVAILABLE
    assert err.value.details() == "no healthy replicas"
    server.stop()


def test_async_client(replicas, llms):
    _, target, _, _ = replicas

    async def go():
        c = AsyncInferenceClient(target)
        embs = await c.embed(token_ids=[[11, 12, 13]])
        toks = [t async for ch in c.generate(token_ids=[5, 6, 7],
                                             max_tokens=4, ignore_eos=True)
                for t in ch["token_ids"]]
        info = await c.info()
        ok = await c.health() and await c.abort("a")
        await c.close()
        return embs, toks, info, ok

    embs, toks, info, ok = asyncio.run(go())
    np.testing.assert_allclose(
        embs[0], llms[1].encode(prompt_token_ids=[[11, 12, 13]])[0],
        rtol=0, atol=1e-6)
    assert len(toks) == 4 and info.model == "tiny" and ok


@pytest.mark.parametrize("mode", ["remote", "local"])
def test_embedding_bench(tmp_path, mode):
    """A tiny BERT at BERT's vocabulary (the bench draws remote ids from
    [1, 30000)), behind a replica or in-process."""
    from arcticinference_tpu_torch.benchmarks import embedding_bench
    from tests.test_torch_bert import HF
    from tests.test_torch_bert import config_dict as bert_config

    d = bert_config(dict(HF, vocab_size=30522))
    args = ["--batch-sizes", "4", "--iters", "2", "--concurrency", "2",
            "--len-dist", "uniform:3,20"]
    server = None
    if mode == "local":
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(d))
        args += ["--local", "--device", "cpu", "--config", str(path)]
    else:
        server, port = _server(LLM(tcfg.EngineConfig.from_dict(d),
                                   device="cpu"))
        args += ["--target", f"127.0.0.1:{port}"]
    try:
        res, = embedding_bench.main(args)
    finally:
        if server is not None:
            server.stop()
    assert res["mode"] == mode and res["batch"] == 4
    assert res["requests"] == (4 if mode == "remote" else 2)
    assert res["ktok_per_s"] > 0 and res["latency_p99_ms"] > 0


def test_embed_cli_serves_through_a_spawned_replica(tmp_path):
    """``python -m arcticinference_tpu_torch embed`` spawns its replica,
    answers Encode through it and stops both on SIGTERM."""
    from tests.test_torch_serving import _free_port

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(config_dict(hf=TINY)))
    port = _free_port()
    log = open(tmp_path / "log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "arcticinference_tpu_torch", "embed",
         "--port", str(port), "--replica-base-port", str(_free_port()),
         "--config", str(cfg), "--device", "cpu", "--host", "127.0.0.1"],
        cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while "manager ready" not in (tmp_path / "log").read_text():
            assert proc.poll() is None, (tmp_path / "log").read_text()
            assert time.time() < deadline
            time.sleep(0.2)
        client = InferenceClient(f"127.0.0.1:{port}")
        embs = client.embed(token_ids=[[1, 2, 3], [4, 5]])
        assert len(embs) == 2 and embs[0].shape == (TINY["hidden_size"],)
        assert client.info().total_requests == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "replica ready" in (tmp_path / "log").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
