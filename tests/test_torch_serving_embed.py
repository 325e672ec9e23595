"""/v1/embeddings of the port's OpenAI server against the JAX server's.

A BERT deployment (2 layers, hidden 64, float32; the JAX encoder's
weights carried into the port's with ``params_from_jax``) on both
servers, the JAX one in-process on ``aiohttp``'s ``TestServer``, the
port's on its standard-library HTTP layer.  The same requests give the
same bodies: ``object``, ``model``, each ``data[i]``'s ``object`` and
``index``, ``usage``, and embeddings within 1e-4, for an input of token
ids, a list of such lists and an empty list; the same 400 bodies for a
missing input and for text without a tokenizer; and the encoder-mode
answers of the generate routes, /start_profile, /stop_profile,
/metrics, /health and /v1/models.  A causal deployment's 400 is in
``tests/test_torch_serving.py``.
"""

import asyncio
import json

import jax
import numpy as np
import pytest

from arcticinference_tpu import config as jcfg
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.serving import http
from arcticinference_tpu_torch.serving.openai_server import OpenAIServer
from arcticinference_tpu_torch.weights import params_from_jax

from tests.test_torch_bert import config_dict

test_utils = pytest.importorskip("aiohttp.test_utils")


@pytest.fixture(scope="module")
def servers():
    from arcticinference_tpu.serving.openai_server import (
        OpenAIServer as JaxServer)

    d = config_dict()
    jax_srv = JaxServer(jcfg.EngineConfig.from_dict(d),
                        served_model_name="bert-tiny")
    port_srv = OpenAIServer(tcfg.EngineConfig.from_dict(d),
                            served_model_name="bert-tiny", device="cpu")
    assert port_srv.engine is None and jax_srv.engine is None
    port_srv.encoder.params = params_from_jax(
        jax.tree.map(np.asarray, jax_srv.encoder.params), "cpu")
    loop = asyncio.new_event_loop()

    async def start():
        ts = test_utils.TestServer(jax_srv.app)
        await ts.start_server()
        port = await port_srv.app.start("127.0.0.1", 0)
        return ts, {"jax": str(ts.make_url("")).rstrip("/"),
                    "port": f"http://127.0.0.1:{port}"}

    ts, urls = loop.run_until_complete(start())
    yield loop, urls
    loop.run_until_complete(ts.close())
    loop.run_until_complete(port_srv.app.stop())
    loop.close()


def _both(servers, method, path, body=None):
    loop, urls = servers

    async def one(side):
        async with http.request(method, urls[side] + path, json=body,
                                timeout=60) as r:
            return (r.status, r.headers.get("content-type", "")
                    .split(";")[0], await r.read())

    async def go():
        return await asyncio.gather(one("jax"), one("port"))

    return loop.run_until_complete(go())


INPUTS = {
    "token ids": [5, 6, 7, 8],
    "lists of token ids": [[1, 2, 3], [9] * 20, [4, 5]],
    "empty list": [],
}


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_embeddings_body_matches_jax(servers, case):
    (js, jct, jb), (ts, tct, tb) = _both(
        servers, "POST", "/v1/embeddings",
        {"input": INPUTS[case], "model": "bert-tiny"})
    assert js == ts == 200 and jct == tct == "application/json"
    j, t = json.loads(jb), json.loads(tb)
    assert t.keys() == j.keys()
    assert (t["object"], t["model"], t["usage"]) == \
        (j["object"], j["model"], j["usage"])
    assert len(t["data"]) == len(j["data"])
    for td, jd in zip(t["data"], j["data"]):
        assert (td["object"], td["index"]) == (jd["object"], jd["index"])
        np.testing.assert_allclose(td["embedding"], jd["embedding"],
                                   rtol=0, atol=1e-4)
        assert abs(np.linalg.norm(td["embedding"]) - 1) < 1e-5


ERRORS = {
    "missing input": ("POST", "/v1/embeddings", {"model": "bert-tiny"}),
    "text without a tokenizer": ("POST", "/v1/embeddings",
                                 {"input": ["hello"]}),
    "completions": ("POST", "/v1/completions",
                    {"prompt_token_ids": [1, 2], "max_tokens": 2}),
    "chat": ("POST", "/v1/chat/completions",
             {"messages": [{"role": "user", "content": "hi"}]}),
    "start_profile": ("POST", "/start_profile", {}),
    "stop_profile": ("POST", "/stop_profile", None),
    "metrics": ("GET", "/metrics", None),
    "health": ("GET", "/health", None),
    "models": ("GET", "/v1/models", None),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_encoder_mode_answers_match_jax(servers, case):
    method, path, body = ERRORS[case]
    (js, jct, jb), (ts, tct, tb) = _both(servers, method, path, body)
    assert (ts, tct) == (js, jct)
    assert json.loads(tb) == json.loads(jb)
    assert ts == (200 if case in ("metrics", "health", "models") else 400)
