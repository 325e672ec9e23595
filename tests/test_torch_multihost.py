"""The port's served mesh (``parallel/multihost.py``): the leader's step
broadcast, the follower mirror, the watchdog and the ``--multihost-*``
command line, on CPU gloo worlds.

- The channel: the leader's watchdog reports a follower that
  disconnects and one whose heartbeats stop (the JAX
  ``TestChannelWatchdog`` cases, on the port's channel); the process
  group's backend follows the cards (gloo on the CPU or a shared card,
  NCCL with a card a rank).
- One module-scoped gloo world of 4 ranks serves the tiny trained
  checkpoint at tp 2 and at sp 2 x tp 2 with shift: each greedy request
  sent alone (and a warm second one) returns the tokens of
  ``LLM.generate`` on that world and of the single device; a seeded,
  penalised request those of ``LLM.generate`` with the same seed; a
  guided request the single device's guided tokens (the host-mask
  route); every follower replays as many dispatches as the leader ran,
  to the same output digest.  Echo scoring answers 400 and the engine's
  unmirrored entries raise, at once.
- Suffix decoding through the served shift world runs the fused loop
  (fused steps and drafts on the leader, the same number of fused steps
  replayed on every follower); an Arctic MLP drafter with random weights
  at tp 2 and at shift, served and through ``LLM.generate``, keeps the
  non-speculative single device's tokens, with every rank's accepted
  count equal; a tied drafter on tp 2 gathers the tp-cut LM head's
  logits into the single device's drafts.
- The real command line: two ``serve --multihost-*`` processes answer a
  request with the single device's tokens; a killed follower fails the
  in-flight request and turns /health into 503 well inside 60 s; a
  follower whose leader is killed exits 3.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.parallel.multihost import (FollowerChannel,
                                                          LeaderChannel)
from arcticinference_tpu_torch.parallel.world import World, free_port
from arcticinference_tpu_torch.serving import http

from tests import torch_parallel_tasks as tasks

REPO = Path(__file__).resolve().parents[1]
TP2 = dict(tensor_parallel_size=2)
SHIFT = dict(tensor_parallel_size=2, ulysses_sequence_parallel_size=2,
             enable_shift_parallel=True, shift_parallel_threshold=8)
GREEDY = dict(max_tokens=8)
SEEDED = dict(max_tokens=8, temperature=0.8, seed=3,
              repetition_penalty=1.2, presence_penalty=0.5)
CHOICES = ["river stone", "rain", "snow", "star"]
DRAFTER = dict(method="arctic", num_speculative_tokens=3)


# --------------------------------------------------------------------- #
# The channel
# --------------------------------------------------------------------- #

def _pair(heartbeat=True):
    port = free_port()
    leader = LeaderChannel(1, port, bind_host="127.0.0.1",
                           accept_timeout=30.0)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "ch", FollowerChannel("127.0.0.1", port, connect_timeout=30,
                              heartbeat=heartbeat)))
    t.start()
    leader.wait_connected()
    t.join(30)
    return leader, box["ch"]


def _wait(cond, deadline_s=10.0):
    end = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < end:
        time.sleep(0.02)
    return cond()


def test_follower_disconnect_detected():
    leader, follower = _pair()
    failures = []
    leader.start_watchdog(lambda i, r: failures.append((i, r)), timeout=30)
    leader.broadcast({"kind": "dispatch", "x": np.arange(3)})
    got = follower.recv()
    assert got["kind"] == "dispatch" and got["x"].tolist() == [0, 1, 2]
    follower.close()            # a follower process that died
    assert _wait(lambda: failures)
    assert failures == [(0, "disconnected")]
    assert leader.failed == "follower 0 disconnected"
    leader.close()


def test_heartbeat_timeout_detected():
    """A follower that stays connected but sends no heartbeat is
    wedged."""
    leader, follower = _pair(heartbeat=False)
    failures = []
    leader.start_watchdog(lambda i, r: failures.append((i, r)), timeout=0.5)
    assert _wait(lambda: failures)
    assert failures == [(0, "heartbeat timeout")]
    follower.close()
    leader.close()


def test_closed_leader_stops_then_loses_the_follower():
    """``close`` broadcasts ``stop``; a follower reading past it sees
    the channel gone (``ConnectionError``)."""
    leader, follower = _pair()
    leader.close()
    assert follower.recv() == {"kind": "stop"}
    with pytest.raises(ConnectionError):
        follower.recv()
    follower.close()


@pytest.mark.parametrize("device,cards,local,want", [
    ("cpu", 0, None, "gloo"),
    ("cuda:0", 1, None, "gloo"),        # two ranks share the one card
    ("cuda:1", 2, None, "nccl"),        # a card each
    ("cuda:0", 8, "16", "gloo"),        # 16 ranks a host, 8 cards
])
def test_backend_follows_the_cards(monkeypatch, device, cards, local, want):
    """gloo on the CPU and for ranks that share a card, NCCL when every
    rank of the host has its own: each rank derives the same answer."""
    from arcticinference_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert multihost.choose_backend(torch.device(device), 2) == want


def test_rank_device_needs_a_card_unless_asked():
    from arcticinference_tpu_torch.parallel import multihost

    assert multihost.rank_device("cpu", 2, 1) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.rank_device(None, 2, 1)


# --------------------------------------------------------------------- #
# Served worlds
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def world():
    w = World(4, backend="gloo", timeout_s=120, threads=1)
    yield w
    w.close()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tests.torch_shared import tiny_trained_checkpoint

    d, heldout = tiny_trained_checkpoint(tmp_path_factory)
    prompts = [[int(t) for t in heldout[s:s + n]]
               for s, n in ((0, 12), (40, 30), (120, 20), (200, 9))]
    return str(d), prompts


@pytest.fixture(scope="module")
def single(trained):
    """The single device's runs: greedy, seeded and guided (the guided
    request on the pipelined step's device pool)."""
    from arcticinference_tpu_torch.serving.structured import (
        make_guided_decoder)

    path, prompts = trained
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    llm = LLM(tasks.engine_config(path), device="cpu")
    out = {"greedy": [o.token_ids for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**GREEDY))]}
    dec = make_guided_decoder(llm.tokenizer, {"choice": CHOICES},
                              vocab_size=llm.engine.arch.vocab_size)
    out["guided"] = llm.generate(
        prompt_token_ids=[prompts[2]], sampling_params=SamplingParams(
            max_tokens=8, guided=dec))[0].token_ids
    llm.close()
    torch.set_num_threads(saved)
    return out


def _completion(prompt, **kw):
    return ("/v1/completions", dict(prompt_token_ids=prompt, **kw))


def _run(world, path, par, requests, offline, **kw):
    from arcticinference_tpu_torch.config import ParallelConfig

    n = ParallelConfig(**par).world_size
    members = list(range(n)) if n < 4 else None
    return world.run(tasks.serve_session, path, par, free_port(), requests,
                     offline, members=members, ranks=range(n), **kw)


def _check_mirror(res):
    """Every follower replayed the leader's dispatches and fused steps to
    the same output digest (served, then offline), and got ``stop``."""
    lead, followers = res[0], res[1:]
    fused = lead["width_stats"]["wide"] + lead["width_stats"]["narrow"] \
        if lead["width_stats"] else 0
    for f in followers:
        assert f["dispatches"] == lead["dispatches"] > 0
        assert f["digest"] == lead["digest"]
        assert f["replayed"].get("fused", 0) == fused
        assert f["replayed"]["stop"] == 1
        assert f["offline"]["digest"] == lead["offline"]["digest"]
        assert f["offline"]["tokens"] == lead["offline"]["tokens"]
    assert lead["sent"]["dispatch"] == lead["dispatches"]
    assert not lead["dead"]


def _tokens(answer):
    status, body = answer
    assert status == 200, body
    return body["choices"][0]["token_ids"]


@pytest.fixture(scope="module", params=["tp2", "shift"])
def served(request, world, trained):
    """Plain greedy requests each alone, a warm repeat, a seeded and
    penalised one and a guided one through the served world; echo
    scoring (refused); then ``LLM.generate`` of the same on the world."""
    path, prompts = trained
    par = TP2 if request.param == "tp2" else SHIFT
    requests = [_completion(p, **GREEDY) for p in prompts]
    requests += [_completion(prompts[0], **GREEDY),
                 _completion(prompts[1], **SEEDED),
                 _completion(prompts[2], max_tokens=8,
                             guided_choice=CHOICES),
                 _completion(prompts[3], echo=True, max_tokens=0)]
    offline = [(prompts, GREEDY), ([prompts[1]], SEEDED)]
    res = _run(world, path, par, requests, offline, refusals=True)
    return request.param, res


def test_served_greedy_tokens_match_world_and_single(served, single):
    name, res = served
    answers = res[0]["answers"]
    got = [_tokens(a) for a in answers[:4]]
    assert got == single["greedy"]
    assert got == res[0]["offline"]["tokens"][0]
    # The warm second request: the same tokens again.
    assert _tokens(answers[4]) == single["greedy"][0]
    _check_mirror(res)
    # A decode step's broadcast: one message per dispatch, its bytes.
    assert 0 < res[0]["last_bytes"]["dispatch"] < 64 * 1024


def test_served_seeded_penalised_request_matches_world(served):
    _, res = served
    assert _tokens(res[0]["answers"][5]) == \
        res[0]["offline"]["tokens"][1][0]


def test_served_guided_request_matches_single(served, single):
    _, res = served
    toks = _tokens(res[0]["answers"][6])
    assert toks == single["guided"]


def test_served_mesh_refuses_unmirrored_routes(served):
    """Echo scoring answers 400; scoring, full prompt logits and causal
    encode raise on the leader, each at once (before any collective)."""
    _, res = served
    status, body = res[0]["answers"][7]
    assert status == 400 and "served mesh" in body["error"]
    assert res[0]["seconds"][7] < 10
    for name, err in res[0]["refusals"].items():
        assert err.startswith("NotImplementedError") and \
            "served mesh" in err, (name, err)


def test_served_suffix_decoding_runs_the_fused_loop(world, trained, single):
    """The suffix cache seeded with the expected continuations: the
    served shift world runs fused steps with drafts, each replayed on
    every follower, and keeps the single device's tokens."""
    path, prompts = trained
    warm = [t for p, o in zip(prompts, single["greedy"]) for t in p + o]
    requests = [_completion(p, **GREEDY) for p in prompts]
    res = _run(world, path, dict(SHIFT, shift_parallel_threshold=16),
               requests, [(prompts, GREEDY)], spec=dict(method="suffix"),
               warm=warm)
    assert [_tokens(a) for a in res[0]["answers"]] == single["greedy"]
    assert res[0]["offline"]["tokens"][0] == single["greedy"]
    lead = res[0]
    assert lead["width_stats"]["wide"] + lead["width_stats"]["narrow"] > 0
    assert lead["spec"]["num_drafts"] > 0
    assert lead["sent"]["fused"] > 0 and lead["sent"]["fused_exit"] > 0
    _check_mirror(res)


def test_served_dp_mesh_matches_generate(world, trained, single):
    """In-engine dp on a served mesh (dp 2 x tp 2; the JAX
    ``test_multihost_dp_engine``): the leader broadcasts each step's
    dp-layout arrays and every follower uploads its own group's slice.
    Each request alone and a burst of all four (both dp groups at once)
    return ``LLM.generate``'s tokens on the same world and the single
    device's; every follower replays every dispatch to the leader's
    digest."""
    path, prompts = trained
    requests = [_completion(p, **GREEDY) for p in prompts]
    res = _run(world, path, dict(data_parallel_size=2, **TP2), requests,
               [(prompts, GREEDY)], burst=requests)
    assert [_tokens(a) for a in res[0]["answers"]] == single["greedy"]
    assert [_tokens(a) for a in res[0]["burst_answers"]] == \
        single["greedy"]
    assert res[0]["offline"]["tokens"][0] == single["greedy"]
    _check_mirror(res)


@pytest.mark.parametrize("par,fused", [(TP2, True), (SHIFT, False)],
                         ids=["tp2-fused", "shift-sync"])
def test_drafter_on_a_mesh(world, trained, single, par, fused):
    """An Arctic MLP drafter (random weights, a copy on every rank) in the
    fused loop (tp 2) and after each synchronous step (shift): served
    and through ``LLM.generate``, greedy tokens stay the non-speculative
    single device's, and every rank counts the same drafts."""
    path, prompts = trained
    requests = [_completion(p, **GREEDY) for p in prompts[:2]]
    res = _run(world, path, par, requests, [(prompts, GREEDY)],
               spec=dict(DRAFTER, enable_fused_decode=fused))
    assert [_tokens(a) for a in res[0]["answers"]] == single["greedy"][:2]
    assert res[0]["offline"]["tokens"][0] == single["greedy"]
    assert res[0]["spec"]["num_drafts"] > 0
    assert res[0]["sent"].get("fused" if fused else "propose", 0) > 0
    for r in res:
        assert r["offline"]["spec"] == res[0]["offline"]["spec"]
        assert r["offline"]["spec"][0]["num_drafts"] > 0
    for f in res[1:]:
        assert f["replayed"].get("propose", 0) == \
            res[0]["sent"].get("propose", 0)
    _check_mirror(res)


def test_tied_drafter_gathers_the_cut_head(world, trained, tmp_path):
    """A distilled tied drafter on tp 2 reads each rank's column piece of
    the LM head and gathers its logits: its drafts equal the single
    device's, whose head is whole."""
    from arcticinference_tpu_torch.spec import distill

    path, prompts = trained
    params, arch = distill.init_tied_drafter((128, 256), n_predict=3,
                                             seed=1)
    distill.save_distilled(tmp_path / "tied", params, arch)
    spec = dict(method="arctic", model=str(tmp_path / "tied"))
    rng = np.random.default_rng(0)
    rows = (rng.integers(0, 256, 8).astype(np.int32),
            rng.standard_normal((8, 128)).astype(np.float32))
    res = _run(world, path, TP2, [_completion(prompts[0], **GREEDY)],
               [([prompts[0]], GREEDY)], spec=spec, drafter_rows=rows)
    llm = LLM(tasks.engine_config(path, spec=spec), device="cpu")
    d = llm.engine._drafter
    want = d.generate(d.params, torch.from_numpy(rows[0]),
                      torch.from_numpy(rows[1])).numpy().tolist()
    llm.close()
    for r in res:
        assert r["offline"]["drafts"] == want
    _check_mirror(res)


# --------------------------------------------------------------------- #
# The command line: one process per rank
# --------------------------------------------------------------------- #

def _serve_cmd(cfg_path, pid, coord, chan, port):
    return [sys.executable, "-m", "arcticinference_tpu_torch", "serve",
            "--device", "cpu", "--config", str(cfg_path),
            "--tensor-parallel-size", "2", "--host", "127.0.0.1",
            "--port", str(port), "--multihost-num-processes", "2",
            "--multihost-process-id", str(pid),
            "--multihost-coordinator", f"127.0.0.1:{coord}",
            "--multihost-leader", "127.0.0.1",
            "--multihost-channel-port", str(chan)]


class CliMesh:
    """A leader and a follower of ``serve --multihost-*`` (tp 2, CPU)."""

    def __init__(self, cfg_path, logdir, name):
        self.port = free_port()
        coord, chan = free_port(), free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        self.logs = [open(Path(logdir) / f"{name}{i}.log", "w")
                     for i in range(2)]
        self.procs = [subprocess.Popen(
            _serve_cmd(cfg_path, i, coord, chan, self.port), cwd=REPO,
            env=env, stdout=self.logs[i], stderr=subprocess.STDOUT)
            for i in range(2)]
        self.url = f"http://127.0.0.1:{self.port}"

    async def health(self):
        async with http.get(self.url + "/health", timeout=10) as r:
            return r.status, json.loads(await r.read())

    def wait_healthy(self, deadline_s=180):
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            if any(p.poll() is not None for p in self.procs):
                break
            try:
                if asyncio.run(self.health())[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.3)
        raise AssertionError("the served mesh did not come up: "
                             + self.log_text())

    def log_text(self):
        for f in self.logs:
            f.flush()
        return "\n".join(Path(f.name).read_text()[-3000:]
                         for f in self.logs)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
        for f in self.logs:
            f.close()


@pytest.fixture(scope="module")
def cli_meshes(trained, tmp_path_factory):
    """Two served tp-2 meshes of two processes each, started at once."""
    path, _ = trained
    d = tmp_path_factory.mktemp("cli_mesh")
    cfg = d / "cfg.json"
    cfg.write_text(json.dumps(dict(
        model=dict(model=path, dtype="float32", max_model_len=256),
        cache=dict(block_size=8, num_blocks=128),
        scheduler=dict(max_num_seqs=4, max_num_batched_tokens=64))))
    meshes = [CliMesh(cfg, d, name) for name in ("a", "b")]
    try:
        for m in meshes:
            m.wait_healthy()
        yield meshes
    finally:
        for m in meshes:
            m.close()


def test_cli_serves_a_mesh(cli_meshes, trained, single):
    mesh = cli_meshes[0]
    _, prompts = trained
    ans = asyncio.run(tasks._post(mesh.url + "/v1/completions",
                                  dict(prompt_token_ids=prompts[0],
                                       **GREEDY)))
    assert _tokens(ans) == single["greedy"][0], mesh.log_text()


def test_killed_follower_fails_requests_and_health(cli_meshes, trained):
    """The follower dies while a request streams: the stream ends with
    an error and /health answers 503 ``engine_error``, within 60 s."""
    mesh = cli_meshes[0]
    _, prompts = trained
    follower = mesh.procs[1]

    async def go():
        reasons = []
        async with http.post(mesh.url + "/v1/completions", json=dict(
                prompt_token_ids=prompts[0], max_tokens=200,
                ignore_eos=True, stream=True), timeout=60) as r:
            assert r.status == 200
            first = True
            async for line in r.iter_lines():
                if not line.startswith(b"data: {"):
                    continue
                if first:
                    # Freeze the follower mid-request (the leader's next
                    # collective waits on it), then kill it.
                    follower.send_signal(signal.SIGSTOP)
                    follower.kill()
                    first = False
                choice = json.loads(line[6:])["choices"][0]
                if choice.get("finish_reason"):
                    reasons.append(choice["finish_reason"])
        return reasons

    t = time.monotonic()
    reasons = asyncio.run(asyncio.wait_for(go(), 60))
    assert reasons == ["error"], mesh.log_text()
    status, body = asyncio.run(mesh.health())
    assert status == 503 and body["status"] == "engine_error"
    # The watchdog names the follower (the step thread may fail first).
    assert _wait(lambda: "follower 0" in (asyncio.run(mesh.health())[1]
                                          .get("reason") or ""))
    assert time.monotonic() - t < 60


def test_follower_exits_3_when_its_leader_dies(cli_meshes, trained):
    """The leader dies while a request streams (its follower waits in a
    step's collective or on the channel): the follower exits 3."""
    mesh = cli_meshes[1]
    _, prompts = trained
    leader, follower = mesh.procs

    async def go():
        async with http.post(mesh.url + "/v1/completions", json=dict(
                prompt_token_ids=prompts[0], max_tokens=200,
                ignore_eos=True, stream=True), timeout=60) as r:
            async for line in r.iter_lines():
                if line.startswith(b"data: {"):
                    leader.kill()
                    return

    try:
        asyncio.run(asyncio.wait_for(go(), 60))
    except (OSError, EOFError):
        pass          # the killed leader's stream ends abruptly
    assert follower.wait(60) == 3, mesh.log_text()
