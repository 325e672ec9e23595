"""Rank functions of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_engine_parallel.py``).

They run inside the ranks of a ``parallel.world.World`` (CPU, gloo), so
this module imports neither jax nor the JAX package: arguments and
results cross the process boundary as numpy arrays and plain data.  A
task given ``members`` runs on that subgroup of the world.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.config import (CacheConfig, EngineConfig,
                                              ModelConfig, ParallelConfig,
                                              SchedulerConfig,
                                              SpeculativeConfig)
from arcticinference_tpu_torch.engine.llm import LLM
from arcticinference_tpu_torch.engine.request import SamplingParams
from arcticinference_tpu_torch.models.loader import resolve_model
from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear
from arcticinference_tpu_torch.ops.kv_cache import (KVCacheSpec,
                                                    allocate_kv_cache)
from arcticinference_tpu_torch.parallel import mesh as mesh_lib
from arcticinference_tpu_torch.parallel.ulysses import make_sharded_forward
from arcticinference_tpu_torch.parallel.world import subgroup


def _group(members):
    return None if members is None else subgroup(members)


# --------------------------------------------------------------------- #
# Sharded forward
# --------------------------------------------------------------------- #

def sharded_forward(module_name: str, arch_kw: dict, params: dict,
                    par_kw: dict, mode, steps: list, kv_kw: dict,
                    members=None):
    """The port's sharded forward on this rank over the steps' inputs
    (numpy dicts) in turn, on one cache, from the global port ``params``;
    ``mode`` is one mode or one per step.  Returns, per step, the hidden
    rows and this rank's cache."""
    import importlib

    module = importlib.import_module(
        f"arcticinference_tpu_torch.models.{module_name}")
    arch = module.Arch(**arch_kw)
    cfg = ParallelConfig(**par_kw)
    mesh = mesh_lib.build_mesh(cfg, _group(members))
    params = mesh_lib.shard_params(params, mesh, mesh_lib.specs_of(module))
    layout = getattr(module, "mesh_layout", None)
    if layout is not None:
        # SwiftKV: the later layers' layout, fused as the runner fuses
        # them (its first layers left unfused).
        params = module.fuse_params(layout(params, arch, mesh), None)
    heads = mesh_lib.kv_cache_heads(arch.num_kv_heads, mesh)[0]
    kv = allocate_kv_cache(KVCacheSpec(
        num_layers=arch.num_layers, num_kv_heads=heads,
        head_dim=arch.head_dim, dtype=torch.float32, **kv_kw), "cpu")
    modes = [mode] if isinstance(mode, str) else mode
    out = []
    for step, m in zip(steps, modes * len(steps)):
        fn = make_sharded_forward(module, arch, mesh, m,
                                  attn_impl=module.plain_attn)
        inputs = {k: torch.from_numpy(np.asarray(v)) for k, v in
                  step.items()}
        kv, h = fn(params, kv, inputs)
        out.append((h.numpy().copy(), kv.numpy().copy()))
    return out


# --------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------- #

_LLAMA_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj"}


def _layer_tensors(lay: dict, i: int, layer: int, names: dict) -> dict:
    """HF tensors of layer ``i`` of the stacked ``lay`` as model layer
    ``layer``: norms, the ``names`` weights transposed, q/k/v biases."""
    pre = f"model.layers.{layer}."
    t = {pre + "input_layernorm.weight": lay["input_norm"][i],
         pre + "post_attention_layernorm.weight": lay["post_norm"][i]}
    for key, name in names.items():
        t[pre + name + ".weight"] = lay[key][i].t()
    for key, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
        if key in lay:
            t[pre + f"self_attn.{name}.bias"] = lay[key][i]
    return t


def write_checkpoint(path: str, hf: dict, seed: int = 0) -> None:
    """A random float32 HF checkpoint (``config.json`` and
    ``model.safetensors``) of the architecture ``hf`` names (Llama,
    Llama-SwiftKV or Mixtral) from the port's ``init_params``, which both
    packages' loaders read."""
    from arcticinference_tpu_torch.models import llama, llama_swiftkv, mixtral

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    kind = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    module = {"LlamaSwiftKVForCausalLM": llama_swiftkv,
              "MixtralForCausalLM": mixtral}.get(kind, llama)
    arch = module.Arch.from_hf_config(hf)
    gen = torch.Generator().manual_seed(seed)
    p = module.init_params(arch, gen, torch.float32, device="cpu")
    t = {"model.embed_tokens.weight": p["embed"],
         "model.norm.weight": p["final_norm"]}
    if "lm_head" in p:                        # untied
        t["lm_head.weight"] = p["lm_head"].t()
    if module is llama_swiftkv:
        ka = arch.num_key_value_layers
        for i in range(ka):
            t.update(_layer_tensors(p["layers_a"], i, i, _LLAMA_NAMES))
        names_b = dict(_LLAMA_NAMES, wq="self_attn.q_proj_swiftkv")
        del names_b["wk"], names_b["wv"]
        for i in range(arch.num_swift_layers):
            t.update(_layer_tensors(p["layers_b"], i, ka + i, names_b))
            t[f"model.layers.{ka + i}.self_attn.kv_proj_swiftkv.weight"] = \
                torch.cat([p["wk_swift"][i].t(), p["wv_swift"][i].t()])
        t["model.norm_swiftkv.weight"] = p["norm_swiftkv"]
    elif module is mixtral:
        lay = p["layers"]
        attn = {k: _LLAMA_NAMES[k] for k in ("wq", "wk", "wv", "wo")}
        experts = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}
        for i in range(arch.num_layers):
            t.update(_layer_tensors(lay, i, i, attn))
            pre = f"model.layers.{i}.block_sparse_moe."
            t[pre + "gate.weight"] = lay["w_router"][i].t()
            for key, name in experts.items():
                for e in range(arch.num_experts):
                    t[pre + f"experts.{e}.{name}.weight"] = lay[key][i][e].t()
    else:
        for i in range(arch.num_layers):
            t.update(_layer_tensors(p["layers"], i, i, _LLAMA_NAMES))
    st_io.save_file({k: v.contiguous() for k, v in t.items()},
                    path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(hf))


def engine_config(model: str, par: dict | None = None,
                  quantization=None, spec: dict | None = None,
                  num_blocks=128) -> EngineConfig:
    return EngineConfig(
        model=ModelConfig(model=model, dtype="float32", max_model_len=256,
                          quantization=quantization),
        cache=CacheConfig(block_size=8, num_blocks=num_blocks),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
        parallel=ParallelConfig(**(par or {})),
        speculative=None if spec is None else SpeculativeConfig(**spec))


def _leaves(tree, path=()):
    """(path, tensor) of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, QuantizedLinear):
        yield path, tree.weight
        yield path + ("scale",), tree.scale
    else:
        yield path, tree


def run_engine(model: str, par: dict | None, prompts, max_tokens: int = 10,
               quantization=None, spec: dict | None = None,
               unfused: bool = False, members=None, logits: bool = True,
               warm=None, sampling: dict | None = None,
               pipeline=None, responses: dict | None = None,
               guided: str | None = None) -> dict:
    """``LLM.generate`` on this rank (``max_tokens``: one count, or one
    per prompt; ``sampling``: more ``SamplingParams``; ``pipeline``
    False: the synchronous step;
    ``unfused``: the model module without ``fuse_params``, so the runner
    keeps q/k/v and gate/up apart; ``warm`` / ``responses``: sequences
    the suffix cache holds first; ``guided``: a regex each request is
    guided by, a decoder over the checkpoint's tokenizer); returns its
    tokens (and logprobs), the modes its forwards ran, the step kinds,
    the fused loop's counts, the layer keys and leaf shapes it holds (the
    first stack's, and every leaf's), the leaves that are not contiguous,
    whether it allocated the grammar pool, its cache's shape, and
    (``logits``) the prompt logits of each prompt followed by its
    tokens."""
    with contextlib.ExitStack() as stack:
        if unfused:
            stack.enter_context(mock.patch.object(
                resolve_model(ModelConfig(model=model))[0], "fuse_params",
                None))
        llm = LLM(engine_config(model, par, quantization, spec),
                  device="cpu", group=_group(members))
        eng = llm.engine
        if warm:
            eng._suffix_cache.update_response("warm", warm)
        for rid, seq in (responses or {}).items():
            eng._suffix_cache.update_response(rid, seq)
        if pipeline is not None:
            eng._pipeline = pipeline
        extra = dict(sampling or {})
        params = (SamplingParams(max_tokens=max_tokens, **extra)
                  if isinstance(max_tokens, int) else
                  [SamplingParams(max_tokens=m, **extra)
                   for m in max_tokens])
        if guided is not None:
            from arcticinference_tpu_torch.serving.structured import (
                make_guided_decoder)

            params = [SamplingParams(max_tokens=max_tokens,
                                     guided=make_guided_decoder(
                                         llm.tokenizer, {"regex": guided}),
                                     **extra) for _ in prompts]
        outs = llm.generate(prompt_token_ids=prompts,
                            sampling_params=params)
        tokens = [o.token_ids for o in outs]
        rp = eng.runner.params
        first = rp["layers"] if "layers" in rp else rp["layers_a"]
        res = {
            "tokens": tokens,
            "logprobs": [o.logprobs for o in outs],
            "mode_steps": dict(eng.runner.mode_steps),
            "fn_modes": sorted({k[3] for k in eng.runner._step_fns}),
            "width_stats": eng.width_stats,
            "step_kinds": sorted(eng.step_times.summary()),
            "layers": {k: tuple(v.shape) for k, v in first.items()},
            "scales": {k: tuple(v.scale.shape) for k, v in first.items()
                       if isinstance(v, QuantizedLinear)},
            "shapes": {"/".join(p): tuple(v.shape)
                       for p, v in _leaves(rp)},
            "strided": ["/".join(p) for p, v in _leaves(rp)
                        if not v.is_contiguous()],
            "guided_pool": eng.runner._guided_pool is not None,
            "kv_shape": tuple(eng.runner.kv.shape),
            "spec": eng.spec_stats.summary(),
        }
        if logits:
            res["logits"] = [eng.prompt_logits(list(p) + t[:-1])
                             for p, t in zip(prompts, tokens)]
        llm.close()
        return res


def stage_pages(model: str, par: dict | None, prompt, members=None) -> dict:
    """The KV pages of ``prompt``'s prefill on this rank (the engine's
    ``prompt_logits``, in blocks borrowed from a fresh cache: 1, 2, ...),
    float32: ``pages`` [this stage's layers, blocks, 2, Bs, heads*D], with
    the global ``layers`` and the model's kv heads the rank holds
    (``heads``: count, first)."""
    llm = LLM(engine_config(model, par), device="cpu", group=_group(members))
    eng = llm.engine
    eng.prompt_logits(list(prompt))
    runner = eng.runner
    nblk = -(-len(prompt) // runner.block_size)
    heads = (runner.cache_kv_heads, 0)
    if eng.mesh is not None:
        heads = mesh_lib.kv_cache_heads(eng.arch.num_kv_heads, eng.mesh)
    res = dict(layers=list(runner.stage_layers), heads=heads,
               pages=runner.kv[:, 1:1 + nblk].float().numpy().copy())
    llm.close()
    return res


def build_error(model: str, par: dict, members=None, **kw) -> str:
    """The error ``LLM`` raises on this rank (type: message), or ''."""
    try:
        LLM(engine_config(model, par, **kw), device="cpu",
            group=_group(members))
    except Exception as e:  # noqa: BLE001 (the test reads the error)
        return f"{type(e).__name__}: {e}"
    return ""


#: Extra widths of the other families' random configs.
_FAMILY_HF = {"llama": {}, "llama_swiftkv": dict(num_key_value_layers=1),
              "mixtral": dict(num_local_experts=4, num_experts_per_tok=2)}


def random_config(par: dict | None, quantization=None,
                  family: str = "llama") -> EngineConfig:
    """A random-weight model of ``family`` (the loader's ``init_params``),
    GQA 8 / 4."""
    cfg = engine_config(family, par, quantization)
    cfg.model.hf_overrides = dict(vocab_size=96, hidden_size=64,
                                  intermediate_size=128, num_hidden_layers=2,
                                  num_attention_heads=8,
                                  num_key_value_heads=4, head_dim=8,
                                  **_FAMILY_HF[family])
    return cfg


def rank_params(par: dict, quantization=None, members=None,
                family: str = "llama") -> dict:
    """This rank's runner parameters from random weights cut as drawn,
    as numpy (a quantized leaf as (weight, scale), fp8 through
    float32)."""
    llm = LLM(random_config(par, quantization, family), device="cpu",
              group=_group(members))

    def leaf(x):
        if isinstance(x, QuantizedLinear):
            return (leaf(x.weight), leaf(x.scale))
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return x.float().numpy() if x.dtype.itemsize < 4 else x.numpy()

    return leaf(llm.engine.runner.params)


def rank_num_blocks(model: str, par: dict, members=None) -> int:
    """The cache blocks this rank sized from its memory."""
    llm = LLM(engine_config(model, par, num_blocks=None), device="cpu",
              group=_group(members))
    return llm.engine.runner.num_blocks




# --------------------------------------------------------------------- #
# A served mesh (parallel/multihost.py)
# --------------------------------------------------------------------- #

async def _post(url: str, body: dict, timeout: float = 60.0):
    """(status, JSON body) of one POST through the port's HTTP client."""
    from arcticinference_tpu_torch.serving import http

    async with http.post(url, json=body, timeout=timeout) as r:
        return r.status, json.loads(await r.read())


def _refusals(eng) -> dict:
    """The error of each engine entry a served mesh refuses."""
    out = {}
    for name, call in (("score", lambda: eng.score([[1, 2, 3]])),
                       ("prompt_logits", lambda: eng.prompt_logits([1, 2])),
                       ("encode", lambda: eng.encode([[1, 2, 3]]))):
        try:
            call()
            out[name] = ""
        except Exception as e:  # noqa: BLE001 (the test reads the error)
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _offline(cfg, group, offline: list, drafter_rows=None) -> dict:
    """``LLM.generate`` of each (prompts, sampling) of ``offline`` on this
    rank of the world, with a digest of its output vectors; with
    ``drafter_rows`` ((last tokens, hidden rows) as numpy) also the
    drafter's chain on them."""
    llm = LLM(cfg, device="cpu", group=group)
    eng = llm.engine
    eng.runner.digest = torch.zeros((), dtype=torch.int64)
    res = {"tokens": [], "spec": []}
    for prompts, sampling in offline:
        outs = llm.generate(prompt_token_ids=prompts,
                            sampling_params=SamplingParams(**sampling))
        res["tokens"].append([o.token_ids for o in outs])
        res["spec"].append(eng.spec_stats.summary())
    res["digest"] = int(eng.runner.digest)
    if drafter_rows is not None:
        tok, hid = (torch.from_numpy(np.asarray(x)) for x in drafter_rows)
        res["drafts"] = eng._drafter.generate(eng._drafter.params, tok,
                                              hid).numpy().tolist()
    llm.close()
    return res


def serve_session(model: str, par: dict, channel_port: int,
                  requests: list, offline: list, members=None,
                  spec: dict | None = None, warm=None,
                  refusals: bool = False, drafter_rows=None,
                  burst: list | None = None) -> dict:
    """One served mesh on this rank, then ``LLM.generate`` on the same
    world.  Rank 0 builds the server, waits for its followers, attaches
    the channel and sends ``requests`` ((path, body), each alone, in
    order), then ``burst`` (the same, all at once), through HTTP; the
    other ranks replay its steps
    (``follower_serve``).  Each rank returns what it saw: the leader its
    answers, step counts, the channel's message counts and bytes and (with
    ``refusals``) the errors of the refused engine entries; a follower
    its replayed message counts; both their runner's dispatches and
    output digest; then :func:`_offline` of ``offline``."""
    import asyncio
    import time

    import torch.distributed as dist

    from arcticinference_tpu_torch.engine.engine import LLMEngine
    from arcticinference_tpu_torch.parallel import multihost
    from arcticinference_tpu_torch.serving.openai_server import OpenAIServer

    group = _group(members)
    n = dist.get_world_size(group)
    cfg = engine_config(model, par, spec=spec)
    res = {}
    if dist.get_rank(group) == 0:
        server = OpenAIServer(cfg, device="cpu", group=group)
        eng = server.engine.engine
        eng.runner.digest = torch.zeros((), dtype=torch.int64)
        if warm:
            eng._suffix_cache.update_response("warm", warm)
        channel = multihost.LeaderChannel(n - 1, channel_port,
                                          bind_host="127.0.0.1",
                                          accept_timeout=60)
        channel.wait_connected()
        server.engine.attach_channel(channel)
        loop = asyncio.new_event_loop()
        try:
            port = loop.run_until_complete(server.app.start("127.0.0.1", 0))
            url = f"http://127.0.0.1:{port}"
            answers, seconds = [], []
            for path, body in requests:
                t = time.perf_counter()
                answers.append(loop.run_until_complete(
                    _post(url + path, body)))
                seconds.append(time.perf_counter() - t)
            if burst:
                async def at_once():
                    return await asyncio.gather(
                        *(_post(url + path, body) for path, body in burst))

                res["burst_answers"] = list(loop.run_until_complete(
                    at_once()))
            if refusals:
                res["refusals"] = _refusals(eng)
            res.update(
                answers=answers, seconds=seconds,
                width_stats=eng.width_stats, spec=eng.spec_stats.summary(),
                dispatches=eng.runner.dispatches,
                digest=int(eng.runner.digest), sent=dict(channel.sent),
                last_bytes=dict(channel.last_bytes),
                dead=server.engine.dead)
            # Stopping the app closes the engine and its channel: the
            # followers get ``stop``.
            loop.run_until_complete(server.app.stop())
        finally:
            server.engine.close()
            loop.close()
    else:
        eng = LLMEngine(cfg, device="cpu", group=group)
        eng.runner.digest = torch.zeros((), dtype=torch.int64)
        channel = multihost.FollowerChannel("127.0.0.1", channel_port,
                                            connect_timeout=60)
        try:
            res["replayed"] = multihost.follower_serve(eng, channel)
        finally:
            channel.close()
        res.update(dispatches=eng.runner.dispatches,
                   digest=int(eng.runner.digest))
        eng.close()
    res["offline"] = _offline(cfg, group, offline, drafter_rows)
    return res
