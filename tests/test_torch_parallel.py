"""The port's mesh (``arcticinference_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
ranks run in one spawned gloo world of 4 processes (module-scoped, one
intra-op thread each; 2-rank layouts run on a subgroup of it).

- Without ranks: the interleaved fusion, every rank's parameter cut, the
  shift re-slice (with and without kv-head replication) and the cache's
  head slices equal the JAX arrays exactly (each JAX device's
  ``addressable_shards`` data at the same ``(sp, tp)``); ``_choose_mode``
  gives the JAX runner's table.
- In the world: the sharded forward of both modes at dp = 1 against the
  JAX sharded and single forwards (hidden and the rank's cache slice, at
  the JAX tests' tolerances), the KV layout the two modes share, an SP
  prefill followed by a shift decode step, quantized weights, the
  Qwen2 (q/k/v bias cut) and Qwen3 (per-head q / k norms) families, and
  Llama-SwiftKV (the later layers in the shift layout) and Mixtral
  (expert parallelism) at (sp, tp) of (1, 4) and (2, 2) in both modes
  against the JAX single forward at 5e-4 (``tests/test_moe.py``'s
  bound; its (2, 4) and (1, 8) cases need 8 ranks).
- Without ranks: the expert-parallel capacity window, each shard's
  ``_moe_mlp`` summed, against the JAX ``shard_map``'d one at tp 4 on a
  balanced router (exact against dropless) and on a skewed one whose
  windows drop rows (the same rows).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcticinference_tpu import config as jcfg
from arcticinference_tpu.engine.runner import ModelRunner as JaxRunner
from arcticinference_tpu.models import llama as jllama
from arcticinference_tpu.models import llama_swiftkv as jsw
from arcticinference_tpu.models import mixtral as jmix
from arcticinference_tpu.models import qwen2 as jqwen2
from arcticinference_tpu.models import qwen3 as jqwen3
from arcticinference_tpu.ops import fp8 as jfp8
from arcticinference_tpu.ops.kv_cache import (KVCacheSpec as JaxKVSpec,
                                              allocate_kv_cache as jalloc)
from arcticinference_tpu.parallel import mesh as jmesh
from arcticinference_tpu.parallel import ulysses as julysses
from arcticinference_tpu_torch import config as tcfg
from arcticinference_tpu_torch.engine.runner import ModelRunner
from arcticinference_tpu_torch.models import llama as tllama
from arcticinference_tpu_torch.models import mixtral as tmix
from arcticinference_tpu_torch.ops import fp8 as tfp8
from arcticinference_tpu_torch.parallel import mesh as tmesh
from arcticinference_tpu_torch.parallel.ulysses import ParallelContext
from arcticinference_tpu_torch.parallel.world import World
from arcticinference_tpu_torch.weights import params_from_jax

from tests import torch_parallel_tasks as tasks

ARCH_KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=8, num_kv_heads=8, head_dim=16)
ARCH = jllama.LlamaArch(**ARCH_KW)
KV_KW = dict(num_blocks=8, block_size=4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jparams):
    return params_from_jax(np_tree(jparams), "cpu")


def as_np(x):
    """A port leaf as numpy (quantized: (weight, scale)), bit patterns
    compared through float32 for the 8/16-bit float types."""
    if isinstance(x, tfp8.QuantizedLinear):
        return (as_np(x.weight), as_np(x.scale))
    if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return x.float().numpy()
    return x.numpy()


def jax_np(x):
    if isinstance(x, jfp8.QuantizedLinear):
        return (jax_np(x.weight), jax_np(x.scale))
    return _f32(np.asarray(x))


def _f32(a):
    """Floats of any width as float32 (exact), integers as they are."""
    if a.dtype.kind == "f" or a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.astype(np.float32)
    return a


def assert_same(a, b, what=""):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            assert_same(x, y, what)
        return
    a, b = _f32(np.asarray(a)), _f32(np.asarray(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def fake_mesh(cfg: tcfg.ParallelConfig, rank: int) -> tmesh.Mesh:
    """A rank's mesh coordinates without process groups: enough for the
    parameter cuts and the re-slice."""
    return tmesh.Mesh(cfg=cfg, group=None, rank=rank,
                      coords=tmesh.mesh_coords(rank, cfg))


def device_coords(mesh, device) -> tuple[int, int]:
    dp, pp, s, t = np.argwhere(mesh.devices == device)[0]
    return int(s), int(t)


def shards_by_coords(arr, mesh) -> dict:
    return {device_coords(mesh, sh.device): np.asarray(sh.data)
            for sh in arr.addressable_shards}


def quantize(jparams, quant):
    return jparams if quant is None else jllama.quantize_params(jparams,
                                                                quant)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(ARCH, jax.random.PRNGKey(1), jnp.float32)


# --------------------------------------------------------------------- #
# Without ranks
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("fmt", ["bf16", "fp8", "int8"])
@pytest.mark.parametrize("interleave", [2, 4])
def test_fuse_quantized_interleave_matches_jax(fmt, interleave):
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal((2, 32, n)).astype(np.float32) * 0.05
             for n in (64, 16, 16)]
    if fmt == "bf16":
        jparts = [jnp.asarray(p, jnp.bfloat16) for p in parts]
    else:
        jparts = [jfp8.weight_quantize(jnp.asarray(p), fmt) for p in parts]
    tparts = [params_from_jax({"w": np_tree(p)}, "cpu")["w"]
              for p in jparts]
    want = jfp8.fuse_quantized(jparts, interleave=interleave)
    got = tfp8.fuse_quantized(tparts, interleave=interleave)
    assert_same(as_np(got), jax_np(want))


@pytest.mark.parametrize("interleave", [2, 4])
def test_fuse_params_interleave_matches_jax(interleave):
    """Qwen2's q/k/v biases interleave like the weights."""
    arch = jqwen2.Qwen2Arch(**ARCH_KW, attention_bias=True)
    jp = jqwen2.init_params(arch, jax.random.PRNGKey(2), jnp.float32)
    want = jllama.fuse_params(jp, interleave=interleave)["layers"]
    got = tllama.fuse_params(port_params(jp),
                             interleave=interleave)["layers"]
    assert set(got) == set(want)
    for k in want:
        assert_same(as_np(got[k]), jax_np(want[k]), k)


@pytest.mark.parametrize("quant", [None, "fp8", "int8"])
@pytest.mark.parametrize("sp,tp", [(2, 2), (1, 4)])
def test_shard_params_matches_jax_shards(jparams, sp, tp, quant):
    """Every leaf of every rank, unfused and fused with the runner's
    interleave (tp * sp, shift on), equals the JAX device's shard; and
    fusing a rank's tp piece with ``sp`` equals its piece of the global
    fusion, which is how the port's runner fuses."""
    jcfg_par = jcfg.ParallelConfig(tensor_parallel_size=tp,
                                   ulysses_sequence_parallel_size=sp)
    tcfg_par = tcfg.ParallelConfig(tensor_parallel_size=tp,
                                   ulysses_sequence_parallel_size=sp)
    mesh = jmesh.build_mesh(jcfg_par)
    jp = quantize(jparams, quant)
    trees = {"unfused": jp,
             "fused": jllama.fuse_params(jp, interleave=tp * sp)}
    tp_unfused = port_params(jp)
    for name, tree in trees.items():
        placed = jmesh.shard_params(tree, mesh)
        tparams = port_params(tree)
        for rank in range(sp * tp):
            fm = fake_mesh(tcfg_par, rank)
            got = tmesh.shard_params(tparams, fm)
            key = (fm.sp_rank, fm.tp_rank)

            def walk(jt, tt, path):
                if isinstance(jt, dict):
                    assert set(jt) == set(tt), path
                    for k in jt:
                        walk(jt[k], tt[k], path + (k,))
                    return
                if isinstance(jt, jfp8.QuantizedLinear):
                    assert_same(as_np(tt.weight),
                                shards_by_coords(jt.weight, mesh)[key],
                                path)
                    assert_same(as_np(tt.scale),
                                shards_by_coords(jt.scale, mesh)[key],
                                path)
                    return
                assert_same(as_np(tt), shards_by_coords(jt, mesh)[key],
                            path)

            walk(placed, got, (name,))
            if name == "fused":
                local = tllama.fuse_params(
                    tmesh.shard_params(tp_unfused, fm),
                    interleave=sp)["layers"]
                for k in ("wqkv", "w_gateup"):
                    assert_same(as_np(local[k]), as_np(got["layers"][k]),
                                k)


def _jax_shift_slices(lp, cfg, mesh, hkv):
    """JAX ``layer_params`` in shift mode on every device, as
    {(sp, tp): {key: local piece}}."""
    P = jax.sharding.PartitionSpec
    fused = ("tp", "sp")

    def spec(k, leaf, out):
        col = k in ("wq", "wk", "wv", "w_gate", "w_up")
        ws = (P(None, fused if out else "tp") if col
              else P(fused if out else "tp", None))
        if isinstance(leaf, jfp8.QuantizedLinear):
            ss = (P(fused if out else "tp") if col else P(None))
            return jfp8.QuantizedLinear(ws, ss)
        return ws

    pctx = julysses.ParallelContext(cfg, "shift", num_kv_heads=hkv,
                                    head_dim=ARCH.head_dim)
    in_specs = ({k: spec(k, v, False) for k, v in lp.items()},)
    out_specs = {k: spec(k, v, True) for k, v in lp.items()}
    placed = {k: jax.device_put(v, jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s), in_specs[0][k],
        is_leaf=lambda s: isinstance(s, P)))
        for k, v in lp.items()}
    fn = jax.shard_map(lambda x: pctx.layer_params(x), mesh=mesh,
                       in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    out = fn(placed)
    res = {}
    for k, v in out.items():
        parts = ((v.weight, v.scale) if isinstance(v, jfp8.QuantizedLinear)
                 else (v,))
        for i, a in enumerate(parts):
            for c, data in shards_by_coords(a, mesh).items():
                res.setdefault(c, {}).setdefault(k, [None] * len(parts))[
                    i] = data
    return res


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("hkv", [8, 2])
def test_shift_layer_params_match_jax(hkv, quant):
    """The runner's shift re-slice (``reslice_layers`` over the stacked
    tp pieces, once per parameter set) equals JAX's per-layer
    ``layer_params`` on every rank, layer by layer, weight and scale (hkv
    2 over sp*tp 4: head-granular wk / wv); the pieces cut on their out
    axis are contiguous copies, the others contiguous per layer."""
    arch = dataclasses.replace(ARCH, num_kv_heads=hkv)
    jp = quantize(jllama.init_params(arch, jax.random.PRNGKey(4),
                                     jnp.float32), quant)
    keys = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    cfg_j = jcfg.ParallelConfig(tensor_parallel_size=2,
                                ulysses_sequence_parallel_size=2,
                                enable_shift_parallel=True)
    cfg_t = tcfg.ParallelConfig(tensor_parallel_size=2,
                                ulysses_sequence_parallel_size=2,
                                enable_shift_parallel=True)
    mesh = jmesh.build_mesh(cfg_j)
    want = [_jax_shift_slices(
        {k: jax.tree.map(lambda a: a[layer], jp["layers"][k])
         for k in keys}, cfg_j, mesh, hkv)
        for layer in range(arch.num_layers)]
    tlp = port_params({"layers": {k: jax.tree.map(np.asarray,
                                                  jp["layers"][k])
                                  for k in keys}})["layers"]
    specs = tmesh.param_specs()["layers"]
    for rank in range(4):
        fm = fake_mesh(cfg_t, rank)
        got = ParallelContext(fm, "shift", num_kv_heads=hkv,
                              head_dim=arch.head_dim).reslice_layers(
            tmesh.shard_params(tlp, fm, specs))
        for k in keys:
            g = got[k]
            parts = (g.weight, g.scale) if isinstance(
                g, tfp8.QuantizedLinear) else (g,)
            if k in ("wo", "w_down"):
                assert all(p[layer].is_contiguous() for p in parts
                           for layer in range(arch.num_layers)), k
            else:
                assert all(p.is_contiguous() for p in parts), k
            for layer in range(arch.num_layers):
                w = want[layer][(fm.sp_rank, fm.tp_rank)][k]
                for a, b in zip(parts, w):
                    assert_same(as_np(a[layer]), b, (rank, k, layer))


@pytest.mark.parametrize("hkv", [8, 2])
def test_kv_cache_heads_match_jax_layout(hkv):
    """Each JAX device's slice of the sharded forward's cache (SP mode,
    ``max(Hkv, sp*tp)`` heads) is the single forward's cache at the head
    the port's ``kv_cache_heads`` names for that rank."""
    arch = dataclasses.replace(ARCH, num_kv_heads=hkv)
    jp = jllama.init_params(arch, jax.random.PRNGKey(5), jnp.float32)
    inputs = build_inputs()
    single, _ = jllama.forward(jp, arch, jalloc(kv_spec(arch)), inputs)
    cfg_j = jcfg.ParallelConfig(tensor_parallel_size=2,
                                ulysses_sequence_parallel_size=2)
    cfg_t = tcfg.ParallelConfig(tensor_parallel_size=2,
                                ulysses_sequence_parallel_size=2)
    mesh = jmesh.build_mesh(cfg_j)
    fn = julysses.make_sharded_forward(jllama, arch, mesh, cfg_j, "sp")
    kv, _ = jax.jit(fn)(jmesh.shard_params(jp, mesh),
                        jalloc(kv_spec(arch, max(hkv, 4))), inputs)
    d = arch.head_dim
    single = np.asarray(single)
    for (s, t), data in shards_by_coords(kv, mesh).items():
        fm = fake_mesh(cfg_t, s * 2 + t)
        count, first = tmesh.kv_cache_heads(hkv, fm)
        np.testing.assert_allclose(
            data, single[..., first * d:(first + count) * d],
            rtol=2e-4, atol=2e-4)


def test_choose_mode_matches_jax():
    layouts = [dict(), dict(tensor_parallel_size=2),
               dict(ulysses_sequence_parallel_size=2),
               dict(tensor_parallel_size=2, ulysses_sequence_parallel_size=2,
                    enable_shift_parallel=True, shift_parallel_threshold=8),
               dict(ulysses_sequence_parallel_size=4,
                    enable_shift_parallel=True, shift_parallel_threshold=64),
               dict(data_parallel_size=2, tensor_parallel_size=2),
               dict(pipeline_parallel_size=2, tensor_parallel_size=2),
               dict(pipeline_parallel_size=2,
                    ulysses_sequence_parallel_size=2,
                    enable_shift_parallel=True, shift_parallel_threshold=8)]
    for lay in layouts:
        j = types.SimpleNamespace(
            mesh=None if not lay else object(),
            config=types.SimpleNamespace(parallel=jcfg.ParallelConfig(**lay)))
        t = types.SimpleNamespace(
            mesh=None if not lay else object(),
            config=types.SimpleNamespace(parallel=tcfg.ParallelConfig(**lay)))
        for total in (1, 4, 8, 9, 16, 64, 65, 512, 513):
            assert ModelRunner._choose_mode(t, total) == \
                JaxRunner._choose_mode(j, total), (lay, total)


# --------------------------------------------------------------------- #
# In a world of ranks
# --------------------------------------------------------------------- #

def build_inputs():
    """The JAX tests' step: prefills of 11 and 5 tokens (T = 16)."""
    return dict(
        input_ids=jnp.asarray(np.arange(1, 17) % 60, jnp.int32),
        positions=jnp.asarray(
            np.concatenate([np.arange(11), np.arange(5)]), jnp.int32),
        req_idx=jnp.asarray([0] * 11 + [1] * 5, jnp.int32),
        slot_mapping=jnp.asarray(
            np.concatenate([np.arange(4, 15), np.arange(16, 21)]),
            jnp.int32),
        block_tables=jnp.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], jnp.int32),
        seq_lens=jnp.asarray([11, 5], jnp.int32))


def decode_inputs():
    """One decode token of each request after :func:`build_inputs`."""
    return dict(
        input_ids=jnp.asarray([7, 9, 0, 0], jnp.int32),
        positions=jnp.asarray([11, 5, 0, 0], jnp.int32),
        req_idx=jnp.asarray([0, 1, -1, -1], jnp.int32),
        slot_mapping=jnp.asarray([15, 21, -1, -1], jnp.int32),
        block_tables=jnp.asarray([[1, 2, 3, 0], [4, 5, 6, 0]], jnp.int32),
        seq_lens=jnp.asarray([12, 6], jnp.int32))


def kv_spec(arch=ARCH, heads=None):
    return JaxKVSpec(num_layers=arch.num_layers, num_kv_heads=heads
                     or arch.num_kv_heads, head_dim=arch.head_dim,
                     dtype=jnp.float32, **KV_KW)


@pytest.fixture(scope="module")
def world():
    w = World(4, backend="gloo", timeout_s=120, threads=1)
    yield w
    w.close()


def run_port(world, module, arch, tparams, par, mode, steps):
    n = par.get("tensor_parallel_size", 1) * \
        par.get("ulysses_sequence_parallel_size", 1)
    members = list(range(n)) if n < world.nprocs else None
    arch_kw = {f.name: getattr(arch, f.name)
               for f in dataclasses.fields(arch)}
    return world.run(tasks.sharded_forward, module, arch_kw, tparams, par,
                     mode, [np_tree(s) for s in steps], KV_KW,
                     members=members, ranks=range(n))


def check_rank_kv(kv_rank, jkv, mesh, sp, tp, rtol):
    want = shards_by_coords(jkv, mesh)
    for r, kv in enumerate(kv_rank):
        s, t = r // tp, r % tp
        np.testing.assert_allclose(kv, want[(s, t)], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("mode", ["sp", "shift"])
@pytest.mark.parametrize("sp,tp,hkv", [(2, 2, 8), (4, 1, 8), (1, 4, 8),
                                       (2, 1, 8), (2, 2, 2)])
def test_sharded_forward_matches_jax(world, jparams, sp, tp, hkv, mode):
    arch = dataclasses.replace(ARCH, num_kv_heads=hkv)
    jp = jparams if hkv == 8 else jllama.init_params(
        arch, jax.random.PRNGKey(1), jnp.float32)
    inputs = build_inputs()
    kv_ref, h_ref = jllama.forward(jp, arch, jalloc(kv_spec(arch)), inputs)
    cfg = jcfg.ParallelConfig(tensor_parallel_size=tp,
                              ulysses_sequence_parallel_size=sp)
    mesh = jmesh.build_mesh(cfg)
    fn = julysses.make_sharded_forward(jllama, arch, mesh, cfg, mode)
    kv_j, h_j = jax.jit(fn)(jmesh.shard_params(jp, mesh),
                            jalloc(kv_spec(arch, max(hkv, sp * tp))),
                            inputs)
    out = run_port(world, "llama", arch, port_params(jp),
                   dict(tensor_parallel_size=tp,
                        ulysses_sequence_parallel_size=sp), mode, [inputs])
    for (h, _), in out:
        np.testing.assert_allclose(h, np.asarray(h_j), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(h, np.asarray(h_ref), rtol=2e-4,
                                   atol=2e-4)
    check_rank_kv([o[0][1] for o in out], kv_j, mesh, sp, tp, 2e-4)
    if hkv == 8:     # the single forward's cache, at each rank's heads
        d = arch.head_dim * hkv // (sp * tp)
        for r, ((_, kv),) in enumerate(out):
            f = (r % tp) * sp + r // tp
            np.testing.assert_allclose(
                kv, np.asarray(kv_ref)[..., f * d:(f + 1) * d],
                rtol=2e-4, atol=2e-4)


def test_sp_and_shift_share_kv_layout(world, jparams):
    """Both modes write the same pages on every rank."""
    par = dict(tensor_parallel_size=2, ulysses_sequence_parallel_size=2)
    tp = port_params(jparams)
    a = run_port(world, "llama", ARCH, tp, par, "sp", [build_inputs()])
    b = run_port(world, "llama", ARCH, tp, par, "shift", [build_inputs()])
    for (((_, kv_a),), ((_, kv_b),)) in zip(a, b):
        np.testing.assert_allclose(kv_a, kv_b, rtol=2e-4, atol=2e-4)


def test_mode_handoff_mid_sequence(world, jparams):
    """An SP prefill, then a shift decode step reading its pages, against
    the single forward."""
    kv_ref, _ = jllama.forward(jparams, ARCH, jalloc(kv_spec()),
                               build_inputs())
    _, h2_ref = jllama.forward(jparams, ARCH, kv_ref, decode_inputs())
    out = run_port(world, "llama", ARCH, port_params(jparams),
                   dict(tensor_parallel_size=2,
                        ulysses_sequence_parallel_size=2,
                        enable_shift_parallel=True),
                   ["sp", "shift"], [build_inputs(), decode_inputs()])
    for _, (h2, _) in out:
        np.testing.assert_allclose(h2[:2], np.asarray(h2_ref)[:2],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("quant", ["fp8", "int8"])
def test_quantized_sharded_forward(world, jparams, quant):
    qp = jllama.quantize_params(jparams, quant)
    inputs = build_inputs()
    _, h_ref = jllama.forward(qp, ARCH, jalloc(kv_spec()), inputs)
    cfg = jcfg.ParallelConfig(tensor_parallel_size=2,
                              ulysses_sequence_parallel_size=2)
    mesh = jmesh.build_mesh(cfg)
    fn = julysses.make_sharded_forward(
        jllama, ARCH, mesh, cfg, "sp", quantized=True,
        embed_quantized=isinstance(qp["embed"], jfp8.QuantizedLinear),
        params=qp)
    kv_j, h_j = jax.jit(fn)(jmesh.shard_params(qp, mesh), jalloc(kv_spec()),
                            inputs)
    out = run_port(world, "llama", ARCH, port_params(qp),
                   dict(tensor_parallel_size=2,
                        ulysses_sequence_parallel_size=2), "sp", [inputs])
    for (h, _), in out:
        np.testing.assert_allclose(h, np.asarray(h_j), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(h, np.asarray(h_ref), rtol=2e-3,
                                   atol=2e-3)
    check_rank_kv([o[0][1] for o in out], kv_j, mesh, 2, 2, 2e-3)


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_qwen_families_sharded_forward(world, family):
    """Qwen2's q/k/v biases cut over tp and re-sliced under shift, and
    Qwen3's per-head q / k norms on a rank's heads: both modes against
    the JAX single forward."""
    jmod = jqwen2 if family == "qwen2" else jqwen3
    arch = jmod.Arch(**ARCH_KW, attention_bias=family == "qwen2",
                     qk_norm=family == "qwen3")
    jp = jmod.init_params(arch, jax.random.PRNGKey(6), jnp.float32)
    if family == "qwen3":   # norms away from 1, so a wrong cut shows
        jp["layers"]["q_norm"] = 1.0 + 0.5 * jax.random.normal(
            jax.random.PRNGKey(7), jp["layers"]["q_norm"].shape)
        jp["layers"]["k_norm"] = 1.0 + 0.5 * jax.random.normal(
            jax.random.PRNGKey(8), jp["layers"]["k_norm"].shape)
    inputs = build_inputs()
    _, h_ref = jmod.forward(jp, arch, jalloc(kv_spec(arch)), inputs)
    tp_ = port_params(jp)
    par = dict(tensor_parallel_size=2, ulysses_sequence_parallel_size=2,
               enable_shift_parallel=True)
    for mode in ("sp", "shift"):
        out = run_port(world, family, arch, tp_, par, mode, [inputs])
        for (h, _), in out:
            np.testing.assert_allclose(h, np.asarray(h_ref), rtol=2e-4,
                                       atol=2e-4)


# --------------------------------------------------------------------- #
# SwiftKV and Mixtral on the mesh
# --------------------------------------------------------------------- #

SWIFT_ARCH = jsw.LlamaSwiftKVArch(**ARCH_KW, num_key_value_layers=1)
# tests/test_moe.py's ARCH: 8 experts, top 2.
MOE_ARCH = jmix.MixtralArch(
    vocab_size=64, hidden_size=64, intermediate_size=96, num_layers=2,
    num_heads=8, num_kv_heads=8, head_dim=16, num_experts=8,
    num_experts_per_tok=2)


@pytest.fixture(scope="module")
def family_refs():
    """Per family: (arch, JAX params, the step's inputs, the JAX single
    forward's cache and hidden rows); SwiftKV samples rows 3, 10 and 15
    and a padding row."""
    out = {}
    for family, arch, jmod in (("llama_swiftkv", SWIFT_ARCH, jsw),
                               ("mixtral", MOE_ARCH, jmix)):
        inputs = build_inputs()
        if family == "llama_swiftkv":
            inputs["logits_indices"] = jnp.asarray([3, 10, 15, 0],
                                                   jnp.int32)
        jp = jmod.init_params(arch, jax.random.PRNGKey(1), jnp.float32)
        kv_ref, h_ref = jmod.forward(jp, arch, jalloc(kv_spec(arch)),
                                     inputs)
        out[family] = (arch, jp, inputs, np.asarray(kv_ref),
                       np.asarray(h_ref))
    return out


@pytest.mark.parametrize("mode", ["sp", "shift"])
@pytest.mark.parametrize("sp,tp", [(1, 4), (2, 2)])
@pytest.mark.parametrize("family", ["llama_swiftkv", "mixtral"])
def test_swiftkv_and_moe_sharded_forward_match_jax(world, family_refs,
                                                   family, sp, tp, mode):
    """The JAX ``test_sharded_moe_matches_single_chip`` cases, and
    SwiftKV's (the later layers in the shift layout in both modes):
    hidden rows and each rank's cache pages against the JAX single
    forward at 5e-4."""
    arch, jp, inputs, kv_ref, h_ref = family_refs[family]
    n = 3 if family == "llama_swiftkv" else 16
    out = run_port(world, family, arch, port_params(jp),
                   dict(tensor_parallel_size=tp,
                        ulysses_sequence_parallel_size=sp), mode, [inputs])
    d = arch.head_dim * arch.num_kv_heads // (sp * tp)
    for r, ((h, kv),) in enumerate(out):
        np.testing.assert_allclose(h[:n], h_ref[:n], rtol=5e-4, atol=5e-4)
        f = (r % tp) * sp + r // tp
        np.testing.assert_allclose(kv, kv_ref[..., f * d:(f + 1) * d],
                                   rtol=5e-4, atol=5e-4)


class _ExpertRange:
    """A parallel context as ``_moe_mlp`` reads it: one shard's experts."""

    def __init__(self, e0: int, el: int):
        self.e0, self.el = e0, el

    def moe_expert_range(self, num_experts):
        return self.e0, self.el


def _moe_layer(seed, d, f, e):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {"w_router": jax.random.normal(keys[0], (d, e)) * 0.2,
            "w_gate": jax.random.normal(keys[1], (e, d, f)) * 0.2,
            "w_up": jax.random.normal(keys[2], (e, d, f)) * 0.2,
            "w_down": jax.random.normal(keys[3], (e, f, d)) * 0.2}


@functools.lru_cache(maxsize=None)
def _jax_ep_moe(d, f, e, k, tp):
    """(arch, arch at capacity factor 1.0, the JAX ``shard_map``'d
    ``_moe_mlp`` + ``psum`` at tp ``tp``, jitted once for both routers:
    the JAX test's construction)."""
    arch = dataclasses.replace(MOE_ARCH, hidden_size=d, intermediate_size=f,
                               num_experts=e, num_experts_per_tok=k)
    arch_c = dataclasses.replace(arch, moe_capacity_factor=1.0)
    cfg = jcfg.ParallelConfig(tensor_parallel_size=tp)
    mesh = jmesh.build_mesh(cfg)
    pctx = julysses.ParallelContext(cfg, "sp")
    P = jax.sharding.PartitionSpec

    def body(x, wr, wg, wu, wd):
        lp_l = {"w_router": wr, "w_gate": wg, "w_up": wu, "w_down": wd}
        return jax.lax.psum(jmix._moe_mlp(x, lp_l, arch_c, pctx), "tp")

    return arch, arch_c, jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("tp"), P("tp"), P("tp")),
        out_specs=P(), check_vma=False))


@pytest.mark.parametrize("router", ["balanced", "skewed"])
def test_ep_capacity_window_matches_jax(router):
    """``moe_capacity_factor`` 1.0 at tp 4 (the JAX
    ``test_ep_capacity_balanced_exact`` construction): the four shards'
    ``_moe_mlp`` summed equals the JAX ``shard_map``'d ``_moe_mlp`` and
    ``psum`` at 2e-4.  Balanced routing (token i on experts i % 8 and
    (i + 3) % 8) loses nothing, so both equal the dropless block; the
    skewed router sends every token to experts 0 and 1, past shard 0's
    window of 8 of the 32 rows, so both drop the same rows."""
    d, f, e, k, t, tp = 32, 48, 8, 2, 16, 4
    lp = _moe_layer(4, d, f, e)
    x = np.array(jax.random.normal(jax.random.PRNGKey(5), (t, d)))
    wr = np.zeros((d, e), np.float32)
    if router == "balanced":
        wr[:e, :e] = np.eye(e, dtype=np.float32) * 8.0
        x[:, :e] *= 0.01
        for i in range(t):
            x[i, i % e] += 2.0
            x[i, (i + 3) % e] += 1.0
    else:
        wr[:, 0] = 1.0
        wr[:, 1] = 0.5
        x = np.abs(x)
    lp = dict(lp, w_router=jnp.asarray(wr))
    xj = jnp.asarray(x, jnp.float32)
    arch, arch_c, ep_moe = _jax_ep_moe(d, f, e, k, tp)
    want = np.asarray(ep_moe(xj, lp["w_router"], lp["w_gate"], lp["w_up"],
                             lp["w_down"]))
    dropless = np.asarray(jax.jit(
        lambda x, lp: jmix._moe_mlp(x, lp, arch, None))(xj, lp))

    tarch = tmix.MixtralArch(**{fl.name: getattr(arch_c, fl.name)
                               for fl in dataclasses.fields(arch_c)})
    tlp = {key: torch.from_numpy(np.array(v)) for key, v in lp.items()}
    tx = torch.from_numpy(x.astype(np.float32))
    el = e // tp
    got = sum(tmix._moe_mlp(
        tx, dict(tlp, **{key: tlp[key][s * el:(s + 1) * el]
                         for key in ("w_gate", "w_up", "w_down")}),
        tarch, _ExpertRange(s * el, el)) for s in range(tp)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if router == "balanced":
        np.testing.assert_allclose(got, dropless, rtol=2e-4, atol=2e-4)
    else:
        # Shard 0 keeps 8 of its 32 rows: most tokens lost their sum.
        lost = np.abs(got - dropless).max(axis=1) > 1e-3
        assert lost.sum() >= t // 2
