"""Checkpoint loading: HF directory -> (module, arch, params).

- HF model directories: ``config.json`` + ``*.safetensors`` shards
  (read by the port's own reader, ``st_io``).
- Architecture name + ``hf_overrides`` with random init from the seed
  (benchmarks, tests: no checkpoint required).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch

from arcticinference_tpu_torch import st_io
from arcticinference_tpu_torch.config import ModelConfig
from arcticinference_tpu_torch.models import get_model_module
from arcticinference_tpu_torch.utils import resolve_device

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.bfloat16,  # as the JAX package: fp16 runs as bf16
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unsupported dtype {name!r}")
    return _DTYPES[name]


def read_hf_config(model: str) -> Optional[dict[str, Any]]:
    p = Path(model) / "config.json"
    if p.exists():
        return json.loads(p.read_text())
    return None


def _iter_safetensors(model_dir: Path):
    for f in sorted(model_dir.glob("*.safetensors")):
        yield from st_io.load_file(f).items()


def resolve_model(cfg: ModelConfig):
    """(module, arch) of a model config, without its weights."""
    hf_cfg = read_hf_config(cfg.model)
    if hf_cfg is not None:
        arch_name = (hf_cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        merged = {**hf_cfg, **cfg.hf_overrides}
    else:
        arch_name = cfg.model
        merged = dict(cfg.hf_overrides)
    module = get_model_module(arch_name)
    return module, module.Arch.from_hf_config(merged)


def load_model(cfg: ModelConfig, device: torch.device | str | None = None,
               mesh=None):
    """Returns (module, arch, params) with the weights on ``device``
    (``cuda:0`` by default; raises without CUDA unless the caller passes
    ``device="cpu"``).

    Random weights are drawn from a ``torch.Generator`` on ``device``
    seeded with ``cfg.seed``.  With ``mesh`` (``parallel/mesh.py``) the
    params are this rank's cut of the global ones (``shard_params``, by
    the module's rules, ``specs_of``); random weights are cut as they are
    drawn, one global weight (a layer of a stacked one) alive at a
    time, and a pipeline stage draws and quantizes its own layers only.
    """
    device = resolve_device(device)
    module, arch = resolve_model(cfg)
    dtype = resolve_dtype(cfg.dtype)
    model_dir = Path(cfg.model)
    if read_hf_config(cfg.model) is not None and \
            any(model_dir.glob("*.safetensors")):
        params = module.load_hf_state(
            arch, dict(_iter_safetensors(model_dir)), dtype,
            quantization=cfg.quantization, device=device)
        if mesh is not None:
            from arcticinference_tpu_torch.parallel import mesh as mesh_lib

            kv_scales = params.pop("kv_scales", None)
            params = mesh_lib.shard_params(params, mesh,
                                           mesh_lib.specs_of(module))
            if kv_scales is not None:
                params["kv_scales"] = kv_scales
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        kw = {}
        if mesh is not None:
            from arcticinference_tpu_torch.parallel import mesh as mesh_lib

            specs = mesh_lib.specs_of(module)

            def keep(path, leaf):
                # A layer weight arrives one layer at a time: its rule
                # without the layer axis.
                return mesh_lib.shard_leaf(
                    leaf, mesh_lib.layer_leaf_spec(path, specs), mesh)

            kw["keep"] = keep
            if mesh.stages > 1:
                kw["layers"] = mesh.stage_layers(arch.num_layers)
        params = module.init_params(arch, gen, dtype,
                                    quantization=cfg.quantization,
                                    device=device, **kw)
    return module, arch, params
