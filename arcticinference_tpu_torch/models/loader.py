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


def load_model(cfg: ModelConfig, device: torch.device | str | None = None):
    """Returns (module, arch, params) with the weights on ``device``
    (``cuda:0`` by default; raises without CUDA unless the caller passes
    ``device="cpu"``).

    Random weights are drawn from a ``torch.Generator`` on ``device``
    seeded with ``cfg.seed``.
    """
    device = resolve_device(device)
    hf_cfg = read_hf_config(cfg.model)
    if hf_cfg is not None:
        arch_name = (hf_cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        merged = {**hf_cfg, **cfg.hf_overrides}
    else:
        arch_name = cfg.model
        merged = dict(cfg.hf_overrides)
    module = get_model_module(arch_name)
    arch = module.Arch.from_hf_config(merged)

    dtype = resolve_dtype(cfg.dtype)
    model_dir = Path(cfg.model)
    if hf_cfg is not None and any(model_dir.glob("*.safetensors")):
        params = module.load_hf_state(
            arch, dict(_iter_safetensors(model_dir)), dtype,
            quantization=cfg.quantization, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = module.init_params(arch, gen, dtype,
                                    quantization=cfg.quantization,
                                    device=device)
    return module, arch, params
