"""Environment-variable flags of the port, read at access time.

The port's own copy of the JAX package's registry
(``arcticinference_tpu/envs.py``), with the same variable names, so one
environment drives both packages; a test may monkeypatch ``os.environ``
and the next access sees it.  It also holds the flags the JAX package's
fused loop reads inline (``engine/fused_decode.py``).
"""

from __future__ import annotations

import os
from typing import Any, Callable


def _flag(name: str) -> Callable[[], bool]:
    return lambda: os.environ.get(name, "0") == "1"


environment_variables: dict[str, Callable[[], Any]] = {
    # Force the pure-Python suffix tree (no C++ build).
    "ARCTIC_TPU_PURE_PYTHON_SUFFIX": _flag("ARCTIC_TPU_PURE_PYTHON_SUFFIX"),
    # Disable the device-resident fused decode loop regardless of
    # SpeculativeConfig.enable_fused_decode.
    "ARCTIC_TPU_DISABLE_FUSED": _flag("ARCTIC_TPU_DISABLE_FUSED"),
    # Deferred KV writes: grouped decode steps inject the step's new K/V
    # rows into the attention softmax and scatter them into the cache once
    # for the whole model after the layer stack.
    "ARCTIC_TPU_DEFERRED_KV": _flag("ARCTIC_TPU_DEFERRED_KV"),
    # Pin the fused suffix loop's program width ("wide" | "narrow" | "" =
    # the loop's policy).
    "ARCTIC_TPU_FUSED_FORCE_WIDTH":
        lambda: os.environ.get("ARCTIC_TPU_FUSED_FORCE_WIDTH", ""),
    # Turn off the fused loop's per-slot ("slotted") width program.
    "ARCTIC_TPU_DISABLE_SLOTTED":
        lambda: bool(os.environ.get("ARCTIC_TPU_DISABLE_SLOTTED")),
    # Benchmark aid: each next-step draft token of the fused loop is
    # corrupted with this probability (acceptance-curve sweeps); 0 = off.
    "ARCTIC_TPU_FUSED_CORRUPT_RATE":
        lambda: float(os.environ.get("ARCTIC_TPU_FUSED_CORRUPT_RATE", "0")
                      or 0),
    # Print the fused loop's per-step width choice to stderr.
    "ARCTIC_TPU_FUSED_DEBUG":
        lambda: bool(os.environ.get("ARCTIC_TPU_FUSED_DEBUG")),
}


def __getattr__(name: str) -> Any:
    if name in environment_variables:
        return environment_variables[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list[str]:
    return list(environment_variables.keys())
