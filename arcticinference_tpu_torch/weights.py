"""Parameters of the JAX package, as the port's.

:func:`params_from_jax` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's parameters on ``device``.  The keys,
the stacked ``[L, ...]`` layer axis and the ``[in, out]`` orientation are
the same in both packages, so both compute the same function.

The JAX package's ``QuantizedLinear`` is a pytree node whose children are
its weight and scale, so ``jax.tree.map(np.asarray, params)`` hands it
over as a ``QuantizedLinear`` holding two numpy arrays.  Any such object
(anything with ``weight`` and ``scale`` arrays) becomes the port's
:class:`~arcticinference_tpu_torch.ops.fp8.QuantizedLinear` with the same
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear

# numpy has no bfloat16 or float8 of its own (JAX uses ml_dtypes): these
# move as raw bit patterns of the same width and are reinterpreted.
_RAW = {"bfloat16": (np.int16, torch.bfloat16),
        "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)          # a writable, contiguous copy
    raw = _RAW.get(a.dtype.name)
    if raw is not None:
        return torch.from_numpy(a.view(raw[0])).view(raw[1]).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree: dict, device: torch.device | str) -> dict:
    """The JAX parameter dict (numpy leaves, quantized leaves as objects
    with numpy ``weight`` and ``scale``) as torch tensors and
    ``QuantizedLinear`` on ``device``."""
    out: dict = {}
    for key, val in np_tree.items():
        if isinstance(val, dict):
            out[key] = params_from_jax(val, device)
        elif isinstance(val, np.ndarray):
            out[key] = _tensor(val, device)
        elif isinstance(getattr(val, "weight", None), np.ndarray) and \
                isinstance(getattr(val, "scale", None), np.ndarray):
            out[key] = QuantizedLinear(_tensor(val.weight, device),
                                       _tensor(val.scale, device))
        else:
            raise TypeError(f"parameter {key!r} of type "
                            f"{type(val).__name__} is neither an array nor "
                            "a quantized weight")
    return out
