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

A drafter's parameters (``models/speculators.py``) carry lists of
arrays (one per head) beside plain arrays and ``QuantizedLinear``
leaves; each list comes over as a list of the same leaves.  A distilled
(``distilled_tied``) drafter's lists of embedding and LM-head tables are
the JAX target's own: :func:`distilled_params_from_jax` carries its
trained lists across and ties it to the port target's tables instead.
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


def _leaf(key, val, device):
    if isinstance(val, dict):
        return params_from_jax(val, device)
    if isinstance(val, (list, tuple)):
        return [_leaf(key, v, device) for v in val]
    if isinstance(val, np.ndarray):
        return _tensor(val, device)
    if isinstance(getattr(val, "weight", None), np.ndarray) and \
            isinstance(getattr(val, "scale", None), np.ndarray):
        return QuantizedLinear(_tensor(val.weight, device),
                               _tensor(val.scale, device))
    raise TypeError(f"parameter {key!r} of type {type(val).__name__} is "
                    "neither an array, a list of them nor a quantized "
                    "weight")


def params_from_jax(np_tree: dict, device: torch.device | str) -> dict:
    """The JAX parameter dict (numpy leaves, quantized leaves as objects
    with numpy ``weight`` and ``scale``, lists of either) as torch
    tensors and ``QuantizedLinear`` on ``device``."""
    return {key: _leaf(key, val, device) for key, val in np_tree.items()}


def distilled_params_from_jax(np_tree: dict, target_params: dict,
                              device: torch.device | str) -> dict:
    """A JAX ``distilled_tied`` drafter (``spec/distill.py``: ``proj``,
    ``ln_w``, ``ln_b`` lists, numpy leaves) as the port's, its embedding
    and LM head the port target's own ``embed`` and ``lm_head`` (the
    same weights the JAX lists hold), not copies."""
    n = len(np_tree["proj"])
    out = {key: _leaf(key, np_tree[key], device)
           for key in ("proj", "ln_w", "ln_b")}
    out["emb"] = [target_params["embed"]] * n
    out["head"] = [target_params["lm_head"]] * n
    return out
