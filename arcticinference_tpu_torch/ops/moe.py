"""Routing and combining of a dropless mixture-of-experts block, with no
host read.

Counterparts of the steps of ``arcticinference_tpu/models/mixtral.py``
``_moe_mlp`` on one device (no expert parallelism, so no capacity
window):

- :func:`route`: float32 router logits, the top ``k`` experts, a softmax
  over their values;
- :func:`sort_assignments`: the ``(token, k)`` assignments sorted by
  expert with a stable sort (``jnp.argsort`` is stable), so each
  expert's rows come in the JAX order;
- :func:`group_offsets`: the ``[E + 1]`` int32 bounds of each expert's
  rows, on the device (``searchsorted``; ``torch.bincount`` on CUDA
  reads its input's max back to size its output);
- :func:`grouped_matmul`: the expert products
  (``ops/cuda/grouped_matmul.py``);
- :func:`combine`: each token's ``k`` contributions weighted and summed
  in float32, in slot order, through the inverse permutation (an
  ``index_add_`` would sum with atomics in no fixed order on the card).
"""

from __future__ import annotations

import torch

from arcticinference_tpu_torch.ops.cuda.grouped_matmul import (
    grouped_matmul_kernel, grouped_matmul_reference)
from arcticinference_tpu_torch.ops.fp8 import QuantizedLinear


def route(x: torch.Tensor, w_router: torch.Tensor,
          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate weights [T, k] float32, experts [T, k]): the top ``k`` of
    the float32 router logits and a softmax over their values."""
    logits = torch.matmul(x.float(), w_router.float())
    top_v, top_i = torch.topk(logits, k, dim=-1)
    return torch.softmax(top_v, dim=-1), top_i


def sort_assignments(top_i: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, sorted experts int32, token of each sorted row) of the
    flattened ``[T * k]`` assignments, stably sorted by expert."""
    k = top_i.shape[-1]
    flat_e = top_i.reshape(-1).to(torch.int32)
    order = torch.argsort(flat_e, stable=True)
    return order, flat_e[order], order // k


def group_offsets(sorted_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """int32 ``[E + 1]``: expert ``e``'s rows of the sorted list are
    ``offsets[e]:offsets[e + 1]`` (the prefix sum of the counts)."""
    bounds = torch.arange(num_experts + 1, dtype=torch.int32,
                          device=sorted_e.device)
    return torch.searchsorted(sorted_e, bounds, out_int32=True)


def grouped_matmul(xs: torch.Tensor, w, offsets: torch.Tensor,
                   kernel=grouped_matmul_kernel) -> torch.Tensor:
    """``float32(xs[r] @ deq(w[e]))`` per expert group, for a plain or a
    :class:`QuantizedLinear` ``[E, K, N]`` stack."""
    if isinstance(w, QuantizedLinear):
        return kernel(xs, w.weight, w.scale, offsets)
    return kernel(xs, w, None, offsets)


def grouped_matmul_plain(xs: torch.Tensor, w,
                         offsets: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_matmul` through the plain version on any device
    (the yardstick the kernel is held against; it reads the offsets on
    the host)."""
    return grouped_matmul(xs, w, offsets, grouped_matmul_reference)


def combine(y: torch.Tensor, gate: torch.Tensor,
            order: torch.Tensor) -> torch.Tensor:
    """Each token's float32 sum of its ``k`` sorted rows of ``y`` [T*k, D]
    times their gate weights [T, k]: the rows go back to (token, slot)
    order through the inverse of ``order``, and the slots are added in
    order."""
    t, k = gate.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    ytk = y.index_select(0, inv).view(t, k, -1) * gate[:, :, None]
    out = ytk[:, 0]
    for j in range(1, k):
        out = out + ytk[:, j]
    return out
