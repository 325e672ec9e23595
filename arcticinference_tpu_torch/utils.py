"""Small shared helpers: bucket arithmetic and device selection."""

from __future__ import annotations

from typing import Sequence, Union

import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return cdiv(x, multiple) * multiple


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; buckets must be sorted ascending.

    Every step runs at a bucketed token count, as in the JAX package, so
    host arrays compare element for element with its runner.
    """
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def default_token_buckets(max_tokens: int) -> list[int]:
    """Power-of-two token buckets from 16 up to max_tokens (inclusive)."""
    buckets = []
    b = 16
    while b < max_tokens:
        buckets.append(b)
        b *= 2
    buckets.append(max_tokens)
    return buckets


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller
    names another one.  A CUDA device that is not there raises; nothing
    falls back to the CPU unless the caller asked for it."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of ``device`` (CUDA: ``torch.cuda.mem_get_info``);
    the CPU gets a small synthetic budget, as the JAX package's CPU
    backend does."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total)
    return 2 * 1024 ** 3


# Known cards: (name fragments, device memory bytes, nominal memory B/s,
# dense bf16 tensor FLOP/s), from NVIDIA's data sheet (H100 SXM).
_CARD_TABLE = (
    (("h100",), 80 * 1024 ** 3, 3.35e12, 989e12),
)


def chip_specs(device_name: str | None = None
               ) -> tuple[int, float | None, float | None]:
    """(device memory bytes, nominal peak memory B/s, dense bf16 FLOP/s)
    of a card, by its name (``torch.cuda.get_device_name(0)`` by
    default).  An unknown card gives the memory it reports and no peaks;
    the CPU a small synthetic budget and no peaks."""
    if device_name is None:
        if not torch.cuda.is_available():
            return 2 * 1024 ** 3, None, None
        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    for frags, mem, bw, flops in _CARD_TABLE:
        if any(f in name for f in frags):
            return mem, bw, flops
    mem = (torch.cuda.get_device_properties(0).total_memory
           if torch.cuda.is_available() else 16 * 1024 ** 3)
    return int(mem), None, None


def events_ms(fn, iters: int, sleep_cycles: int = 0) -> float:
    """Device milliseconds per call of ``fn`` over ``iters`` calls between
    CUDA events, after one warm call.  ``sleep_cycles`` > 0 first queues
    a spinning kernel that holds the device while the host enqueues the
    calls, so calls shorter than their host cost are not timed at the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
