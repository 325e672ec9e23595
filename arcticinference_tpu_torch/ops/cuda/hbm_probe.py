"""HBM read probe on the card: wrapper of the CUDA kernel in
``csrc/hbm_probe.cu``, and the bench's measured memory ceiling.

:func:`hbm_read_probe` replaces ``bench.py::_measure_dma_read`` (the
``pallas_call`` at ``bench.py:120``): a read stream over a ``[chunks,
32, 512, 128]`` bf16 buffer (the TPU probe's 4 GiB in 1024 chunks of
4 MiB) whose value is the float32 sum, over chunks in order, of the sum
of each chunk's first row ``x[c, 0, 0, :]``.  Every byte is read once.

:func:`measure_hbm_roofline` is ``bench.py::measure_hbm_roofline``: the
larger of an xor-copy probe (``x ^ 1`` over a 2 GiB int8 buffer, read
and write traffic, a plain torch op as XLA computed it outside Pallas)
and the read stream, in bytes per second, each timed with CUDA events.

Given a CPU tensor the probe computes its plain version
(:func:`hbm_read_probe_reference`); given a CUDA tensor it launches the
kernel and raises on anything the kernel does not take.  Each launch
adds one to ``hbm_probe_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from arcticinference_tpu_torch.utils import events_ms

SOURCE = "hbm_probe.cu"

#: Kernel launches since the last :func:`reset_launch_counts`.
hbm_probe_launches = 0

#: The TPU probe's buffer: 1024 chunks of (32, 512, 128) bf16, 4 GiB.
CHUNK_SHAPE = (32, 512, 128)
N_CHUNKS = 1024
#: Bytes per cp.async tile of the kernel (csrc/hbm_probe.cu kTileBytes).
TILE_BYTES = 32 * 1024
ROW_ELEMS = 128
#: The xor probe's buffer (bench.py:56: 2 GiB of int8 on the chip).
XOR_BYTES = 1 << 31

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SM_COUNT: dict[int, int] = {}


def reset_launch_counts() -> None:
    global hbm_probe_launches
    hbm_probe_launches = 0


def hbm_read_probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[[sum_c sum(x[c, 0, 0, :])]]`` in float32 (each
    chunk's first row summed in float32, then the row sums added)."""
    rows = x.reshape(x.shape[0], -1)[:, :ROW_ELEMS].float().sum(dim=1)
    return rows.sum().reshape(1, 1)


def probe_plan(n_bytes: int, chunk_bytes: int, ctas: int) -> dict:
    """The kernel's launch plan, as ``read_stream_kernel`` computes it:
    tiles of ``TILE_BYTES``, CTA ``b`` of ``ctas`` streams the contiguous
    tiles ``[b*T // ctas, (b+1)*T // ctas)``, and the CTA that holds a
    chunk's first tile writes that chunk's partial; the partials are
    added in chunk order.  Returns the tile ranges per CTA and, per
    chunk, the CTA that writes its partial."""
    if chunk_bytes % TILE_BYTES or n_bytes % chunk_bytes:
        raise ValueError(f"{n_bytes} bytes in chunks of {chunk_bytes} do "
                         f"not cut into {TILE_BYTES}-byte tiles")
    n_tiles = n_bytes // TILE_BYTES
    if not 0 < ctas <= n_tiles:
        raise ValueError(f"{ctas} CTAs for {n_tiles} tiles")
    ranges = [(b * n_tiles // ctas, (b + 1) * n_tiles // ctas)
              for b in range(ctas)]
    per_chunk = chunk_bytes // TILE_BYTES
    writer = []
    b = 0
    for c in range(n_bytes // chunk_bytes):
        t = c * per_chunk
        while not ranges[b][0] <= t < ranges[b][1]:
            b += 1
        writer.append(b)
    return dict(n_tiles=n_tiles, tiles_per_chunk=per_chunk, ranges=ranges,
                partial_writer=writer)


def _lib() -> ctypes.CDLL:
    from arcticinference_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if lib.hbm_probe_launch.argtypes is None:
        lib.hbm_probe_launch.argtypes = [_P, _L, _L, _I, _P, _P, _P]
        lib.hbm_probe_launch.restype = _I
        lib.hbm_probe_tile_bytes.restype = _I
        if lib.hbm_probe_tile_bytes() != TILE_BYTES:
            raise RuntimeError("csrc/hbm_probe.cu and its wrapper disagree "
                               "on the tile size")
    return lib


def _sm_count(device: int) -> int:
    sms = _SM_COUNT.get(device)
    if sms is None:
        sms = _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def hbm_read_probe(x: torch.Tensor) -> torch.Tensor:
    """``[[sum over chunks of sum(x[c, 0, 0, :])]]`` as a [1, 1] float32
    tensor, reading all of ``x`` ([chunks, ...] bf16, contiguous, each
    chunk a multiple of 32 KiB on the card)."""
    global hbm_probe_launches
    if not x.is_cuda:
        return hbm_read_probe_reference(x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"probe buffer dtype {x.dtype} (bfloat16 expected)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the probe buffer must be contiguous and 16-byte "
                         "aligned")
    n_chunks = x.shape[0]
    chunk_bytes = x[0].numel() * 2 if n_chunks else 0
    if n_chunks == 0 or chunk_bytes % TILE_BYTES or \
            x[0].numel() < ROW_ELEMS or x.shape[-1] != ROW_ELEMS:
        raise ValueError(f"probe buffer {tuple(x.shape)}: need chunks of a "
                         f"multiple of {TILE_BYTES} bytes with rows of "
                         f"{ROW_ELEMS} values")
    dev = x.get_device()
    n_bytes = x.numel() * 2
    ctas = min(_sm_count(dev), n_bytes // TILE_BYTES)
    partials = torch.empty(n_chunks, dtype=torch.float32, device=x.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    rc = _lib().hbm_probe_launch(
        x.data_ptr(), n_bytes, chunk_bytes, ctas, partials.data_ptr(),
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"hbm_probe_launch failed: CUDA error {rc}")
    hbm_probe_launches += 1
    return out


def probe_buffer(device, generator: torch.Generator | None = None
                 ) -> torch.Tensor:
    """The probe's 4 GiB bf16 buffer on ``device``: zeros, or N(0, 1)
    values from ``generator`` (a check needs values a row summed twice or
    skipped would change)."""
    shape = (N_CHUNKS,) + CHUNK_SHAPE
    if generator is None:
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.bfloat16)


def measure_hbm_roofline(device) -> dict:
    """The bench's memory ceiling on a CUDA ``device``: the xor-copy
    probe's (8 passes) and the read stream's (3 passes) bytes per second,
    as ``bench.py`` times them, and the larger of the two
    (``bytes_per_s``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the HBM probes measure a CUDA device")
    x = torch.zeros(XOR_BYTES, dtype=torch.int8, device=device)
    xor_ms = events_ms(lambda: torch.bitwise_xor(x, 1, out=x), 8)
    xor_bps = 2 * XOR_BYTES / (xor_ms / 1e3)          # read + write
    del x
    buf = probe_buffer(device)
    read_ms = events_ms(lambda: hbm_read_probe(buf), 3)
    read_bps = buf.numel() * 2 / (read_ms / 1e3)
    del buf
    torch.cuda.empty_cache()
    return dict(bytes_per_s=max(xor_bps, read_bps), xor_bytes_per_s=xor_bps,
                read_bytes_per_s=read_bps, read_ms=read_ms)
