"""The port's HBM read probe (kernel 7) on the CPU.

``ops/cuda/hbm_probe.py`` ports ``bench.py::_measure_dma_read``.  The
JAX function fixes its 4 GiB buffer inside itself (``bench.py:88-89``),
so the plain version is held against a numpy statement of the Pallas
kernel's body (``bench.py:104-105``: an f32 accumulator plus, per chunk
in order, the f32 sum of the chunk's first row) at a few chunks, within
float32 reordering (rtol 1e-6).  The kernel's launch plan is host
arithmetic and is checked here: every 32 KiB tile read by exactly one
CTA, contiguous ranges, and each chunk's partial written once by the CTA
that holds its first tile.  The card holds the kernel against the plain
version at full size (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from arcticinference_tpu_torch.ops.cuda import hbm_probe as hp


def numpy_kernel_body(x: np.ndarray) -> np.float32:
    """bench.py:104-105 and :98-107: acc + sum(chunk[0, 0, :]) per chunk,
    in chunk order, in float32."""
    acc = np.float32(0)
    for ci in range(x.shape[0]):
        acc = np.float32(acc + np.sum(x[ci, 0, 0, :].astype(np.float32)))
    return acc


@pytest.mark.parametrize("chunks,shape", [(3, hp.CHUNK_SHAPE),
                                          (7, (2, 64, 128))])
def test_plain_probe_matches_kernel_body(chunks, shape):
    rng = np.random.default_rng(chunks)
    x = torch.from_numpy(rng.standard_normal((chunks,) + shape)
                         .astype(np.float32)).to(torch.bfloat16)
    want = numpy_kernel_body(x.float().numpy())
    got = hp.hbm_read_probe(x)           # a CPU tensor: the plain version
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-5)
    assert got.item() == hp.hbm_read_probe_reference(x).item()


def test_probe_reads_only_each_chunks_first_row():
    x = torch.zeros((4,) + hp.CHUNK_SHAPE, dtype=torch.bfloat16)
    x[:, 0, 1, :] = 5.0                  # not a first row: ignored
    x[:, 1, 0, :] = 7.0
    x[2, 0, 0, 3] = 1.5
    assert hp.hbm_read_probe(x).item() == 1.5


@pytest.mark.parametrize("n_bytes,chunk_bytes,ctas", [
    (1024 * 4 * 2 ** 20, 4 * 2 ** 20, 132),   # the 4 GiB buffer, H100 SMs
    (1024 * 4 * 2 ** 20, 4 * 2 ** 20, 264),
    (5 * 32 * 1024, 32 * 1024, 3),           # a chunk per tile
    (6 * 64 * 1024, 64 * 1024, 5),
])
def test_launch_plan_covers_every_tile_once(n_bytes, chunk_bytes, ctas):
    plan = hp.probe_plan(n_bytes, chunk_bytes, ctas)
    ranges = plan["ranges"]
    n_tiles = n_bytes // hp.TILE_BYTES
    assert plan["n_tiles"] == n_tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    per = plan["tiles_per_chunk"]
    assert per == chunk_bytes // hp.TILE_BYTES
    writer = plan["partial_writer"]
    assert len(writer) == n_bytes // chunk_bytes
    # Partials are written by CTAs in nondecreasing order and summed in
    # chunk order: the sum is the same in every run.
    assert writer == sorted(writer)
    for c, b in enumerate(writer):
        lo, hi = ranges[b]
        assert lo <= c * per < hi


def test_launch_plan_refuses_ragged_buffers():
    with pytest.raises(ValueError):
        hp.probe_plan(3 * hp.TILE_BYTES, hp.TILE_BYTES + 16, 2)
    with pytest.raises(ValueError):
        hp.probe_plan(4 * hp.TILE_BYTES, hp.TILE_BYTES, 5)


def test_roofline_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        hp.measure_hbm_roofline("cpu")


def test_cpu_probe_counts_no_launch():
    hp.reset_launch_counts()
    hp.hbm_read_probe(torch.zeros((2,) + hp.CHUNK_SHAPE,
                                  dtype=torch.bfloat16))
    assert hp.hbm_probe_launches == 0
