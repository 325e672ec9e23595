"""Fixture helpers the port's test files share across one pytest run.

``tests/test_torch_engine.py``, ``test_torch_engine_parallel.py``,
``test_torch_multihost.py`` and ``test_torch_quant.py`` (and
``test_torch_sampling_ext.py``, through the first one's fixture) hold
their engines to the tiny trained checkpoint of ``tests/quality_utils.py``
at 60 steps.  It is trained once per pytest run and intra-op thread count
(the weights depend on the order of the training's float sums, and so on
the threads; the seed is the same): under ``pytest-xdist`` the workers
share the run's temporary root, and the first to take the lock trains
while the others wait for it.
"""

from __future__ import annotations

import fcntl
import os

import numpy as np


def tiny_trained_checkpoint(tmp_path_factory, steps: int = 60):
    """(checkpoint directory, held-out token ids) of the tiny checkpoint
    trained for ``steps`` steps on the caller's intra-op threads, trained
    at the first such call of the pytest run (of any xdist worker)."""
    import torch

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    name = f"torch_tiny_trained_{steps}_t{torch.get_num_threads()}"
    d = root / name
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "heldout.npy").exists():
            from tests.quality_utils import train_tiny_checkpoint

            _, heldout = train_tiny_checkpoint(d, steps=steps)
            np.save(d / "heldout.npy", np.asarray(heldout))
    return str(d), np.load(d / "heldout.npy")
