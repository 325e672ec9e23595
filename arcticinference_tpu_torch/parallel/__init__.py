"""Tensor, Ulysses sequence and shift parallelism on ``torch.distributed``.

Counterpart of ``arcticinference_tpu/parallel/``: ``mesh.py`` (the rank's
mesh coordinates, its process groups and the parameter / cache cuts),
``ulysses.py`` (the per-mode forward hooks and the sharded forward) and
``world.py`` (starting a world of ranks in one call, the stand-in for the
JAX package's single controller).  The pipeline (``pp.py``) and
multihost (``multihost.py``) modules are not ported yet.
"""
