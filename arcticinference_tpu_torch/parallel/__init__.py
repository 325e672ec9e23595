"""Tensor, Ulysses sequence, shift, data and pipeline parallelism on
``torch.distributed``.

Counterpart of ``arcticinference_tpu/parallel/``: ``mesh.py`` (the rank's
mesh coordinates, its process groups and the parameter / cache cuts),
``ulysses.py`` (the per-mode forward hooks, the sharded forward and the
dp gather around it), ``pp.py`` (the GPipe forward of a stage), ``world.py`` (starting a world of ranks in one call, the stand-in for the
JAX package's single controller) and ``multihost.py`` (a served mesh: the
leader's step broadcast, the follower mirror and the watchdog).

A mesh runs one process per rank.  Offline, every rank builds the same
``LLM`` and makes the same calls.  Served, one command runs per rank
with ``--multihost-*`` (``serving/openai_server.py``): process 0 serves
HTTP and broadcasts each device step, the others replay it.  Ranks that
share one card (or the CPU) join over gloo, whose collectives are staged
through host memory, so their step times measure gloo; ranks with a
card each join over NCCL.
"""
