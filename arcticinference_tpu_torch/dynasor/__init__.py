"""Dynasor for the port: the chain-of-thought early-exit proxy
(``proxy.py``), its launcher, and the answer evaluator and certainty logic
it runs (copies of the JAX package's pure-Python modules)."""
