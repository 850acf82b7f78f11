"""Benchmark tools of the port, ported from the JAX package's ``tools/``."""
