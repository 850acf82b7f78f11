"""Benchmark tools of the port, ported from the JAX package's ``tools/``,
and the NMS kernel's check inputs (``nms_cases``)."""
