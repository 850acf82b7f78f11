"""Kernel timing and the least time the card could take.

``cuda_median_ms`` times calls with CUDA events; ``bound`` computes a
call's bound from its tensors and the published peaks of one NVIDIA
H100 SXM. ``chip_smoke.py`` and ``tspn_tpu_torch.tools`` share them.
"""

from __future__ import annotations

import statistics
import time

import torch

# published NVIDIA H100 SXM peaks (dense): HBM3 bytes/s, int8, bf16 and
# TF32 tensor-core op/s, f32 op/s on the CUDA cores
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}
WARMUP, ITERS, REPS = 3, 20, 5


def cuda_times_ms(fn, warmup: int = WARMUP, iters: int = ITERS, reps: int = REPS) -> list:
    """Device time of one ``fn()`` in each of ``reps`` runs of ``iters``
    back-to-back calls, each run timed with CUDA events and divided by
    ``iters``. A device-side sleep ahead of each run lets the host queue
    all its launches first, so host launch latency (tens of microseconds
    through the Python wrappers) is not timed. ``fn`` is called ``warmup +
    iters * reps`` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # about 25 ms of device time
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def cuda_median_ms(fn, warmup: int = WARMUP, iters: int = ITERS, reps: int = REPS) -> float:
    """The median of ``cuda_times_ms``."""
    return statistics.median(cuda_times_ms(fn, warmup, iters, reps))


def times_ms(fn, device: torch.device) -> list:
    """``cuda_times_ms`` on a CUDA device; on the CPU the host-clock times
    of ``REPS`` single calls after one warm-up (CPU times, never device
    times)."""
    if device.type == "cuda":
        return cuda_times_ms(fn)
    fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median_ms(fn, device: torch.device) -> float:
    """The median of ``times_ms``."""
    return statistics.median(times_ms(fn, device))


def bound(tensors, out, ops, kind: str = None) -> dict:
    """Least time the card could take for a call: the larger of its bytes
    (each input read once, the output written once) over the HBM rate and
    its operations over the peak rate of their type: ``ops`` of type
    ``kind`` (a key of PEAK), or a dict {kind: ops} whose times add."""
    parts = ops if isinstance(ops, dict) else {kind: ops}
    moved = sum(t.numel() * t.element_size() for t in tensors) + out.numel() * out.element_size()
    bytes_ms = moved / PEAK["bytes"] * 1e3
    ops_ms = sum(n / PEAK[k] * 1e3 for k, n in parts.items())
    ops = sum(parts.values())
    return {"bytes": moved, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
