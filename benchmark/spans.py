"""The program's own spans in a traced window.

The port records named host spans (``tspn.*``, ``tspn_tpu_torch/runtime/
spans.py``) into the profiler's buffer, so ``DeviceTrace`` holds them among
the host operations of the window's thread, on the device trace's clock.
Here they become intervals in seconds from the window's start, the
device's idle time inside them, and a summary by span name.
"""

from __future__ import annotations

import weakref
from typing import Dict

import numpy as np

PREFIX = "tspn."
NMS = "tspn.nms"
NMS_SYNC = "tspn.nms.sync"

_BY_NAME: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def by_name(trace) -> Dict[str, np.ndarray]:
    """The program's spans of each name that start in the window, their
    ends cut at the window's end: (k, 2) [start, end) in start order. One
    pass over the window's host events, kept for the trace's lifetime, so
    the readers of one run share it."""
    if trace in _BY_NAME:
        return _BY_NAME[trace]
    rows: Dict[str, list] = {}
    for i, n in enumerate(trace.host_name):
        if n.startswith(PREFIX):
            rows.setdefault(n, []).append(i)
    out = {}
    for name, idx in rows.items():
        starts, ends = trace.host_start[idx], trace.host_end[idx]
        inside = (starts >= 0.0) & (starts < trace.window_s)
        iv = np.stack([starts[inside], np.minimum(ends[inside], trace.window_s)], axis=1)
        if len(iv):
            out[name] = iv[np.argsort(iv[:, 0], kind="stable")]
    _BY_NAME[trace] = out
    return out


def intervals(trace, name: str) -> np.ndarray:
    """The spans named ``name`` (``by_name``); none: (0, 2)."""
    return by_name(trace).get(name, np.zeros((0, 2)))


def union(iv: np.ndarray) -> np.ndarray:
    """Disjoint [start, end) covering the same time as the rows of ``iv``."""
    if not len(iv):
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    return np.stack([iv[first, 0], ends[last]], axis=1)


def busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Device-busy seconds in [0, t) for each t, from disjoint sorted busy
    intervals."""
    t = np.asarray(t, np.float64)
    if not len(busy):
        return np.zeros_like(t)
    lengths = busy[:, 1] - busy[:, 0]
    done = np.concatenate([[0.0], np.cumsum(lengths)])
    k = np.searchsorted(busy[:, 0], t, side="right")  # intervals starting at or before t
    prev = np.maximum(k - 1, 0)
    partial = np.clip(t - busy[prev, 0], 0.0, lengths[prev])
    return np.where(k > 0, done[prev] + partial, 0.0)


def idle_inside(busy: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Seconds of each row of ``iv`` that no device activity covers."""
    if not len(iv):
        return np.zeros(0)
    covered = busy_before(busy, iv[:, 1]) - busy_before(busy, iv[:, 0])
    return (iv[:, 1] - iv[:, 0]) - covered


def summary(trace) -> Dict[str, dict]:
    """For each of the program's span names: how many start in the window,
    their host seconds, their self seconds (less the spans nested directly
    inside them) and the device's idle seconds inside them."""
    spans = by_name(trace)
    names = sorted(spans)
    rows = [(name, s, e) for name in names for s, e in spans[name]]
    rows.sort(key=lambda r: (r[1], -r[2]))
    child_s = [0.0] * len(rows)
    stack: list = []
    for i, (_, s, e) in enumerate(rows):
        while stack and rows[stack[-1]][2] <= s:
            stack.pop()
        if stack and e <= rows[stack[-1]][2]:
            child_s[stack[-1]] += e - s
        stack.append(i)
    busy = trace.busy_intervals()
    idle = idle_inside(busy, np.asarray([[s, e] for _, s, e in rows]).reshape(-1, 2))
    out = {name: {"count": 0, "host_s": 0.0, "self_s": 0.0, "idle_s": 0.0} for name in names}
    for (name, s, e), child, gap in zip(rows, child_s, idle):
        row = out[name]
        row["count"] += 1
        row["host_s"] += float(e - s)
        row["self_s"] += float(e - s - child)
        row["idle_s"] += float(gap)
    return out
