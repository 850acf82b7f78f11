"""The traced window: ``torch.profiler`` around it, the harness's own spans
inside it, and the reduction of the trace to device intervals.

``Tracer`` is a no-op when tracing is off. ``DeviceTrace`` holds, within
the window, every device activity (kernels, copies, sets) with the name
of the host operation that launched it, and the host's operations on the
window's thread; it gives the union of device time (busy seconds), time by
kernel, and the longest idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Tuple

import numpy as np

WINDOW = "bench.window"
TOP = 10


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def window(self, traced: bool = True):
        if not (self.enabled and traced):
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield
        self.prof = prof

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


def short_name(name: str, width: int = 64) -> str:
    """A stable label: runs of characters outside [A-Za-z0-9_:.>] become one
    underscore, cut to ``width``."""
    return re.sub(r"[^A-Za-z0-9_:.>]+", "_", name)[:width]


class DeviceTrace:
    """Arrays in seconds from the window's start."""

    def __init__(self, window_s: float, dev: List[Tuple[str, float, float, str]],
                 host: List[Tuple[str, float, float]]):
        self.window_s = window_s
        self.dev_name = [d[0] for d in dev]
        self.dev_start = np.asarray([d[1] for d in dev], np.float64)
        self.dev_end = np.asarray([d[2] for d in dev], np.float64)
        self.dev_op = [d[3] for d in dev]
        self.host_name = [h[0] for h in host]
        self.host_start = np.asarray([h[1] for h in host], np.float64)
        self.host_end = np.asarray([h[2] for h in host], np.float64)

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        window = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
        if not window:
            raise RuntimeError("the trace holds no window span")
        w0 = window[0].start_ns()
        w1 = w0 + window[0].duration_ns()
        main = window[0].start_thread_id()
        op_of: Dict[int, str] = {}
        host = []
        dev_raw = []
        for e in events:
            if e.device_type() == DeviceType.CPU:
                if not e.name().startswith("cu"):  # runtime calls have ids of their own
                    op_of[e.correlation_id()] = e.name()
                if e.start_thread_id() == main and e.name() != WINDOW:
                    start = e.start_ns()
                    host.append((e.name(), (start - w0) * 1e-9,
                                 (start + e.duration_ns() - w0) * 1e-9))
            elif (e.duration_ns() > 0 and not e.is_user_annotation()
                  and not e.name().startswith("bench.")):  # spans mirrored on the device
                dev_raw.append(e)
        dev = []
        for e in dev_raw:
            start = max(e.start_ns(), w0)
            end = min(e.start_ns() + e.duration_ns(), w1)
            if end > start:
                dev.append((e.name(), (start - w0) * 1e-9, (end - w0) * 1e-9,
                            op_of.get(e.linked_correlation_id(), "")))
        return cls((w1 - w0) * 1e-9, dev, host)

    def busy_intervals(self) -> np.ndarray:
        """The union of device activity: (k, 2) disjoint [start, end)."""
        if not len(self.dev_start):
            return np.zeros((0, 2))
        order = np.argsort(self.dev_start, kind="stable")
        starts, ends = self.dev_start[order], np.maximum.accumulate(self.dev_end[order])
        new = np.ones(len(starts), bool)
        new[1:] = starts[1:] > ends[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, len(starts) - 1)
        return np.stack([starts[first], ends[last]], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum())

    def device_s(self, keep: Callable[[str, str], bool]) -> float:
        """Summed time of the device activities for which keep(name, op)."""
        return float(sum(e - s for n, s, e, o in zip(self.dev_name, self.dev_start,
                                                      self.dev_end, self.dev_op) if keep(n, o)))

    def device_ops(self, top: int = TOP) -> List[list]:
        totals: Dict[str, float] = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            key = short_name(n)
            totals[key] = totals.get(key, 0.0) + float(e - s)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = TOP) -> List[list]:
        """The longest stretches with no device activity, each labelled by
        the harness span and the innermost host operation that covered
        its middle on the window's thread."""
        iv = self.busy_intervals()
        edges = np.concatenate([[0.0], iv.ravel(), [self.window_s]]).reshape(-1, 2)
        lengths = edges[:, 1] - edges[:, 0]
        out = []
        for k in np.argsort(-lengths, kind="stable")[:top]:
            if lengths[k] <= 0:
                break
            out.append([self.host_label(0.5 * (edges[k, 0] + edges[k, 1])), float(lengths[k])])
        return out

    def host_label(self, t: float) -> str:
        cover = np.flatnonzero((self.host_start <= t) & (self.host_end >= t))
        if not len(cover):
            return "host_idle"
        spans = [i for i in cover if self.host_name[i].startswith("bench.")]
        inner = min(cover, key=lambda i: self.host_end[i] - self.host_start[i])
        names = [self.host_name[spans[0]]] if spans else []
        if self.host_name[inner] not in names:
            names.append(self.host_name[inner])
        return short_name(">".join(names))

