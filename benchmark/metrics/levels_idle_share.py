"""Share of the traced window in which the device is idle while the host
is inside the feature pyramid's levels (the union of the program's
``tspn.fpn``, ``tspn.rpn.levels`` and ``tspn.roi_levels`` spans: the
neck, the per-level proposals with their NMS, and the level assignment
with the multi-level RoIAlign), in %: the idle time put down to the
levels, at most ``device_idle_share`` of the same window. None where the
window holds no such span (a program without the FPN, or without its
spans)."""

import numpy as np

from benchmark import spans

LEVELS = ("tspn.fpn", "tspn.rpn.levels", "tspn.roi_levels")


def read(ctx):
    if ctx.trace is None:
        return None
    found = [spans.intervals(ctx.trace, name) for name in LEVELS]
    iv = spans.union(np.concatenate(found))
    if not len(iv):
        return None
    idle = spans.idle_inside(ctx.trace.busy_intervals(), iv)
    return float(idle.sum()) / ctx.trace.window_s * 100.0
