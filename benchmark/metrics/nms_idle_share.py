"""Share of the traced window in which the device is idle while the host
is inside an NMS loop (a ``tspn.nms`` span), in %: the idle time put down
to the NMS loops, at most ``device_idle_share`` of the same window. None
where the window holds no such span."""

from benchmark import spans


def read(ctx):
    if ctx.trace is None:
        return None
    iv = spans.union(spans.intervals(ctx.trace, spans.NMS))
    if not len(iv):
        return None
    idle = spans.idle_inside(ctx.trace.busy_intervals(), iv)
    return float(idle.sum()) / ctx.trace.window_s * 100.0
