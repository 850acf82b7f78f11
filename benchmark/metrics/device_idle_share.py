"""Share of the traced window that no device activity covers (the union of
kernels, copies and sets), in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.busy_s()
    if busy <= 0:
        return None
    return (1.0 - busy / ctx.trace.window_s) * 100.0
