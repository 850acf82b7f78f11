"""Device milliseconds of host-to-device copies per image (training) or
frame (detection) in the traced window: the profiler's ``Memcpy HtoD``
activities."""


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    seconds = ctx.trace.device_s(lambda name, op: "Memcpy HtoD" in name)
    return seconds / ctx.units * 1e3 if seconds > 0 else None
