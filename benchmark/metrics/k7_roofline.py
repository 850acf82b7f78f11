"""Share of RoIAlign's (K7's) roofline: the least bytes of the window's
RoIAlign calls (each map read once and each output written once; in
training also the output's gradient read once and the map's written once)
over the HBM rate, over the device time of K7's kernels (their names hold
``roi_align``), in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.device_s(lambda name, op: "roi_align" in name)
    if seconds <= 0:
        return None
    return ctx.k7_bytes / ctx.peak_bytes / seconds * 100.0
