"""Model FLOPs utilization: the model operations that the benchmark counts
for the untraced window's images or frames (all convolutions and the dense
box predictor; training counts backward too), over that window's host
seconds, over the peak of the configuration's compute type, in %. The
window is the one the end-to-end rate is measured on, not the traced one,
in which the profiler slows the host."""


def read(ctx):
    if not ctx.rate_units:
        return None
    return ctx.model_flops / ctx.rate_window_s / ctx.peak_flops * 100.0
