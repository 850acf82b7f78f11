"""Share of the grouped convolutions' weight-gradient roofline: a third of
the grouped convolutions' operations that the benchmark counts for the
window's training images (the architecture counts forward, input gradient
and weight gradient alike), over the peak of the compute type, over the
device time of the kernels launched inside the port's
``tspn.conv2d.grouped_wgrad`` spans, in %. None where the trace holds no
such span or the architecture counts no grouped convolutions."""

SPAN = "tspn.conv2d.grouped_wgrad"


def read(ctx):
    flops = ctx.work.get("grouped_conv_flops")
    if ctx.trace is None or not flops:
        return None
    seconds = ctx.trace.device_s(lambda name, op: op == SPAN)
    if seconds <= 0:
        return None
    return flops / 3 / ctx.peak_flops / seconds * 100.0
