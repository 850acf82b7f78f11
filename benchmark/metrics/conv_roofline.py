"""Share of the convolutions' roofline: the convolution operations that the
benchmark counts for the window's images or frames (forward, and in
training both backward products) over the peak of the compute type,
over the device time of the kernels that convolution ops launched, in %.
"""


def is_conv(name: str, op: str) -> bool:
    return "convolution" in op or "conv2d" in op


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.device_s(is_conv)
    if seconds <= 0:
        return None
    return ctx.conv_flops / ctx.peak_flops / seconds * 100.0
