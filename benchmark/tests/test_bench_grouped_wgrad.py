"""``grouped_wgrad_roofline``'s reader on a synthetic trace: it counts the
device time of the kernels launched inside the port's
``tspn.conv2d.grouped_wgrad`` spans and nothing else, and reads None where
the trace has no such kernel (a program without the span) or the
architecture counts no grouped convolutions (R-C4)."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import conv_roofline
from benchmark.trace import DeviceTrace

SPAN = "tspn.conv2d.grouped_wgrad"


def _ctx(dev, work):
    return SimpleNamespace(kind="train", trace=DeviceTrace(10.0, dev, []), work=work,
                           peak_flops=67e12)


def test_reads_the_spans_kernels_only():
    read = harness.metric_reader("grouped_wgrad_roofline.train").read
    dev = [("grouped_wgrad_kernel", 1.0, 1.5, SPAN), ("grouped_wgrad_reduce", 1.5, 1.6, SPAN),
           ("wgrad2d_grouped_direct_kernel", 2.0, 4.0, "aten::convolution_backward"),
           ("implicit_convolve_sgemm", 4.0, 5.0, "aten::cudnn_convolution")]
    # 3 x 67 TFLOP of grouped convs: a third is the weight gradient's, 1 s at peak
    assert read(_ctx(dev, {"grouped_conv_flops": 3 * 67e12})) == pytest.approx(100.0 / 0.6)
    # the span's kernels count as convolution time too
    assert all(conv_roofline.is_conv(n, o) for n, _s, _e, o in dev)
    assert read(_ctx(dev[2:], {"grouped_conv_flops": 3 * 67e12})) is None
    assert read(_ctx(dev, {"conv_flops": 67e12})) is None
    ctx = _ctx(dev, {"grouped_conv_flops": 3 * 67e12})
    ctx.trace = None
    assert read(ctx) is None
