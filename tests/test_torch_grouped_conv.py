"""The grouped 3x3 conv of ResNeXt's bottlenecks (``ops/grouped_conv.py``)
on the CPU: the autograd op that ``detection/resnet.py::Conv2d`` runs where
``groups > 1``, its plain weight gradient, and the kernel's plan.

Tolerance. The forward is ``F.conv2d``'s own call and dX the same
``aten::convolution_backward`` as autograd's, so both are compared bit for
bit. dW comes from ``grouped_wgrad_plain`` (im2col and one product a group)
where autograd runs the library's own weight gradient: both sum the same
N Ho Wo float32 products in another order, so each term may differ by a few
ulps of the sum of its products' magnitudes, T (the plain weight gradient of
|x| and |dY|): the bound is 1e-5 T + 1e-7.
"""

import pytest
import torch
import torch.nn.functional as F

from tspn_tpu_torch.detection.resnet import Conv2d
from tspn_tpu_torch.ops import grouped_conv as gc

# (groups, channels a group, input H, W, stride): Cg 8, 16, 32 and 64 as in
# ResNeXt-101 32x8d's res2-res5, stride 1 and 2, an odd 25 x 42 map, Cg 4
# (the CPU FPN tests' res2), and groups 1, which stays off the op
CASES = [(8, 8, 12, 20, 1), (4, 16, 9, 14, 2), (2, 32, 25, 42, 1), (2, 64, 7, 11, 1),
         (2, 64, 25, 42, 2), (4, 4, 10, 13, 1), (1, 32, 9, 10, 1)]


def _wgrad_bound(x, dy, shape, stride, groups):
    terms = gc.grouped_wgrad_plain(x.abs(), dy.abs(), shape, stride, 1, groups)
    return 1e-5 * terms + 1e-7


@pytest.mark.parametrize("groups,cg,h,w,stride", CASES)
def test_grouped_conv_equals_conv2d_autograd(groups, cg, h, w, stride):
    gen = torch.Generator().manual_seed(groups * 1000 + cg + h + stride)
    c = groups * cg
    conv = Conv2d(c, c, 3, stride=stride, padding=1, bias=False, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.1)
    x = torch.randn(2, c, h, w, generator=gen).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = conv(x)
    enters = type(y.grad_fn).__name__ == "_GroupedConv2dBackward"
    assert enters == (groups > 1)

    xr = x.detach().clone().requires_grad_(True)
    wr = conv.weight.detach().clone().requires_grad_(True)
    # the dense path convolves the channels-last input as it comes
    yr = F.conv2d(xr.contiguous() if groups > 1 else xr, wr, None, stride, 1, 1, groups)
    assert torch.equal(y, yr)
    assert y.is_contiguous(memory_format=torch.channels_last)

    gy = torch.randn(y.shape, generator=gen).contiguous(memory_format=torch.channels_last)
    y.backward(gy)
    yr.backward(gy)
    assert torch.equal(x.grad, xr.grad)
    bound = _wgrad_bound(x.detach(), gy, tuple(wr.shape), stride, groups)
    assert bool(((conv.weight.grad - wr.grad).abs() <= bound).all())
    plain = gc.grouped_wgrad_plain(x.detach().contiguous(), gy.contiguous(), tuple(wr.shape),
                                   stride, 1, groups)
    assert bool(((plain - wr.grad).abs() <= bound).all())


# ResNeXt-101 32x8d's grouped convs at the training cell's geometry (4
# images of 800 x 1344): (stage, C, Cg, input H, W, stride, tw, ksplit)
STAGES = [("res2", 256, 8, 200, 336, 1, 48, 66), ("res3_first", 512, 16, 200, 336, 2, 28, 33),
          ("res3", 512, 16, 100, 168, 1, 42, 33), ("res4_first", 1024, 32, 100, 168, 2, 28, 16),
          ("res4", 1024, 32, 50, 84, 1, 42, 16), ("res5_first", 2048, 64, 50, 84, 2, 22, 4),
          ("res5", 2048, 64, 25, 42, 1, 42, 4)]


@pytest.mark.parametrize("stage,c,cg,h,w,stride,tw,ksplit", STAGES)
def test_plan_at_the_stages(stage, c, cg, h, w, stride, tw, ksplit):
    """Two blocks an SM on 132 SMs at most, tiles of even width that cut
    the output row evenly, and a stage that fits."""
    plan = gc.grouped_wgrad_plan(4, c, h, w, cg, stride, 132)
    wo = (w - 1) // stride + 1
    assert (plan.tw, plan.ksplit) == (tw, ksplit)
    assert plan.blocks <= 264 and plan.tw % 2 == 0 and -(-wo // plan.tw) * plan.tw - wo < 4
    co_span = 64 // cg * 8 * (min(cg, 32) // 8)
    assert gc._stage_floats(plan.tw, stride, co_span) <= gc.STAGE_FLOATS
    assert plan.ws_floats == plan.ksplit * plan.phases * c * cg * 9


def test_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(1, 64, 8, 8)
    dy = torch.zeros(1, 64, 8, 8)
    with pytest.raises(TypeError):
        gc._grouped_wgrad_cuda(x.double(), dy.double(), (64, 8, 3, 3), 1, 1, 8)
    for shape, stride, padding, groups in (((64, 8, 5, 5), 1, 1, 8), ((64, 8, 3, 3), 3, 1, 8),
                                           ((64, 8, 3, 3), 1, 2, 8), ((64, 4, 3, 3), 1, 1, 16),
                                           ((64, 8, 3, 3), (1, 2), 1, 8)):
        with pytest.raises(ValueError):
            gc._grouped_wgrad_cuda(x, dy, shape, stride, padding, groups)
