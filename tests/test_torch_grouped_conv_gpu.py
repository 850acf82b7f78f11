"""The grouped convs' weight-gradient kernel (``csrc/grouped_wgrad.cu``)
on a card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_grouped_conv_gpu.py -q``.

* The kernel against ``grouped_wgrad_plain`` on the card (TF32 off) at
  ResNeXt-101 32x8d's grouped convs at the training cell's geometry (4
  images of 800 x 1344: res2-res5 and the strided first convs of res3-res5)
  and on small odd maps: within 1e-5 T + 1e-7, T the plain weight
  gradient of |x| and |dY|, as the two sum N Ho Wo float32 products in
  another order; a second run is bit-equal; one launch a call.
* The grouped conv's autograd op on the card: dX equal to ``F.conv2d``
  autograd's, dW within the same bound.
* ``LAUNCHES`` counts 33 a training step of X101-32x8d-FPN through
  ``train_detector``, and none in its detection or in R-C4's training.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tspn_tpu_torch.detection import train as dt
from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN
from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
from tspn_tpu_torch.detection.rcnn import DetectionConfig
from tspn_tpu_torch.detection.resnet import Conv2d
from tspn_tpu_torch.ops import grouped_conv as gc

pytestmark = pytest.mark.gpu

# (name, images, C, Cg, input H, W, stride)
GEOMETRIES = [("res2", 4, 256, 8, 200, 336, 1), ("res3_first", 4, 512, 16, 200, 336, 2),
              ("res3", 4, 512, 16, 100, 168, 1), ("res4_first", 4, 1024, 32, 100, 168, 2),
              ("res4", 4, 1024, 32, 50, 84, 1), ("res5_first", 4, 2048, 64, 50, 84, 2),
              ("res5", 4, 2048, 64, 25, 42, 1), ("odd_cg8", 1, 256, 8, 7, 9, 2),
              ("odd_cg64", 2, 128, 64, 3, 5, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped wgrad kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, c, h, w, stride, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.relu(torch.randn(n, c, h, w, device=dev, generator=g))
    dy = torch.randn(n, c, ho, wo, device=dev, generator=g) * 1e-3
    return x, dy


def _within(out, x, dy, shape, stride, groups):
    ref = gc.grouped_wgrad_plain(x, dy, shape, stride, 1, groups)
    terms = gc.grouped_wgrad_plain(x.abs(), dy.abs(), shape, stride, 1, groups)
    ratio = ((out.double() - ref.double()).abs() / (1e-5 * terms.double() + 1e-7)).max()
    return float(ratio)


@pytest.mark.parametrize("name,n,c,cg,h,w,stride", GEOMETRIES)
def test_kernel_within_plain_and_repeats(cuda_device, name, n, c, cg, h, w, stride):
    x, dy = _inputs(cuda_device, n, c, h, w, stride)
    shape = (c, cg, 3, 3)
    before = gc.LAUNCHES["grouped_wgrad"]
    out = gc.grouped_wgrad(x, dy, shape, stride, 1, c // cg)
    again = gc.grouped_wgrad(x, dy, shape, stride, 1, c // cg)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["grouped_wgrad"] == before + 2
    assert torch.equal(out, again)
    assert _within(out, x, dy, shape, stride, c // cg) <= 1.0


def test_autograd_op_on_the_card(cuda_device):
    c, cg, stride = 512, 16, 2
    g = torch.Generator(device=cuda_device).manual_seed(1)
    conv = Conv2d(c, c, 3, stride=stride, padding=1, bias=False, groups=c // cg).to(cuda_device)
    x = torch.randn(2, c, 30, 44, device=cuda_device, generator=g).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = conv(x)
    gy = torch.randn(y.shape, device=cuda_device, generator=g).contiguous(
        memory_format=torch.channels_last)
    before = gc.LAUNCHES["grouped_wgrad"]
    y.backward(gy)
    xr = x.detach().clone().requires_grad_(True)
    wr = conv.weight.detach().clone().requires_grad_(True)
    yr = F.conv2d(xr.contiguous(), wr, None, stride, 1, 1, c // cg)
    yr.backward(gy)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["grouped_wgrad"] == before + 1
    assert torch.equal(y, yr) and torch.equal(x.grad, xr.grad)
    assert _within(conv.weight.grad, x.detach().contiguous(), gy.contiguous(), tuple(wr.shape),
                   stride, c // cg) <= 1.0


def _records(n=4):
    rng = np.random.RandomState(0)
    return [{"image": (rng.rand(96, 128, 3) * 255).astype(np.uint8), "image_id": i,
             "height": 96, "width": 128,
             "annotations": [{"bbox": [10.0, 8.0, 70.0, 60.0], "category_id": i % 3,
                              "bbox_mode": "XYXY_ABS"}]} for i in range(n)]


def test_launches_a_training_step_of_x101_and_none_elsewhere(cuda_device):
    train_cfg = DetectorTrainConfig(ims_per_batch=2, max_iter=2, image_size=128, log_every=1)
    before = gc.LAUNCHES["grouped_wgrad"]
    quiet = logging.getLogger("grouped_conv_gpu")
    quiet.setLevel(logging.WARNING)
    model, _ = dt.train_detector(_records(), FPNConfig(num_classes=35), train_cfg,
                                 logger=quiet, device=cuda_device)
    torch.cuda.synchronize()
    assert isinstance(model, FPNFasterRCNN)
    assert gc.LAUNCHES["grouped_wgrad"] == before + 2 * 33

    before = gc.LAUNCHES["grouped_wgrad"]
    model.eval().detect(torch.rand(2, 96, 128, 3, device=cuda_device))
    dt.train_detector(_records(), DetectionConfig(num_classes=35, depth=26), train_cfg,
                      logger=quiet, device=cuda_device)
    torch.cuda.synchronize()
    assert gc.LAUNCHES["grouped_wgrad"] == before
