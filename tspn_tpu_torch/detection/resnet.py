"""ResNet and ResNeXt backbones for Faster R-CNN (the C4 split is the
counterpart of tspn_tpu/detection/resnet.py).

Bottleneck stages with frozen-BN affines (detectron2's
FrozenBatchNorm2d). The C4 split: stem + res2-res4 give the stride-16,
1024-channel feature map, and res5 is the RoI head (2048 channels).
``ResNetBackbone`` runs stem to res5 and returns all four stages' maps
(the FPN's input), with ``groups`` groups in each bottleneck's 3x3 conv
(ResNeXt; detectron2's NUM_GROUPS and WIDTH_PER_GROUP). Modules take and
give NCHW tensors, as torch convs do; run them channels-last on the card
(``model.to(memory_format=torch.channels_last)``), so the backbone's
output is already the (N, H, W, C) map that RoIAlign reads. Parameter
names follow the flax tree (``stem_conv``, ``res2.block0.conv1``, ...),
so a JAX checkpoint maps across by name.

``dtype`` is the compute type, as flax's ``dtype=``: parameters stay f32,
and each conv and Dense casts its input and weight to the compute type
(bias added after, as flax adds it); FrozenAffine casts scale and bias and
keeps the multiply and the add as two rounded ops. Explicit casts, not
``torch.autocast``, whose op lists are not flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tspn_tpu_torch.ops.grouped_conv import grouped_conv2d

# stage depths (26 = one bottleneck per stage, for tests/smoke)
RESNET_DEPTHS = {
    26: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenAffine(nn.Module):
    """Per-channel scale + bias over NCHW (FrozenBatchNorm equivalent)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return x * self.scale.to(dt)[:, None, None] + self.bias.to(dt)[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``dtype`` (flax ``nn.Conv(dtype=...)``). A
    grouped conv is ``ops/grouped_conv.py::grouped_conv2d``: it runs in NCHW
    and gives its output back channels-last (cuDNN's channels-last grouped
    kernels in f32 are several times slower: on an H100 its grouped weight
    gradient at res2's shape took 7x the NCHW one's time, and ResNeXt-101
    FPN's training step 2.5x), and its weight gradient is a kernel of the
    port's own."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.groups == 1:
            y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        else:
            y = grouped_conv2d(x.to(dt).contiguous(), self.weight.to(dt).contiguous(),
                               self.stride, self.padding, self.groups)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          dtype: torch.dtype = torch.float32, groups: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, dtype=dtype,
                  groups=groups)


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided, in ``groups`` groups), 1x1, each with a frozen
    affine, and the shortcut (a strided 1x1 where the shape changes)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        self.has_shortcut = in_channels != out_channels or stride != 1
        if self.has_shortcut:
            # 1x1 at the block's stride, no padding
            self.shortcut = _conv(in_channels, out_channels, 1, stride, dtype=dtype)
            self.shortcut_norm = FrozenAffine(out_channels, dtype)
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, dtype=dtype)
        self.norm1 = FrozenAffine(bottleneck_channels, dtype)
        # the stride is on the 3x3, with explicit (1, 1) padding
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, stride, 1, dtype, groups)
        self.norm2 = FrozenAffine(bottleneck_channels, dtype)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.norm3 = FrozenAffine(out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_shortcut:
            shortcut = self.shortcut_norm(self.shortcut(x))
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return torch.relu(shortcut + y)


class ResStage(nn.Module):
    def __init__(self, num_blocks: int, in_channels: int, out_channels: int,
                 bottleneck_channels: int, first_stride: int = 2,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_channels if i == 0 else out_channels, out_channels,
                bottleneck_channels, stride=first_stride if i == 0 else 1, dtype=dtype,
                groups=groups,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class ResNetC4Backbone(nn.Module):
    """stem + res2..res4: images (N, 3, H, W) -> (N, 1024, H/16, W/16)."""

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.float32):
        super().__init__()
        d2, d3, d4, _ = RESNET_DEPTHS[depth]
        self.stem_conv = _conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.stem_norm = FrozenAffine(64, dtype)
        # torch pads the max-pool with -inf, as flax does
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        self.res2 = ResStage(d2, 64, 256, 64, first_stride=1, dtype=dtype)
        self.res3 = ResStage(d3, 256, 512, 128, dtype=dtype)
        self.res4 = ResStage(d4, 512, 1024, 256, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem_norm(self.stem_conv(images)))
        x = self.pool(x)
        return self.res4(self.res3(self.res2(x)))


class Res5Head(nn.Module):
    """res5 on RoI features: (R, 1024, 14, 14) -> (R, 2048) through the
    stride-2 stage and a mean over the spatial axes (the C4 box head)."""

    def __init__(self, depth: int = 101, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res5 = ResStage(RESNET_DEPTHS[depth][3], 1024, 2048, 512, first_stride=2,
                             dtype=dtype)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        return self.res5(roi_feats).mean(dim=(2, 3))


class ResNetBackbone(nn.Module):
    """stem + res2..res5: images (N, 3, H, W) -> [res2, res3, res4, res5]
    at strides 4, 8, 16 and 32 with 256, 512, 1024 and 2048 channels.
    Each 3x3 conv has ``groups`` groups (detectron2's rule: the bottleneck
    width is NUM_GROUPS * WIDTH_PER_GROUP in res2 and doubles each stage);
    32 x 8 is ResNeXt-101 32x8d, 1 x 64 plain ResNet."""

    def __init__(self, depth: int = 101, groups: int = 32, width_per_group: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_conv = _conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.stem_norm = FrozenAffine(64, dtype)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        cin, width = 64, groups * width_per_group
        for i, blocks in enumerate(RESNET_DEPTHS[depth]):
            self.add_module(f"res{i + 2}", ResStage(
                blocks, cin, 256 << i, width << i, first_stride=1 if i == 0 else 2,
                dtype=dtype, groups=groups))
            cin = 256 << i

    def forward(self, images: torch.Tensor) -> list:
        x = self.pool(torch.relu(self.stem_norm(self.stem_conv(images))))
        out = []
        for stage in (self.res2, self.res3, self.res4, self.res5):
            x = stage(x)
            out.append(x)
        return out
