"""Faster R-CNN with a ResNeXt backbone and a feature pyramid (detectron2's
``faster_rcnn_X_101_32x8d_FPN_3x``): inference and the training forward.

  images (N, H, W, 3) -> ResNeXt res2..res5 (grouped 3x3 convs)
                      -> FPN: P2..P5 (256 channels, strides 4-32) and P6
                      -> RPN over P2..P6: one shared head, one anchor size
                         a level (as many a level in general); the top-k of
                         each level, one NMS over all
                      -> each RoI to one of P2..P5 by its size, RoIAlign 7x7
                         (K7's levels form: one launch for all levels)
                      -> two FC layers of 1024 -> softmax + class-wise deltas

The sampling, the losses and the class-aware post-processing are
``FasterRCNN``'s; this class overrides the modules, the features, the RPN
over levels, the anchors, the proposals and the RoI forward. It computes
in float32 (bfloat16 is refused: no test holds it). Under a profiler the
neck is the span ``tspn.fpn`` (after ``tspn.backbone``), the proposals of
all levels ``tspn.rpn.levels`` (inside ``tspn.rpn``), and the level
assignment with the multi-level RoIAlign ``tspn.roi_levels`` (inside
``tspn.roi_head``).

Departures from detectron2 besides the R-C4 model's (pixels in [0, 1],
every layer trained, anchors at +0.5, 2 x 2 samples a bin, unweighted box
deltas, deterministic sampling): fc1's input is the pooled RoI flattened
as (y, x, channel), not detectron2's (channel, y, x), so a detectron2
checkpoint's fc1 columns would be permuted on loading.
"""

from __future__ import annotations

from collections import namedtuple

import torch
import torch.nn.functional as F
from torch import nn

from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.detection.resnet import Conv2d, Linear, ResNetBackbone
from tspn_tpu_torch.detection.rpn import (
    Proposals,
    RPNHead,
    make_anchors,
    select_level_proposals,
)
from tspn_tpu_torch.ops.roi_align import roi_align_levels
from tspn_tpu_torch.runtime.spans import span


STRIDES = (4, 8, 16, 32, 64)  # P2..P6
POOLED = 4                    # P2..P5 pool RoIs
# detectron2's ROIPooler: a RoI of side 224 pools from P4
CANONICAL_SIZE, CANONICAL_LEVEL = 224.0, 4


# DetectionConfig's fields but its single map's stride (the RPN, sampling and
# post-processing settings that FasterRCNN's shared steps read), then the
# neck's and the box head's; the defaults are X101-32x8d-FPN's under the
# VidVRD fine-tuning overrides (35 classes, 128 RoIs an image)
_FPN_DEFAULTS = {
    **{k: v for k, v in DetectionConfig()._replace(
        anchor_sizes=((32,), (64,), (128,), (256,), (512,)),  # a level's sizes
        post_nms_topk_train=1000, post_nms_topk_test=1000, roi_pool_size=7,
    )._asdict().items() if k != "stride"},
    "groups": 32, "width_per_group": 8, "fpn_channels": 256, "fc_dim": 1024,
}
FPNConfig = namedtuple("FPNConfig", _FPN_DEFAULTS, defaults=_FPN_DEFAULTS.values())
FPNConfig.__doc__ = """The X101-32x8d-FPN detector's settings. Top-k before NMS is a
level's, after NMS an image's."""


def assign_levels(boxes: torch.Tensor) -> torch.Tensor:
    """detectron2's ``assign_boxes_to_levels``: each box's level floor(4 +
    log2(sqrt(area) / 224 + 1e-8)) clamped to 2..5 -> (...,) int32 index
    into P2..P5, on the boxes' device."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    level = torch.floor(CANONICAL_LEVEL + torch.log2(torch.sqrt(area) / CANONICAL_SIZE + 1e-8))
    return (level.clamp(2, 1 + POOLED) - 2).to(torch.int32)


class FPN(nn.Module):
    """res2..res5 -> P2..P6: lateral 1x1 convs, a top-down path of 2x
    nearest upsampling and adds, 3x3 output convs (all with bias), and P6
    as a stride-2 subsample of P5 (detectron2's ``LastLevelMaxPool``)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for lvl, cin in enumerate(in_channels, start=2):
            self.add_module(f"lateral{lvl}", Conv2d(cin, channels, 1, dtype=dtype))
            self.add_module(f"output{lvl}", Conv2d(channels, channels, 3, padding=1,
                                                   dtype=dtype))

    def forward(self, feats: list) -> list:
        top = len(feats) + 1
        prev = getattr(self, f"lateral{top}")(feats[-1])
        out = [getattr(self, f"output{top}")(prev)]
        for lvl in range(top - 1, 1, -1):
            prev = (getattr(self, f"lateral{lvl}")(feats[lvl - 2])
                    + F.interpolate(prev, scale_factor=2.0, mode="nearest"))
            out.insert(0, getattr(self, f"output{lvl}")(prev))
        out.append(F.max_pool2d(out[-1], kernel_size=1, stride=2))
        return out


class BoxHead(nn.Module):
    """detectron2's ``FastRCNNConvFCHead`` with two FC layers: flattened
    RoI features -> fc1 -> ReLU -> fc2 -> ReLU."""

    def __init__(self, in_features: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, dim, dtype=dtype)
        self.fc2 = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))


class FPNFasterRCNN(FasterRCNN):
    """Faster R-CNN X101-32x8d-FPN on ``FasterRCNN``'s shared steps.
    ``roi_pool`` is the multi-level RoIAlign (``roi_align_levels``'s
    signature)."""

    def __init__(self, cfg: FPNConfig = FPNConfig(), generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        if dtype != torch.float32:
            raise ValueError(f"the FPN detector computes in float32, not {dtype}: no test "
                             "holds it in another type")
        super().__init__(cfg, generator, dtype)
        self.roi_pool = roi_align_levels
        self._anchor_cache: dict = {}  # map sizes -> (anchors, anchors a level)
        self._level_sizes: list = []

    def build(self, cfg: FPNConfig, dtype: torch.dtype) -> None:
        self.backbone = ResNetBackbone(cfg.depth, cfg.groups, cfg.width_per_group, dtype)
        self.fpn = FPN(channels=cfg.fpn_channels, dtype=dtype)
        if len({len(s) for s in cfg.anchor_sizes}) != 1:
            raise ValueError("every level needs as many anchor sizes: the RPN head is shared")
        self.rpn_head = RPNHead(cfg.fpn_channels,
                                len(cfg.anchor_sizes[0]) * len(cfg.anchor_ratios), dtype)
        self.box_head = BoxHead(cfg.fpn_channels * cfg.roi_pool_size ** 2, cfg.fc_dim, dtype)
        self.cls_score = Linear(cfg.fc_dim, cfg.num_classes + 1, dtype=dtype)
        self.bbox_pred = Linear(cfg.fc_dim, 4 * cfg.num_classes, dtype=dtype)

    def features(self, images: torch.Tensor) -> list:
        """(N, H, W, 3) images (sides multiples of 32) -> [P2, .., P6], each
        (N, 256, H/s, W/s) channels-last."""
        with span("tspn.backbone"):
            x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            res = self.backbone(x)
        with span("tspn.fpn"):
            return self.fpn(res)

    def _rpn(self, feats: list):
        logits, deltas = zip(*(self.rpn_head(p) for p in feats))
        return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)

    def anchors(self, feats: list) -> torch.Tensor:
        """Every level's anchors, level after level; kept on the device per
        set of map sizes, so a step copies none to the card. Records each
        level's count for ``proposals``."""
        key = (tuple(tuple(p.shape[2:]) for p in feats), feats[0].device)
        if key not in self._anchor_cache:
            c = self.cfg
            per_level = [make_anchors(p.shape[2], p.shape[3], stride, sizes, c.anchor_ratios,
                                      device=p.device)
                         for p, stride, sizes in zip(feats, STRIDES, c.anchor_sizes)]
            self._anchor_cache[key] = (torch.cat(per_level), [len(a) for a in per_level])
        anchors, self._level_sizes = self._anchor_cache[key]
        return anchors

    def proposals(self, logits, deltas, anchors, image_hw: tuple, pre_nms_topk: int,
                  post_nms_topk: int) -> Proposals:
        """The proposals of the levels that the last ``anchors`` call made."""
        with span("tspn.rpn.levels"):
            return select_level_proposals(logits, deltas, anchors, self._level_sizes,
                                          image_hw, pre_nms_topk, post_nms_topk,
                                          self.cfg.rpn_nms_threshold)

    def _roi_forward(self, feats: list, boxes: torch.Tensor):
        """feats [P2, .., P6], boxes (N, P, 4) image coords -> (cls_logits
        (N, P, C+1), deltas (N, P, C, 4))."""
        c = self.cfg
        n, p = boxes.shape[:2]
        with span("tspn.roi_head"):
            flat = boxes.reshape(n * p, 4)
            with span("tspn.roi_levels"):
                # each image's index p times (repeat_interleave would count
                # its output on the host)
                batch_idx = torch.arange(n, device=boxes.device, dtype=torch.int32
                                         )[:, None].expand(n, p).reshape(n * p)
                levels = assign_levels(flat)
                maps = [f.permute(0, 2, 3, 1) for f in feats[:POOLED]]
                pooled = self.roi_pool(maps, flat, batch_idx, levels,
                                       [1.0 / s for s in STRIDES[:POOLED]],
                                       c.roi_pool_size, 2)
            x = self.box_head(pooled.reshape(n * p, -1))
            cls_logits = self.cls_score(x).reshape(n, p, -1)
            deltas = self.bbox_pred(x).reshape(n, p, c.num_classes, 4)
            return cls_logits, deltas

