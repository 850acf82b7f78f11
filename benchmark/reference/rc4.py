"""The plain reference of the R-C4 detector (``archs/rc4.py``): Faster R-CNN
with ResNet bottlenecks and frozen affines (the 3x3 conv strided) from the
stem to res4, a 3x3 RPN conv with 1x1 objectness and delta heads over
stride-16 anchors, and res5 on RoIAlign crops of the stride-16 map,
averaged, as the box head before a softmax classifier and class-wise
deltas. What every two-stage reference shares is ``reference/rcnn.py``'s.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.archs.rc4 import Arch, STRIDE, block_convs, stages
from benchmark.reference import ops
from benchmark.reference.rcnn import TwoStageDetector


class Detector(TwoStageDetector):
    def __init__(self, arch: Arch, det: dict, weights: Dict[str, torch.Tensor],
                 precision: str, train: bool = False, channels_last: bool = True):
        super().__init__(det, weights, precision, train, channels_last)
        self.arch = arch

    def stage(self, x, prefix, blocks, cin, cout, width, stride):
        convs: Dict[str, dict] = {}
        for name, _ci, _co, k, s in block_convs(prefix, blocks, cin, cout, width, stride):
            block, part = name.rsplit(".", 1)
            convs.setdefault(block, {})[part] = (name, k, s)
        for block in convs.values():
            y = x
            for part in ("conv1", "conv2", "conv3"):
                name, k, s = block[part]
                y = self.affine(self.conv(y, name, s, k // 2), name[:-5] + "norm" + part[-1])
                if part != "conv3":
                    y = torch.relu(y)
            shortcut = x
            if "shortcut" in block:
                name, _k, s = block["shortcut"]
                shortcut = self.affine(self.conv(x, name, s), name + "_norm")
            x = torch.relu(shortcut + y)
        return x

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H/16, W/16, C4) contiguous."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=self.layout)
        x = torch.relu(self.affine(self.conv(x, "backbone.stem_conv", 2, 3), "backbone.stem_norm"))
        x = F.max_pool2d(x, 3, 2, 1)
        for st in stages(self.arch)[:3]:
            x = self.stage(x, *st)
        return x.permute(0, 2, 3, 1).contiguous()

    def rpn(self, feats):
        n = feats.shape[0]
        x = feats.permute(0, 3, 1, 2).contiguous(memory_format=self.layout)
        t = torch.relu(self.conv(x, "rpn_head.conv", 1, 1, bias=True))
        logits = self.conv(t, "rpn_head.objectness", bias=True).permute(0, 2, 3, 1).reshape(n, -1)
        deltas = self.conv(t, "rpn_head.deltas", bias=True).permute(0, 2, 3, 1).reshape(n, -1, 4)
        return logits, deltas

    def anchors(self, feats):
        d = self.det
        return ops.anchors(feats.shape[1:3], STRIDE, d["anchor_sizes"], d["anchor_ratios"],
                           feats.device)

    def pool(self, feats, boxes):
        """feats (N, h, w, C), boxes (N, P, 4) -> (N * P, S, S, C): RoIAlign
        crops of the stride-16 map, S the pool size, 2 x 2 samples a bin."""
        n, p = boxes.shape[:2]
        img = torch.arange(n, device=boxes.device, dtype=torch.int32).repeat_interleave(p)
        return ops.roi_align(feats, (boxes / STRIDE).reshape(n * p, 4), img,
                             self.det["roi_pool_size"], 2)

    def box_head(self, feats, boxes):
        d = self.det
        n, p = boxes.shape[:2]
        x = self.pool(feats, boxes).permute(0, 3, 1, 2).contiguous(memory_format=self.layout)
        x = self.stage(x, *stages(self.arch)[3]).mean(dim=(2, 3))
        logits = self.dense(x, "cls_score").reshape(n, p, -1)
        deltas = self.dense(x, "bbox_pred").reshape(n, p, d["num_classes"], 4)
        return logits, deltas
