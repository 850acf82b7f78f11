"""The plain reference of the X101-32x8d-FPN detector (``archs/fpn.py``):
Faster R-CNN with ResNeXt bottlenecks (each 3x3 conv grouped, by
``F.conv2d(groups=...)``, and strided) and frozen affines from the stem to
res5, an FPN (lateral 1x1 and output 3x3 convs with bias, a top-down path
of 2x nearest upsampling and adds, P6 by a 1x1 max-pool of stride 2), an
RPN head shared by P2-P6 over each level's anchor sizes, proposals from the
top-k of each level by one NMS with the levels moved apart, and a box head
that pools each RoI from one of P2-P5 by its size (7x7, 2x2 samples a bin,
the plain RoIAlign of ``reference/ops.py`` level by level) before two FC
layers of 1024. What every two-stage reference shares is
``reference/rcnn.py``'s.

Departures from detectron2 (``faster_rcnn_X_101_32x8d_FPN_3x.yaml``), all
the program's too: pixels in [0, 1] with no mean; every layer trained
(FREEZE_AT 0); anchors centred at +0.5; a fixed 2 x 2 samples a bin (not
ceil(RoI side / 7)); box deltas unweighted; the deterministic samplers of
``reference/rcnn.py``; top-k by a stable sort; fc1 reads the pooled RoI
flattened as (y, x, channel), not as (channel, y, x) (a permutation of
fc1's input columns).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.archs.fpn import STRIDES, Arch, block_convs, stages
from benchmark.reference import ops
from benchmark.reference.rcnn import TwoStageDetector

# detectron2's ROIPooler: a RoI of side 224 pools from P4
CANONICAL_SIZE, CANONICAL_LEVEL = 224.0, 4


class Detector(TwoStageDetector):
    def __init__(self, arch: Arch, det: dict, weights: Dict[str, torch.Tensor],
                 precision: str, train: bool = False, channels_last: bool = True):
        super().__init__(det, weights, precision, train, channels_last)
        self.arch = arch
        self.level_sizes = []  # anchors of each level, set by ``anchors``

    def gconv(self, x, name: str, stride: int, padding: int, groups: int):
        """A grouped conv in NCHW, its output in the layout of the rest (f32
        channels-last grouped kernels are several times slower)."""
        return F.conv2d(ops.operand(x, self.precision).contiguous(),
                        ops.operand(self.w[f"{name}.weight"], self.precision).contiguous(),
                        None, stride, padding, 1, groups).contiguous(memory_format=self.layout)

    def stage(self, x, prefix, blocks, cin, cout, width, stride):
        convs: Dict[str, dict] = {}
        for name, _ci, _co, k, s, g in block_convs(prefix, blocks, cin, cout, width, stride,
                                                   self.arch.groups):
            block, part = name.rsplit(".", 1)
            convs.setdefault(block, {})[part] = (name, k, s, g)
        for block in convs.values():
            y = x
            for part in ("conv1", "conv2", "conv3"):
                name, k, s, g = block[part]
                conv = self.gconv(y, name, s, k // 2, g) if g > 1 else self.conv(y, name, s, k // 2)
                y = self.affine(conv, name[:-5] + "norm" + part[-1])
                if part != "conv3":
                    y = torch.relu(y)
            shortcut = x
            if "shortcut" in block:
                name, _k, s, _g = block["shortcut"]
                shortcut = self.affine(self.conv(x, name, s), name + "_norm")
            x = torch.relu(shortcut + y)
        return x

    def features(self, images: torch.Tensor):
        """(N, H, W, 3) -> [P2, .., P6], each (N, 256, H/s, W/s)."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=self.layout)
        x = torch.relu(self.affine(self.conv(x, "backbone.stem_conv", 2, 3), "backbone.stem_norm"))
        x = F.max_pool2d(x, 3, 2, 1)
        res = []
        for st in stages(self.arch):
            x = self.stage(x, *st)
            res.append(x)
        prev = self.conv(res[3], "fpn.lateral5", bias=True)
        out = [self.conv(prev, "fpn.output5", 1, 1, bias=True)]
        for lvl in (4, 3, 2):
            prev = (self.conv(res[lvl - 2], f"fpn.lateral{lvl}", bias=True)
                    + F.interpolate(prev, scale_factor=2.0, mode="nearest"))
            out.insert(0, self.conv(prev, f"fpn.output{lvl}", 1, 1, bias=True))
        return out + [F.max_pool2d(out[-1], 1, 2)]

    def rpn(self, feats):
        logits, deltas = [], []
        for p in feats:
            n = p.shape[0]
            t = torch.relu(self.conv(p, "rpn_head.conv", 1, 1, bias=True))
            logits.append(self.conv(t, "rpn_head.objectness", bias=True)
                          .permute(0, 2, 3, 1).reshape(n, -1))
            deltas.append(self.conv(t, "rpn_head.deltas", bias=True)
                          .permute(0, 2, 3, 1).reshape(n, -1, 4))
        return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)

    def anchors(self, feats):
        d = self.det
        per = [ops.anchors(p.shape[2:], stride, sizes, d["anchor_ratios"], p.device)
               for p, stride, sizes in zip(feats, STRIDES, d["anchor_sizes"])]
        self.level_sizes = [len(a) for a in per]
        return torch.cat(per)

    def proposals(self, logits, deltas, anchors, image_hw, pre: int, post: int):
        """The ``pre`` best anchors of each level, decoded and clipped; one
        NMS over all of them, each level's boxes moved apart by an offset
        (as detectron2's ``batched_nms``) -> boxes (N, post, 4), mask."""
        n = logits.shape[0]
        scores, idx, level, start = [], [], [], 0
        for i, size in enumerate(self.level_sizes):
            s, k = torch.sort(logits[:, start: start + size], dim=-1, descending=True,
                              stable=True)
            k = k[:, :pre]
            scores.append(s[:, :pre])
            idx.append(k + start)
            level.append(torch.full((k.shape[1],), float(i), device=logits.device))
            start += size
        scores, idx = torch.cat(scores, dim=1), torch.cat(idx, dim=1)
        boxes = ops.decode(torch.gather(deltas, 1, idx[..., None].expand(n, idx.shape[1], 4)),
                           anchors[idx])
        boxes = ops.clip(boxes, image_hw[0], image_hw[1])
        ok = ((boxes[..., 2] - boxes[..., 0]) > 0.0) & ((boxes[..., 3] - boxes[..., 1]) > 0.0)
        offset = torch.cat(level)[None, :, None] * (max(image_hw) + 2.0)
        keep_idx, keep = ops.nms(boxes + offset, scores, self.det["rpn_nms_threshold"], post, ok)
        return torch.gather(boxes, 1, keep_idx[..., None].expand(*keep_idx.shape, 4)), keep

    def pool(self, feats, boxes):
        """feats [P2, ..], boxes (N, P, 4) -> (N * P, S, S, C): each RoI
        pooled from P2-P5 by detectron2's rule, floor(4 + log2(sqrt(area) /
        224 + 1e-8)) clamped to 2-5, level by level."""
        n, p = boxes.shape[:2]
        flat = boxes.reshape(n * p, 4)
        img = torch.arange(n, device=boxes.device, dtype=torch.int32).repeat_interleave(p)
        area = (flat[:, 2] - flat[:, 0]) * (flat[:, 3] - flat[:, 1])
        level = torch.floor(CANONICAL_LEVEL + torch.log2(torch.sqrt(area) / CANONICAL_SIZE
                                                         + 1e-8)).clamp(2, 5) - 2
        s = self.det["roi_pool_size"]
        out = feats[0].new_zeros((n * p, s, s, feats[0].shape[1]))
        for lvl in range(4):
            sel = torch.nonzero(level == lvl)[:, 0]
            if len(sel):
                fmap = feats[lvl].permute(0, 2, 3, 1)
                out = out.index_copy(0, sel, ops.roi_align(fmap, flat[sel] / STRIDES[lvl],
                                                           img[sel], s, 2))
        return out

    def box_head(self, feats, boxes):
        d = self.det
        n, p = boxes.shape[:2]
        x = self.pool(feats, boxes).reshape(n * p, -1)
        x = torch.relu(self.dense(torch.relu(self.dense(x, "box_head.fc1")), "box_head.fc2"))
        logits = self.dense(x, "cls_score").reshape(n, p, -1)
        deltas = self.dense(x, "bbox_pred").reshape(n, p, d["num_classes"], 4)
        return logits, deltas
