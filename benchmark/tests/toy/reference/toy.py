"""The plain reference of the toy architecture (``archs/toy.py``): R-C4's
reference with a two-layer FC box head on its RoIAlign crops, flattened,
in place of res5."""

from __future__ import annotations

import torch

from benchmark.reference import rc4


class Detector(rc4.Detector):
    def box_head(self, feats, boxes):
        d = self.det
        n, p = boxes.shape[:2]
        x = self.pool(feats, boxes).reshape(n * p, -1)
        for name in ("box_head.fc1", "box_head.fc2"):
            x = torch.relu(self.dense(x, name))
        logits = self.dense(x, "cls_score").reshape(n, p, -1)
        deltas = self.dense(x, "bbox_pred").reshape(n, p, d["num_classes"], 4)
        return logits, deltas
