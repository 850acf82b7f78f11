"""The reference's training steps: a reference detector's four losses
(``reference/rcnn.py``), their sum's gradient by autograd, and SGD with
momentum and weight decay written out (d = g + wd * p; m = d on the first
step, else momentum * m + d; p -= lr * m), at the configuration's warm-up
rate (linear from base / 3).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference.rcnn import LOSS_KEYS, TwoStageDetector


def learning_rate(step: int, train: dict) -> float:
    """The rate of update ``step`` (from 0)."""
    base, warm = train["base_lr"], train["warmup_iters"]
    if step < warm:
        return (base / 3 - base) * (1.0 - step / warm) + base
    return base


class Trainer:
    """Trains ``model``, a reference detector built with ``train=True``."""

    def __init__(self, model: TwoStageDetector, train: dict):
        self.train = train
        self.model = model
        self.names: List[str] = list(model.w)
        self.start = {k: v.detach().clone() for k, v in self.model.w.items()}
        self.momentum: Dict[str, torch.Tensor] = {}
        self.steps = 0
        self.first_update: Dict[str, torch.Tensor] = {}
        self.first_grad: Dict[str, torch.Tensor] = {}

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update on a device batch -> its losses and their sum."""
        losses = self.model.losses(batch["image"], batch["gt_boxes"], batch["gt_classes"],
                                   batch["gt_mask"])
        total = sum(losses[k] for k in LOSS_KEYS)
        params = [self.model.w[k] for k in self.names]
        grads = torch.autograd.grad(total, params)
        wd, mom = self.train["weight_decay"], self.train["momentum"]
        lr = learning_rate(self.steps, self.train)
        with torch.no_grad():
            for name, p, g in zip(self.names, params, grads):
                d = g + wd * p
                if self.steps == 0:
                    self.first_grad[name] = g.detach().clone()
                    self.first_update[name] = d.clone()
                    self.momentum[name] = d.clone()
                else:
                    self.momentum[name] = mom * self.momentum[name] + d
                p -= lr * self.momentum[name]
        self.steps += 1
        out = {k: float(v.detach()) for k, v in losses.items()}
        out["loss"] = float(total.detach())
        return out

    def change(self) -> Dict[str, torch.Tensor]:
        """Each parameter's change since the start."""
        return {k: (self.model.w[k] - self.start[k]).detach() for k in self.names}
