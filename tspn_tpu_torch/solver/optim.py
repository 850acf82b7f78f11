"""Optimizer and LR schedules (counterpart of tspn_tpu/solver/optim.py).

The JAX package chains optax transforms; here the same update is
``torch.optim.Adam`` or ``SGD`` over two parameter groups:

* bias parameters train at BASE_LR * BIAS_LR_FACTOR with
  WEIGHT_DECAY_BIAS, all others at BASE_LR with WEIGHT_DECAY. Both
  optimizers add ``wd * param`` to the gradient before their moments,
  which is optax's coupled ``add_decayed_weights`` ahead of the moments.
* "warmup_multi" and "multi" are LR multipliers stepped by a
  ``LambdaLR`` once per step, so step t (from 0) uses the multiplier of
  t, as optax's ``scale_by_schedule`` does with its count.
* "plateau" keeps a constant LR; ``ReduceOnPlateauState`` (copied as
  pure Python: the original module imports jax and optax at its top) is
  stepped by the train loop with the loss, and its ``lr_scale``
  multiplies each group's LR for the next step, which is what
  multiplying the optimizer's final update does for Adam and SGD alike.

``solver`` below is the SOLVER subtree of the config (attribute access).
"""

from __future__ import annotations

import bisect
from typing import Callable, NamedTuple, Sequence

import torch


def warmup_multistep_factor(
    milestones: Sequence[int], gamma: float = 0.1,
    warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
    warmup_method: str = "linear",
) -> Callable[[int], float]:
    """t -> warmup(t) * gamma^{#milestones <= t} (the LR over BASE_LR)."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"Unknown warmup method {warmup_method!r}")
    ms = sorted(milestones)

    def factor(t: int) -> float:
        wf = 1.0
        if t < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = t / max(warmup_iters, 1)
                wf = warmup_factor * (1 - alpha) + alpha
        return wf * gamma ** bisect.bisect_right(ms, t)

    return factor


def multistep_factor(milestones: Sequence[int], gamma: float) -> Callable[[int], float]:
    ms = sorted(milestones)
    return lambda t: gamma ** bisect.bisect_right(ms, t)


class ReduceOnPlateauState(NamedTuple):
    """torch's ReduceLROnPlateau, mode='min', as a pure host-side state
    machine: a copy of tspn_tpu/solver/optim.py::ReduceOnPlateauState.
    ``lr_scale`` starts at 1.0 and shrinks by ``factor`` whenever the
    metric has not improved (relative threshold) for more than
    ``patience`` consecutive steps. Defaults are the reference's: factor
    0.9, patience 100."""

    best: float = float("inf")
    num_bad: int = 0
    cooldown_count: int = 0
    lr_scale: float = 1.0
    factor: float = 0.9
    patience: int = 100
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_scale: float = 0.0
    eps: float = 1e-8

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold  # 'abs'

    def update(self, metric: float) -> "ReduceOnPlateauState":
        """One scheduler.step(metric); returns the successor state."""
        metric = float(metric)
        if self._is_better(metric):
            best, num_bad = metric, 0
        else:
            best, num_bad = self.best, self.num_bad + 1
        cooldown_count = self.cooldown_count
        if cooldown_count > 0:
            cooldown_count -= 1
            num_bad = 0
        lr_scale = self.lr_scale
        if num_bad > self.patience:
            new_scale = max(lr_scale * self.factor, self.min_scale)
            if lr_scale - new_scale > self.eps:
                lr_scale = new_scale
            cooldown_count = self.cooldown
            num_bad = 0
        return self._replace(
            best=best, num_bad=num_bad,
            cooldown_count=cooldown_count, lr_scale=lr_scale,
        )


def _is_bias(name: str) -> bool:
    """flax names bias leaves 'bias' ('b' kept for safety); so does torch."""
    return name.rsplit(".", 1)[-1] in ("bias", "b")


def lr_factor(solver) -> Callable[[int], float]:
    """The schedule of SCHEDULER.TYPE as a multiplier of BASE_LR."""
    sched = solver.SCHEDULER
    if sched.TYPE == "warmup_multi":
        return warmup_multistep_factor(
            sched.MILESTONES, sched.GAMMA, sched.WARMUP_FACTOR,
            sched.WARMUP_ITERS, sched.WARMUP_METHOD,
        )
    if sched.TYPE == "multi":
        return multistep_factor(sched.MILESTONES, sched.GAMMA)
    if sched.TYPE == "plateau":
        return lambda t: 1.0
    raise ValueError(f"{sched.TYPE} is not defined")


def build_optimizer(solver, model: torch.nn.Module):
    """-> (optimizer, LambdaLR scheduler) for ``model``'s parameters."""
    bias = [p for n, p in model.named_parameters() if _is_bias(n)]
    other = [p for n, p in model.named_parameters() if not _is_bias(n)]
    groups = [
        {"params": other, "lr": solver.BASE_LR,
         "weight_decay": solver.WEIGHT_DECAY},
        {"params": bias, "lr": solver.BASE_LR * float(solver.BIAS_LR_FACTOR),
         "weight_decay": solver.WEIGHT_DECAY_BIAS},
    ]
    groups = [g for g in groups if g["params"]]
    kind = solver.OPTIMIZER.TYPE
    if kind == "adam":
        optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    elif kind == "sgd":
        optimizer = torch.optim.SGD(groups, momentum=solver.OPTIMIZER.MOMENTUM)
    else:
        raise ValueError(f"{kind} is not defined")
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(solver))
    return optimizer, scheduler
