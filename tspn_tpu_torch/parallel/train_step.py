"""One training step (counterpart of tspn_tpu/parallel/train_step.py).

The JAX package jits loss, gradients and the optimizer update into one
program, sharded over a device mesh. Here the step runs eagerly on one
device: forward, masked BCE, backward, optimizer step, schedule step.

Loss (train_step.py:49-74): per-segment BCE with logits averaged over
that segment's real pair x predicate cells, then averaged over segments,
in f32. The PPN loss is not ported and raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

# batch leaves the step reads; nothing else is copied to the device
TRAIN_KEYS = ("feats", "labels", "pair_mask")


def batch_to_device(batch: dict, device, keys=TRAIN_KEYS) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(batch[k]).to(device) for k in keys}


def compute_losses(model, batch: Dict[str, torch.Tensor],
                   plain: bool = False) -> Dict[str, torch.Tensor]:
    out = model(batch, plain=plain)
    if "pair_logits" in out:
        raise NotImplementedError("the PPN loss is not ported yet (ROADMAP queue 1)")
    labels = batch["labels"]
    bce = F.binary_cross_entropy_with_logits(
        out["rel_logits"].float(), labels, reduction="none"
    )
    mask = batch["pair_mask"]
    per_seg = (bce * mask[..., None]).sum(dim=(1, 2)) / torch.clamp(
        mask.sum(dim=1) * labels.shape[-1], min=1.0
    )
    return {"loss_rel": per_seg.mean()}


def train_step(model, optimizer, scheduler, batch: Dict[str, torch.Tensor],
               lr_scale: Optional[float] = None,
               plain: bool = False) -> Dict[str, torch.Tensor]:
    """One update; returns the step's losses as detached device scalars
    (no host sync). ``lr_scale``, the plateau scheduler's factor,
    multiplies every group's LR for this update only: the schedule step
    then sets the next step's LR afresh."""
    losses = compute_losses(model, batch, plain=plain)
    total = sum(losses.values())
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    if lr_scale is not None and lr_scale != 1.0:
        for group in optimizer.param_groups:
            group["lr"] *= lr_scale
    optimizer.step()
    scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    return metrics
