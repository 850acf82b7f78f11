"""One training step (counterpart of tspn_tpu/parallel/train_step.py).

The JAX package jits loss, gradients and the optimizer update into one
program, sharded over a device mesh. Here the step runs eagerly on one
device: forward, masked BCE, backward, optimizer step, schedule step.

Losses (train_step.py:49-70):
* ``loss_rel``: per-segment BCE with logits averaged over that segment's
  real pair x predicate cells, then averaged over segments. The BCE is
  optax's ``sigmoid_binary_cross_entropy`` formula in the logits' dtype
  (the labels are cast to it, as optax 0.2.6 does): on the bf16 logits of
  an unfused bf16 model, log_sigmoid and the products run in bf16, and
  the masked sums in f32;
* ``loss_pair`` (model with the PPN head): per-segment masked BCE of the
  pair logits against the binary GT pair matrix over the real-tracklet
  N x N cells, diagonal included, averaged over segments.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tspn_tpu_torch.data.loader import leaf_to_device
from tspn_tpu_torch.models.ppn import gt_pair_matrix, ppn_loss

# batch leaves the step reads; nothing else is copied to the device
TRAIN_KEYS = ("feats", "labels", "pair_mask")
PPN_TRAIN_KEYS = TRAIN_KEYS + ("pairs", "cls_logits", "track_mask")


def train_keys(model) -> tuple:
    return PPN_TRAIN_KEYS if getattr(model, "use_ppn", False) else TRAIN_KEYS


def batch_to_device(batch: dict, device, keys=TRAIN_KEYS) -> Dict[str, torch.Tensor]:
    return {k: leaf_to_device(batch[k], device) for k in keys}


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``optax.sigmoid_binary_cross_entropy`` in the logits'
    dtype: -z log_sigmoid(x) - (1 - z) log_sigmoid(-x), z = labels cast to
    that dtype."""
    z = labels.to(logits.dtype)
    return -z * F.logsigmoid(logits) - (1 - z) * F.logsigmoid(-logits)


def compute_losses(model, batch: Dict[str, torch.Tensor],
                   plain: bool = False) -> Dict[str, torch.Tensor]:
    out = model(batch, plain=plain)
    labels = batch["labels"]
    bce = sigmoid_bce(out["rel_logits"], labels)
    mask = batch["pair_mask"]
    per_seg = (bce * mask[..., None]).sum(dim=(1, 2)) / torch.clamp(
        mask.sum(dim=1) * labels.shape[-1], min=1.0
    )
    losses = {"loss_rel": per_seg.mean()}
    if "pair_logits" in out:
        gts = gt_pair_matrix(batch["pairs"], labels, mask,
                             out["pair_logits"].shape[-1])
        losses["loss_pair"] = ppn_loss(out["pair_logits"], gts,
                                       batch["track_mask"]).mean()
    return losses


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
