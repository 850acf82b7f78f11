"""Pair Proposal Network, "what to look at" (counterpart of
tspn_tpu/models/ppn.py).

Per segment, two 2-layer MLPs embed each tracklet's classeme logits as
subject and object representations; the N x N pair logits are
``sub @ obj^T``. Training uses a masked BCE against a binary GT matrix
built from the labeled pairs; proposals are the top-K cells of the
matrix. Everything takes a leading batch dimension and explicit padding
masks, as the JAX package's vmapped functions do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal draws from a normal truncated at +-2 std, rescaled
# by this constant so that the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default Dense kernel init for an (out, in) torch weight."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def dense(linear: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` over f32 parameters: in float32 the
    Linear itself; otherwise input, kernel and bias cast to ``dtype``, and
    the product and the bias add in ``dtype``."""
    if dtype == torch.float32:
        return linear(x)
    return x.to(dtype) @ linear.weight.to(dtype).T + linear.bias.to(dtype)


class PPNHead(nn.Module):
    """Subject / object classeme embedders and the bilinear pair scorer:
    per role Linear(C -> hidden), ReLU, Linear(hidden -> out); returns
    LOGITS (..., N, N). Parameters ``sub_fc1``, ``sub_fc2``, ``obj_fc1``
    and ``obj_fc2`` are the flax module's Dense layers of the same names.
    With ``dtype`` bf16 the Dense layers compute in bf16 (f32 parameters
    cast, as ``nn.Dense(dtype=bf16)``) and the pair product takes bf16
    operands with an f32 result (``preferred_element_type=f32``)."""

    def __init__(self, in_channels: int = 35, hidden_channels: int = 64,
                 out_channels: int = 35, device=None,
                 generator: Optional[torch.Generator] = None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for role in ("sub", "obj"):
            fc1 = nn.Linear(in_channels, hidden_channels, device=device)
            fc2 = nn.Linear(hidden_channels, out_channels, device=device)
            for fc in (fc1, fc2):
                lecun_normal_(fc.weight, generator)
                with torch.no_grad():
                    fc.bias.zero_()
            setattr(self, f"{role}_fc1", fc1)
            setattr(self, f"{role}_fc2", fc2)

    def forward(self, cls_logits: torch.Tensor) -> torch.Tensor:
        def role(fc1, fc2):
            return dense(fc2, F.relu(dense(fc1, cls_logits, self.dtype)), self.dtype)

        sub = role(self.sub_fc1, self.sub_fc2)
        obj = role(self.obj_fc1, self.obj_fc2)
        return sub.float() @ obj.float().transpose(-1, -2)


def gt_pair_matrix(pairs: torch.Tensor, labels: torch.Tensor,
                   pair_mask: torch.Tensor, num_tracklets: int) -> torch.Tensor:
    """(B, P, 2) pairs, (B, P, R) labels, (B, P) mask -> (B, N, N) binary
    target: gt[i, j] = 1 iff some valid pair row (i, j) has a positive
    predicate label. A pair index outside [0, N) is dropped, as JAX's
    scatter drops it."""
    n = num_tracklets
    positive = ((labels.sum(dim=-1) > 0) & (pair_mask > 0)).float()
    sub, obj = pairs[..., 0].long(), pairs[..., 1].long()
    inside = (sub >= 0) & (sub < n) & (obj >= 0) & (obj < n)
    flat = torch.where(inside, sub * n + obj, torch.zeros_like(sub))
    positive = torch.where(inside, positive, torch.zeros_like(positive))
    mat = torch.zeros((pairs.shape[0], n * n), dtype=torch.float32,
                      device=pairs.device)
    mat.scatter_reduce_(1, flat, positive, reduce="amax", include_self=True)
    return mat.reshape(-1, n, n)


def ppn_loss(pair_logits: torch.Tensor, gt_matrix: torch.Tensor,
             track_mask: torch.Tensor) -> torch.Tensor:
    """Per-segment masked BCE over the real-tracklet N x N matrix,
    diagonal included: (B, N, N) logits and targets, (B, N) mask -> (B,)."""
    mask = track_mask[:, :, None] * track_mask[:, None, :]
    per_cell = F.binary_cross_entropy_with_logits(
        pair_logits.float(), gt_matrix, reduction="none"
    )
    denom = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
    return (per_cell * mask).sum(dim=(1, 2)) / denom


def top_pair_proposals(pair_logits: torch.Tensor, track_mask: torch.Tensor,
                       num_proposals: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K flattened (i, j) cells by pair score; padded cells are -inf
    and never enter the top-K. (B, N, N), (B, N) -> (flat indices (B, K),
    sigmoid scores (B, K))."""
    n = pair_logits.shape[-1]
    mask = (track_mask[:, :, None] * track_mask[:, None, :]) > 0
    masked = torch.where(mask, pair_logits,
                         torch.full_like(pair_logits, -float("inf")))
    scores, idx = torch.topk(masked.reshape(masked.shape[0], -1),
                             min(num_proposals, n * n), dim=-1)
    return idx, torch.sigmoid(scores)
