"""Region Proposal Network, single-level C4, inference half (counterpart
of tspn_tpu/detection/rpn.py).

3x3 conv + 1x1 objectness / delta heads over stride-16 anchors, then
pre-NMS top-k, decode, clip and NMS into fixed-size proposal lists, for a
batch of images at once. The training half (anchor matching, sampling,
the RPN loss) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from tspn_tpu_torch.ops.boxes import anchor_grid, clip_boxes, decode_boxes
from tspn_tpu_torch.ops.nms import nms


class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)  # flax "SAME"
        self.objectness = nn.Conv2d(channels, num_anchors, 1)
        self.deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: torch.Tensor):
        """(N, C, H, W) -> objectness (N, H*W*A), deltas (N, H*W*A, 4), row-
        major over (y, x, anchor) as the flax head and ``anchor_grid``."""
        n = feats.shape[0]
        t = torch.relu(self.conv(feats))
        logits = self.objectness(t).permute(0, 2, 3, 1).reshape(n, -1)
        deltas = self.deltas(t).permute(0, 2, 3, 1).reshape(n, -1, 4)
        return logits, deltas


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (N, P, 4) xyxy image coords
    scores: torch.Tensor  # (N, P)
    mask: torch.Tensor    # (N, P) bool


def select_proposals(
    logits: torch.Tensor,     # (N, K)
    deltas: torch.Tensor,     # (N, K, 4)
    anchors: torch.Tensor,    # (K, 4)
    image_hw: tuple,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_threshold: float = 0.7,
    min_size: float = 0.0,
) -> Proposals:
    """Decode + clip + NMS the top anchors of each image into fixed-size
    proposals."""
    n, k_all = logits.shape
    k = min(pre_nms_topk, k_all)
    # score order, ties by index (lax.top_k's; torch.topk promises none)
    top_scores, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    boxes = decode_boxes(
        torch.gather(deltas, 1, top_idx[..., None].expand(n, k, 4)), anchors[top_idx]
    )
    boxes = clip_boxes(boxes, image_hw[0], image_hw[1])
    wh_ok = ((boxes[..., 2] - boxes[..., 0]) > min_size) & (
        (boxes[..., 3] - boxes[..., 1]) > min_size
    )
    idx, keep = nms(boxes, top_scores, nms_threshold, post_nms_topk, valid=wh_ok)
    return Proposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
        scores=torch.sigmoid(torch.gather(top_scores, 1, idx)) * keep,
        mask=keep,
    )


def make_anchors(
    feat_h: int, feat_w: int,
    stride: int = 16,
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    device=None,
) -> torch.Tensor:
    return torch.as_tensor(
        anchor_grid(feat_h, feat_w, stride, sizes, ratios), dtype=torch.float32,
        device=device,
    )
