"""Region Proposal Network (the single-level C4 form is the counterpart
of tspn_tpu/detection/rpn.py), for a batch of images at once.

Inference: 3x3 conv + 1x1 objectness / delta heads over the anchors, then
pre-NMS top-k, decode, clip and NMS into fixed-size proposal lists: over
one level's anchors (``select_proposals``, C4), or the top-k of each
level and one NMS over all of them, the levels kept apart by offsets
(``select_level_proposals``, FPN). Training: IoU anchor matching (fg 0.7
/ bg 0.3 / each GT's best anchors forced fg), the deterministic balanced
sampler and the RPN loss. Every function takes a leading image axis where JAX's takes one
image under ``vmap``; ties break as JAX's do (a stable sort on the same
key, the first maximum).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from tspn_tpu_torch.detection.resnet import Conv2d
from tspn_tpu_torch.ops.boxes import anchor_grid, clip_boxes, decode_boxes, encode_boxes
from tspn_tpu_torch.ops.nms import box_iou, nms
from tspn_tpu_torch.parallel.train_step import sigmoid_bce


class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)  # flax "SAME"
        self.objectness = Conv2d(channels, num_anchors, 1, dtype=dtype)
        self.deltas = Conv2d(channels, num_anchors * 4, 1, dtype=dtype)

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
    top_scores, top_idx = _top(logits, pre_nms_topk)
    return _decode_nms(top_scores, top_idx, deltas, anchors, image_hw, post_nms_topk,
                       nms_threshold, min_size)


def _top(logits: torch.Tensor, k: int):
    """The ``k`` highest logits of each row and their indices, in score
    order, ties by index (lax.top_k's; torch.topk promises none)."""
    k = min(k, logits.shape[1])
    top_scores, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return top_scores[:, :k], top_idx[:, :k]


def _decode_nms(top_scores, top_idx, deltas, anchors, image_hw, post_nms_topk,
                nms_threshold, min_size, offset=None) -> Proposals:
    """Decode and clip the chosen anchors' boxes and NMS them (``offset``
    added to the boxes for the NMS alone keeps groups apart) into
    ``post_nms_topk`` proposals an image."""
    n, k = top_idx.shape
    boxes = decode_boxes(
        torch.gather(deltas, 1, top_idx[..., None].expand(n, k, 4)), anchors[top_idx]
    )
    boxes = clip_boxes(boxes, image_hw[0], image_hw[1])
    wh_ok = ((boxes[..., 2] - boxes[..., 0]) > min_size) & (
        (boxes[..., 3] - boxes[..., 1]) > min_size
    )
    idx, keep = nms(boxes if offset is None else boxes + offset, top_scores, nms_threshold,
                    post_nms_topk, valid=wh_ok)
    return Proposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
        scores=torch.sigmoid(torch.gather(top_scores, 1, idx)) * keep,
        mask=keep,
    )


def select_level_proposals(
    logits: torch.Tensor,     # (N, K) over all levels' anchors, level after level
    deltas: torch.Tensor,     # (N, K, 4)
    anchors: torch.Tensor,    # (K, 4)
    level_sizes: Sequence[int],
    image_hw: tuple,
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_threshold: float = 0.7,
    min_size: float = 0.0,
) -> Proposals:
    """detectron2's ``find_top_rpn_proposals``: the ``pre_nms_topk`` best
    anchors of each level (``level_sizes`` anchors each, in order), then
    decode, clip and one NMS over all of them with each level's boxes
    moved apart by an offset, as the class-aware NMS keeps classes apart,
    into ``post_nms_topk`` proposals an image."""
    scores, idx, level = [], [], []
    start = 0
    for i, size in enumerate(level_sizes):
        s, k = _top(logits[:, start: start + size], pre_nms_topk)
        scores.append(s)
        idx.append(k + start)
        level.append(torch.full((k.shape[1],), float(i), device=logits.device))
        start += size
    offset = torch.cat(level)[None, :, None] * (max(image_hw) + 2.0)
    return _decode_nms(torch.cat(scores, dim=1), torch.cat(idx, dim=1), deltas, anchors,
                       image_hw, post_nms_topk, nms_threshold, min_size, offset)


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


class RPNTargets(NamedTuple):
    labels: torch.Tensor      # (N, K) 1 fg / 0 bg / -1 ignore
    matched_gt: torch.Tensor  # (N, K, 4)


def match_anchors_to_gt(
    anchors: torch.Tensor,    # (K, 4)
    gt_boxes: torch.Tensor,   # (N, G, 4)
    gt_mask: torch.Tensor,    # (N, G)
    fg_threshold: float = 0.7,
    bg_threshold: float = 0.3,
) -> RPNTargets:
    """IoU matching: fg at >= fg_threshold or where an anchor reaches a
    GT's best IoU (ties included), bg below bg_threshold, the rest
    ignored; every anchor is bg in an image without GT."""
    real = gt_mask[:, None, :] > 0
    iou = torch.where(real, box_iou(anchors, gt_boxes), -1.0)  # (N, K, G)
    best_iou, best_gt = iou.max(dim=2)  # the first maximum, as jnp.argmax
    gt_best_iou = iou.max(dim=1, keepdim=True).values  # (N, 1, G)
    forced = ((iou >= gt_best_iou) & real & (iou > 0)).any(dim=2)
    any_gt = (gt_mask > 0).any(dim=1, keepdim=True)
    fg = ((best_iou >= fg_threshold) | forced) & any_gt
    bg = (best_iou < bg_threshold) | ~any_gt
    labels = torch.where(fg, 1.0, torch.where(bg, 0.0, -1.0))
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(*best_gt.shape, 4))
    return RPNTargets(labels, matched)


def sample_targets(
    labels: torch.Tensor,     # (N, K)
    batch_size: int,
    positive_fraction: float,
    priority: torch.Tensor | None = None,
) -> torch.Tensor:
    """Deterministic balanced sample -> (N, K) float32 weights in {0, 1}: up
    to batch_size * fraction fg plus bg to fill, the highest ``priority``
    first (raster order without one). Ties in priority go to the lower
    index: a stable sort, as ``jnp.argsort``."""
    num_pos = int(batch_size * positive_fraction)
    is_fg = labels == 1.0
    is_bg = labels == 0.0

    def take(mask, budget):
        if priority is None:
            rank = torch.where(mask, torch.cumsum(mask.long(), dim=1), 10**9)
            return mask & (rank <= budget)
        key = torch.where(mask, priority, float("-inf"))
        order = torch.argsort(-key, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                      .expand_as(order).contiguous())
        return mask & (rank < budget)

    take_fg = take(is_fg, num_pos)
    n_fg = take_fg.sum(dim=1, keepdim=True)
    take_bg = take(is_bg, batch_size - n_fg)
    return (take_fg | take_bg).to(torch.float32)


def rpn_loss(
    logits: torch.Tensor,     # (N, K)
    deltas: torch.Tensor,     # (N, K, 4)
    anchors: torch.Tensor,    # (K, 4)
    targets: RPNTargets,
    batch_size: int = 256,
    positive_fraction: float = 0.5,
):
    """Per image (objectness BCE, L1 box loss) over the sampled anchors,
    each (N,). The sample takes low-scoring fg and high-scoring bg anchors
    first (hardness, computed without a gradient)."""
    with torch.no_grad():
        hardness = torch.where(targets.labels == 1.0, -logits, logits)
        weights = sample_targets(targets.labels, batch_size, positive_fraction,
                                 priority=hardness)
    bce = sigmoid_bce(logits, targets.labels.clamp(0.0, 1.0))
    denom = weights.sum(dim=1).clamp(min=1.0)
    loss_obj = (bce * weights).sum(dim=1) / denom

    fg = (targets.labels == 1.0).to(torch.float32)
    delta_targets = encode_boxes(targets.matched_gt, anchors)
    # detectron2's C4 recipe: SMOOTH_L1_BETA 0, pure L1
    l1 = (deltas - delta_targets).abs().sum(-1)
    loss_box = (l1 * fg * weights).sum(dim=1) / denom
    return loss_obj, loss_box
