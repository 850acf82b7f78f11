"""What the plain references of the benchmark's two-stage detectors share:
layers over a dict of weights at a stated precision (channels-last
convolutions, frozen affines, dense layers), the RPN's losses and
proposals (top-k, decode, clip and NMS), RoI sampling with the ground truth
appended in training, the box losses, class-aware NMS at test, anchor
matching, balanced sampling and the input batch; in plain PyTorch, with the
plain RoIAlign and greedy NMS of ``reference/ops.py``. An architecture's
reference (``reference/<arch>.py``) subclasses ``TwoStageDetector`` with
its features, RPN head, anchors and box head.

The sampling rules are the program's deterministic ones: the RPN takes the
hardest anchors first, the RoI head the highest-IoU proposals first, each
balanced to its positive fraction.

A precision of "float32" or "bfloat16" is the configuration's; "tf32" and
"fp8" round every conv and dense operand one step lower (the control).
``channels_last=False`` runs the convolutions in NCHW: other cuDNN
kernels, the same arithmetic rounded otherwise (a witness of what a sound
change to the program's rounding reads).
Parameters stay float32; in bfloat16 each conv and dense layer casts its
input and weight and adds its bias after, the affines run in bfloat16,
RoIAlign pools a bfloat16 map in float32 and rounds once.

Nothing of the program is imported and nothing it made is read: the
weights and inputs come from the benchmark.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops

LOSS_KEYS = ("loss_rpn_obj", "loss_rpn_box", "loss_cls", "loss_box")


class TwoStageDetector:
    """Weights: name -> float32 tensor (the benchmark's). ``train=True``
    makes them leaves that take gradients. ``det``: the port's detection
    config fields. A subclass gives ``features``, ``rpn``, ``anchors`` and
    ``box_head``."""

    def __init__(self, det: dict, weights: Dict[str, torch.Tensor], precision: str,
                 train: bool = False, channels_last: bool = True):
        self.det, self.precision = det, precision
        self.dtype = ops.COMPUTE_DTYPE[precision]
        self.layout = torch.channels_last if channels_last else torch.contiguous_format
        self.w = {}
        for name, t in weights.items():
            fmt = self.layout if t.dim() == 4 else torch.contiguous_format
            leaf = t.detach().clone(memory_format=fmt)
            self.w[name] = leaf.requires_grad_(train)

    # ------------------------------------------------------------ layers
    def conv(self, x, name: str, stride: int = 1, padding: int = 0, bias: bool = False):
        y = F.conv2d(ops.operand(x, self.precision),
                     ops.operand(self.w[f"{name}.weight"], self.precision),
                     None, stride, padding)
        return y + self.w[f"{name}.bias"].to(self.dtype)[:, None, None] if bias else y

    def affine(self, x, name: str):
        return (x * self.w[f"{name}.scale"].to(self.dtype)[:, None, None]
                + self.w[f"{name}.bias"].to(self.dtype)[:, None, None])

    def dense(self, x, name: str):
        return (F.linear(ops.operand(x, self.precision),
                         ops.operand(self.w[f"{name}.weight"], self.precision))
                + self.w[f"{name}.bias"].to(self.dtype))

    # ------------------------------------------------ the architecture's
    def features(self, images: torch.Tensor):
        """(N, H, W, 3) images -> what ``rpn``, ``anchors`` and ``box_head``
        read."""
        raise NotImplementedError

    def rpn(self, feats):
        """-> objectness logits (N, K), deltas (N, K, 4) over all anchors."""
        raise NotImplementedError

    def anchors(self, feats):
        """-> (K, 4) xyxy anchors in ``rpn``'s order."""
        raise NotImplementedError

    def box_head(self, feats, boxes):
        """feats, boxes (N, P, 4) -> (logits (N, P, C+1), deltas (N, P, C, 4))."""
        raise NotImplementedError

    # ------------------------------------------------------------ shared
    def proposals(self, logits, deltas, anchors, image_hw, pre: int, post: int):
        """-> boxes (N, post, 4), mask (N, post)."""
        n, k_all = logits.shape
        k = min(pre, k_all)
        scores, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        scores, idx = scores[:, :k], idx[:, :k]
        boxes = ops.decode(torch.gather(deltas, 1, idx[..., None].expand(n, k, 4)), anchors[idx])
        boxes = ops.clip(boxes, image_hw[0], image_hw[1])
        ok = ((boxes[..., 2] - boxes[..., 0]) > 0.0) & ((boxes[..., 3] - boxes[..., 1]) > 0.0)
        keep_idx, keep = ops.nms(boxes, scores, self.det["rpn_nms_threshold"], post, ok)
        return torch.gather(boxes, 1, keep_idx[..., None].expand(*keep_idx.shape, 4)), keep

    # ---------------------------------------------------------- training
    def losses(self, images, gt_boxes, gt_classes, gt_mask) -> Dict[str, torch.Tensor]:
        """The four losses of a batch, each the mean over its images."""
        d = self.det
        n, h, w = images.shape[:3]
        feats = self.features(images)
        logits, deltas = self.rpn(feats)
        anchors = self.anchors(feats)
        labels, matched = match_anchors(anchors, gt_boxes, gt_mask)
        with torch.no_grad():
            hard = torch.where(labels == 1.0, -logits, logits)
            rpn_w = balanced_sample(labels, d["rpn_batch_size"], d["rpn_positive_fraction"], hard)
        z = labels.clamp(0.0, 1.0).to(logits.dtype)
        bce = -z * F.logsigmoid(logits) - (1 - z) * F.logsigmoid(-logits)
        denom = rpn_w.sum(dim=1).clamp(min=1.0)
        loss_obj = (bce * rpn_w).sum(dim=1) / denom
        fg = (labels == 1.0).to(torch.float32)
        l1 = (deltas - ops.encode(matched, anchors)).abs().sum(-1)
        loss_rpn_box = (l1 * fg * rpn_w).sum(dim=1) / denom

        with torch.no_grad():
            props, pmask = self.proposals(logits.detach(), deltas.detach(), anchors, (h, w),
                                          d["pre_nms_topk_train"], d["post_nms_topk_train"])
            boxes = torch.cat([props, gt_boxes], dim=1)
            valid = torch.cat([pmask, gt_mask > 0], dim=1)
            overlap = torch.where(gt_mask[:, None, :] > 0, ops.iou(boxes, gt_boxes), -1.0)
            best_iou, best_gt = overlap.max(dim=2)
            is_fg = (best_iou >= d["roi_fg_threshold"]) & valid
            roi_labels = torch.where(is_fg, 1.0, torch.where(~is_fg & valid, 0.0, -1.0))
            taken = balanced_sample(roi_labels, d["roi_batch_size"], d["roi_positive_fraction"],
                                    best_iou) > 0
            rank = torch.where(taken, torch.cumsum(taken.long(), dim=1) - 1, 10**9)
            order = torch.argsort(rank, dim=1, stable=True)[:, : d["roi_batch_size"]]
            roi_boxes = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
            roi_valid = torch.gather(taken, 1, order)
            roi_fg = torch.gather(is_fg, 1, order)
            roi_gt = torch.gather(best_gt, 1, order)
            roi_cls = torch.where(roi_fg, torch.gather(gt_classes.long(), 1, roi_gt),
                                  d["num_classes"])

        cls_logits, box_deltas = self.box_head(feats, roi_boxes)
        ce = torch.logsumexp(cls_logits, dim=-1) - torch.gather(
            cls_logits, 2, roi_cls[..., None])[..., 0]
        count = roi_valid.sum(dim=1).clamp(min=1).to(torch.float32)
        loss_cls = (ce * roi_valid).sum(dim=1) / count
        fg_deltas = torch.gather(
            box_deltas, 2,
            roi_cls.clamp(0, d["num_classes"] - 1)[..., None, None].expand(n, -1, 1, 4))[:, :, 0]
        target = ops.encode(torch.gather(gt_boxes, 1, roi_gt[..., None].expand(*roi_gt.shape, 4)),
                            roi_boxes)
        loss_box = ((fg_deltas - target).abs().sum(-1) * roi_fg * roi_valid).sum(dim=1) / count
        return {"loss_rpn_obj": loss_obj.mean(), "loss_rpn_box": loss_rpn_box.mean(),
                "loss_cls": loss_cls.mean(), "loss_box": loss_box.mean()}

    # --------------------------------------------------------- detection
    @torch.no_grad()
    def detect(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, H, W, 3) -> boxes (N, D, 4), scores (N, D), classes (N, D),
        mask (N, D) with D the detections kept per image."""
        d = self.det
        n, h, w = images.shape[:3]
        c = d["num_classes"]
        feats = self.features(images)
        logits, deltas = self.rpn(feats)
        props, pmask = self.proposals(logits, deltas, self.anchors(feats), (h, w),
                                      d["pre_nms_topk_test"], d["post_nms_topk_test"])
        cls_logits, box_deltas = self.box_head(feats, props)
        probs = torch.softmax(cls_logits, dim=-1)[..., :c]
        boxes = ops.clip(ops.decode(box_deltas, props[:, :, None, :].expand(box_deltas.shape)),
                         h, w)
        p = probs.shape[1]
        scores = (probs * pmask[..., None]).reshape(n, p * c)
        boxes = boxes.reshape(n, p * c, 4)
        classes = torch.arange(c, device=images.device).repeat(p)
        # classes never suppress each other: each class's boxes moved apart
        offset = classes[:, None] * (max(h, w) + 2.0)
        idx, keep = ops.nms(boxes + offset, scores, d["test_nms_threshold"],
                            d["max_detections"], scores > d["score_threshold"])
        return {"boxes": torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
                "scores": torch.gather(scores, 1, idx) * keep,
                "classes": classes[idx], "mask": keep}


def match_anchors(anchors, gt_boxes, gt_mask, fg_iou: float = 0.7, bg_iou: float = 0.3):
    """-> labels (N, K) 1 / 0 / -1 and each anchor's best ground-truth box:
    foreground at IoU >= fg_iou or where an anchor reaches a box's best
    IoU, background below bg_iou, the rest ignored; all background in an
    image without boxes."""
    real = gt_mask[:, None, :] > 0
    overlap = torch.where(real, ops.iou(anchors, gt_boxes), -1.0)
    best, best_gt = overlap.max(dim=2)
    box_best = overlap.max(dim=1, keepdim=True).values
    forced = ((overlap >= box_best) & real & (overlap > 0)).any(dim=2)
    any_gt = (gt_mask > 0).any(dim=1, keepdim=True)
    fg = ((best >= fg_iou) | forced) & any_gt
    bg = (best < bg_iou) | ~any_gt
    labels = torch.where(fg, 1.0, torch.where(bg, 0.0, -1.0))
    return labels, torch.gather(gt_boxes, 1, best_gt[..., None].expand(*best_gt.shape, 4))


def balanced_sample(labels, size: int, fraction: float, priority) -> torch.Tensor:
    """-> (N, K) float32 0/1: up to size * fraction positives, then
    negatives to fill ``size``, each the highest ``priority`` first, ties
    to the lower index."""

    def take(mask, budget):
        key = torch.where(mask, priority, torch.full_like(priority, float("-inf")))
        order = torch.argsort(-key, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                      .expand_as(order).contiguous())
        return mask & (rank < budget)

    pos = take(labels == 1.0, int(size * fraction))
    neg = take(labels == 0.0, size - pos.sum(dim=1, keepdim=True))
    return (pos | neg).to(torch.float32)


# ------------------------------------------------------------------ input
def train_batch(records: List[dict], train: dict) -> Dict[str, np.ndarray]:
    """Records -> one padded batch: each image resized by the shortest-edge
    rule into the batch's canvas (its sides rounded up to a multiple of
    ``pad_multiple``), its boxes scaled alike, up to ``max_gt`` boxes."""
    g = train["max_gt_boxes"]
    pad = train["pad_multiple"]
    h0, w0 = records[0]["image"].shape[:2]
    short, long_ = (-(-train["min_size"] // pad) * pad, -(-train["max_size"] // pad) * pad)
    ch, cw = (short, long_) if w0 >= h0 else (long_, short)
    out = {"image": np.zeros((len(records), ch, cw, 3), np.float32),
           "gt_boxes": np.zeros((len(records), g, 4), np.float32),
           "gt_classes": np.zeros((len(records), g), np.int32),
           "gt_mask": np.zeros((len(records), g), np.float32)}
    for i, rec in enumerate(records):
        img = rec["image"].astype(np.float32) / 255.0
        h, w = img.shape[:2]
        scale = ops.shortest_edge_scale(h, w, train["min_size"], train["max_size"])
        nh, nw = int(round(h * scale)), int(round(w * scale))
        out["image"][i, :nh, :nw] = ops.resize_bilinear(img, nh, nw)
        boxes = np.asarray([a["bbox"] for a in rec["annotations"]], np.float32).reshape(-1, 4)
        boxes = boxes * scale
        k = min(len(boxes), g)
        out["gt_boxes"][i, :k] = boxes[:k]
        out["gt_classes"][i, :k] = [a["category_id"] for a in rec["annotations"]][:k]
        out["gt_mask"][i, :k] = 1.0
    return out
