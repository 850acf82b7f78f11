"""Faster R-CNN R-C4 (counterpart of tspn_tpu/detection/rcnn.py):
inference and the training forward.

  images (N, H, W, 3) -> ResNet C4 backbone (N, H/16, W/16, 1024)
                      -> RPN -> P fixed proposals per image
                      -> RoIAlign 14x14 (K7 on the card) -> res5 -> 2048-d
                      -> (num_classes+1) softmax + 4*num_classes box deltas
                      -> class-aware NMS at fixed capacity (inference), or
                         the four losses (training)

The JAX model runs one image and is vmapped over a batch; here every stage
takes the batch natively, and RoIAlign pools all images' RoIs in one call
(one K7 launch, and one backward launch when training). ``dtype`` is the
compute type (float32 or bfloat16, flax's ``dtype=``): parameters stay
float32 and every stage follows JAX's type promotion, so bf16 box deltas
decoded against f32 anchors give f32 boxes, and bf16 scores are ranked by
a stable sort. Under a profiler the stages are the spans ``tspn.backbone``,
``tspn.rpn``, ``tspn.roi_head`` and ``tspn.postprocess``
(``runtime/spans.py``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch import nn

from tspn_tpu_torch.detection.resnet import (
    FrozenAffine,
    Linear,
    Res5Head,
    ResNetC4Backbone,
)
from tspn_tpu_torch.detection.rpn import (
    Proposals,
    RPNHead,
    make_anchors,
    match_anchors_to_gt,
    rpn_loss,
    sample_targets,
    select_proposals,
)
from tspn_tpu_torch.ops.boxes import clip_boxes, decode_boxes, encode_boxes, hflip_boxes
from tspn_tpu_torch.ops.nms import box_iou, nms
from tspn_tpu_torch.ops.roi_align import roi_align
from tspn_tpu_torch.runtime.spans import span


class DetectionConfig(NamedTuple):
    num_classes: int = 35
    depth: int = 101
    stride: int = 16
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    pre_nms_topk_train: int = 2000
    post_nms_topk_train: int = 512
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 256
    rpn_nms_threshold: float = 0.7
    rpn_batch_size: int = 256
    rpn_positive_fraction: float = 0.5
    roi_batch_size: int = 128
    roi_positive_fraction: float = 0.25
    roi_fg_threshold: float = 0.5
    roi_pool_size: int = 14
    score_threshold: float = 0.05
    test_nms_threshold: float = 0.5
    max_detections: int = 100


# flax's lecun_normal: a normal truncated to 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class FasterRCNN(nn.Module):
    """``roi_pool`` is the RoIAlign function the RoI head calls (the
    ``roi_align`` dispatch); a caller may set another with its signature,
    as ``chip_smoke.py`` does to hold K7 against the plain version.
    ``forward`` is the training forward (the four losses); ``detect``,
    ``detect_tta`` and ``roi_classeme`` serve. Another architecture
    (``detection/fpn.py``) subclasses it and overrides what differs:
    ``build``, ``features``, ``_rpn``, ``anchors``, ``proposals`` and
    ``_roi_forward``; the sampling, the losses and the post-processing are
    these."""

    def __init__(self, cfg: DetectionConfig = DetectionConfig(),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"detector compute dtype {dtype}: float32 or bfloat16")
        self.cfg = cfg
        self.dtype = dtype
        self.build(cfg, dtype)
        self.roi_pool = roi_align
        self.reset_parameters(generator)

    def build(self, cfg, dtype: torch.dtype) -> None:
        """The modules, in the order their parameters are drawn."""
        self.backbone = ResNetC4Backbone(cfg.depth, dtype)
        self.rpn_head = RPNHead(1024, len(cfg.anchor_sizes) * len(cfg.anchor_ratios), dtype)
        self.res5 = Res5Head(cfg.depth, dtype)
        self.cls_score = Linear(2048, cfg.num_classes + 1, dtype=dtype)
        self.bbox_pred = Linear(2048, 4 * cfg.num_classes, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The flax model's initializers, drawn from ``generator`` (seed 0
        when None): lecun_normal for the convs and Dense layers,
        normal(0.01) for the RPN convs and ``cls_score``, normal(0.001)
        for ``bbox_pred``, zero biases, FrozenAffine scale 1 and bias 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, m in self.named_modules():
            if isinstance(m, FrozenAffine):
                m.scale.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                if name.startswith("rpn_head") or name == "cls_score":
                    m.weight.normal_(0.0, 0.01, generator=generator)
                elif name == "bbox_pred":
                    m.weight.normal_(0.0, 0.001, generator=generator)
                else:
                    _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()

    # ---------------------------------------------------------------- core
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (N, H/16, W/16, 1024) contiguous, in the
        compute dtype (the stem casts the images, as flax's first conv)."""
        with span("tspn.backbone"):
            x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            return self.backbone(x).permute(0, 2, 3, 1).contiguous()

    def _rpn(self, feats: torch.Tensor):
        """-> objectness logits (N, K) and deltas (N, K, 4) over all anchors."""
        return self.rpn_head(feats.permute(0, 3, 1, 2))

    def anchors(self, feats: torch.Tensor) -> torch.Tensor:
        """(K, 4) xyxy anchors in ``_rpn``'s order."""
        c = self.cfg
        return make_anchors(feats.shape[1], feats.shape[2], c.stride, c.anchor_sizes,
                            c.anchor_ratios, device=feats.device)

    def proposals(self, logits, deltas, anchors, image_hw: tuple, pre_nms_topk: int,
                  post_nms_topk: int) -> Proposals:
        return select_proposals(logits, deltas, anchors, image_hw, pre_nms_topk,
                                post_nms_topk, self.cfg.rpn_nms_threshold)

    def _roi_forward(self, feats: torch.Tensor, boxes: torch.Tensor):
        """feats (N, h, w, C), boxes (N, P, 4) image coords -> (cls_logits
        (N, P, C+1), deltas (N, P, C, 4))."""
        c = self.cfg
        n, p = boxes.shape[:2]
        with span("tspn.roi_head"):
            batch_idx = torch.arange(n, device=boxes.device, dtype=torch.int32
                                     ).repeat_interleave(p)
            pooled = self.roi_pool(feats, (boxes / c.stride).reshape(n * p, 4), batch_idx,
                                   c.roi_pool_size, 2)
            embeddings = self.res5(pooled.permute(0, 3, 1, 2))  # (N*P, 2048)
            cls_logits = self.cls_score(embeddings).reshape(n, p, -1)
            deltas = self.bbox_pred(embeddings).reshape(n, p, c.num_classes, 4)
            return cls_logits, deltas

    # ------------------------------------------------------------- training
    def forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Training forward over a batch -> the four losses, each the mean
        over the images of JAX's per-image loss (``make_detector_train_step``
        averages its vmapped losses): images (N, H, W, 3), gt_boxes (N, G,
        4) xyxy, gt_classes (N, G) int in [0, C), gt_mask (N, G)."""
        c = self.cfg
        n, h, w = images.shape[:3]
        feats = self.features(images)
        with span("tspn.rpn"):
            logits, deltas = self._rpn(feats)
            anchors = self.anchors(feats)
            rpn_targets = match_anchors_to_gt(anchors, gt_boxes, gt_mask)
            loss_obj, loss_box = rpn_loss(logits, deltas, anchors, rpn_targets,
                                          c.rpn_batch_size, c.rpn_positive_fraction)
            with torch.no_grad():
                props = self.proposals(logits.detach(), deltas.detach(), anchors, (h, w),
                                       c.pre_nms_topk_train, c.post_nms_topk_train)

        with torch.no_grad():
            # the GT boxes join the proposals (detectron2's C4 practice)
            boxes = torch.cat([props.boxes, gt_boxes], dim=1)  # (N, P + G, 4)
            valid = torch.cat([props.mask, gt_mask > 0], dim=1)
            iou = torch.where(gt_mask[:, None, :] > 0, box_iou(boxes, gt_boxes), -1.0)
            best_iou, best_gt = iou.max(dim=2)  # the first maximum, as jnp.argmax
            is_fg = (best_iou >= c.roi_fg_threshold) & valid
            is_bg = ~is_fg & valid
            labels = torch.where(is_fg, 1.0, torch.where(is_bg, 0.0, -1.0))
            # the highest-overlap RoIs first (the appended GT have IoU 1)
            weights = sample_targets(labels, c.roi_batch_size, c.roi_positive_fraction,
                                     priority=best_iou)
            # the sampled RoIs in index order into a fixed roi_batch_size set
            taken = weights > 0
            rank = torch.where(taken, torch.cumsum(taken.long(), dim=1) - 1, 10**9)
            order = torch.argsort(rank, dim=1, stable=True)[:, : c.roi_batch_size]
            roi_boxes = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
            roi_valid = torch.gather(taken, 1, order)
            roi_fg = torch.gather(is_fg, 1, order)
            roi_gt = torch.gather(best_gt, 1, order)
            roi_cls = torch.where(roi_fg, torch.gather(gt_classes.long(), 1, roi_gt),
                                  c.num_classes)  # background = C

        cls_logits, box_deltas = self._roi_forward(feats, roi_boxes)
        # optax.softmax_cross_entropy_with_integer_labels
        ce = torch.logsumexp(cls_logits, dim=-1) - torch.gather(
            cls_logits, 2, roi_cls[..., None])[..., 0]
        denom = roi_valid.sum(dim=1).clamp(min=1).to(torch.float32)
        loss_cls = (ce * roi_valid).sum(dim=1) / denom

        fg_deltas = torch.gather(
            box_deltas, 2,
            roi_cls.clamp(0, c.num_classes - 1)[..., None, None].expand(n, -1, 1, 4))[:, :, 0]
        gt_of_roi = torch.gather(gt_boxes, 1, roi_gt[..., None].expand(*roi_gt.shape, 4))
        delta_targets = encode_boxes(gt_of_roi, roi_boxes)
        # detectron2's C4 recipe: SMOOTH_L1_BETA 0, pure L1
        l1 = (fg_deltas - delta_targets).abs().sum(-1)
        loss_roi_box = (l1 * roi_fg * roi_valid).sum(dim=1) / denom
        return {"loss_rpn_obj": loss_obj.mean(), "loss_rpn_box": loss_box.mean(),
                "loss_cls": loss_cls.mean(), "loss_box": loss_roi_box.mean()}

    # ------------------------------------------------------------ inference
    @torch.no_grad()
    def detect_from_features(self, feats, image_hw: tuple) -> Dict[str, torch.Tensor]:
        """Everything after the backbone: RPN, proposals, RoI head and the
        class-aware NMS -> fixed-size detections: boxes (N, Dmax, 4),
        scores (N, Dmax), classes (N, Dmax), mask (N, Dmax)."""
        c = self.cfg
        h, w = image_hw
        with span("tspn.rpn"):
            logits, deltas = self._rpn(feats)
            props = self.proposals(logits, deltas, self.anchors(feats), (h, w),
                                   c.pre_nms_topk_test, c.post_nms_topk_test)
        n = props.boxes.shape[0]
        cls_logits, box_deltas = self._roi_forward(feats, props.boxes)
        with span("tspn.postprocess"):
            probs = torch.softmax(cls_logits, dim=-1)[..., : c.num_classes]  # (N, P, C)
            boxes_per_class = decode_boxes(
                box_deltas, props.boxes[:, :, None, :].expand(box_deltas.shape)
            )
            boxes_per_class = clip_boxes(boxes_per_class, h, w)

            p = probs.shape[1]
            flat_scores = (probs * props.mask[..., None]).reshape(n, p * c.num_classes)
            flat_boxes = boxes_per_class.reshape(n, p * c.num_classes, 4)
            flat_classes = torch.arange(c.num_classes, device=cls_logits.device).repeat(p)

            keep_score = flat_scores > c.score_threshold
            # class-aware NMS: offset boxes by class so classes never suppress
            # each other
            offset = flat_classes[:, None] * (max(h, w) + 2.0)
            idx, keep = nms(flat_boxes + offset, flat_scores, c.test_nms_threshold,
                            c.max_detections, valid=keep_score)
            return {
                "boxes": torch.gather(flat_boxes, 1, idx[..., None].expand(*idx.shape, 4)),
                "scores": torch.gather(flat_scores, 1, idx) * keep,
                "classes": flat_classes[idx],
                "mask": keep,
            }

    @torch.no_grad()
    def detect(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, H, W, 3) images -> fixed-size detections per image."""
        return self.detect_from_features(self.features(images), images.shape[1:3])

    @torch.no_grad()
    def detect_tta(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Test-time augmentation: detect on the images and their
        horizontal mirrors (one batch of 2N), map mirrored boxes back and
        merge the two candidate sets with one class-aware NMS at the same
        fixed capacity (detectron2's hflip TTA)."""
        c = self.cfg
        n, h, w = images.shape[:3]
        both = self.detect(torch.cat([images, images.flip(2)]))
        boxes = torch.cat([both["boxes"][:n], hflip_boxes(both["boxes"][n:], w)], dim=1)
        scores = torch.cat([both["scores"][:n], both["scores"][n:]], dim=1)
        classes = torch.cat([both["classes"][:n], both["classes"][n:]], dim=1)
        valid = torch.cat([both["mask"][:n], both["mask"][n:]], dim=1)
        offset = classes[..., None] * (max(h, w) + 2.0)
        idx, keep = nms(boxes + offset, scores, c.test_nms_threshold,
                        c.max_detections, valid=valid)
        return {
            "boxes": torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
            "scores": torch.gather(scores, 1, idx) * keep,
            "classes": torch.gather(classes, 1, idx),
            "mask": keep,
        }

    @torch.no_grad()
    def roi_classeme(self, images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Class logits for given boxes (N, R, 4) -> (N, R, num_classes+1),
        the classeme the relation stage consumes."""
        cls_logits, _ = self._roi_forward(self.features(images), boxes)
        return cls_logits
