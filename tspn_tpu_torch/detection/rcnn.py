"""Faster R-CNN R-C4 inference (counterpart of tspn_tpu/detection/rcnn.py).

  images (N, H, W, 3) -> ResNet C4 backbone (N, H/16, W/16, 1024)
                      -> RPN -> P fixed proposals per image
                      -> RoIAlign 14x14 (K7 on the card) -> res5 -> 2048-d
                      -> (num_classes+1) softmax + 4*num_classes box deltas
                      -> class-aware NMS at fixed capacity

The JAX model runs one image and is vmapped over a batch; here every stage
takes the batch natively, and RoIAlign pools all images' RoIs in one
call. Inference only: the training forward is not ported yet. float32
only; a bf16 input raises.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch import nn

from tspn_tpu_torch.detection.resnet import FrozenAffine, Res5Head, ResNetC4Backbone
from tspn_tpu_torch.detection.rpn import RPNHead, make_anchors, select_proposals
from tspn_tpu_torch.ops.boxes import clip_boxes, decode_boxes, hflip_boxes
from tspn_tpu_torch.ops.nms import nms
from tspn_tpu_torch.ops.roi_align import roi_align


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
    as ``chip_smoke.py`` does to hold K7 against the plain version."""

    def __init__(self, cfg: DetectionConfig = DetectionConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetC4Backbone(cfg.depth)
        self.rpn_head = RPNHead(1024, len(cfg.anchor_sizes) * len(cfg.anchor_ratios))
        self.res5 = Res5Head(cfg.depth)
        self.cls_score = nn.Linear(2048, cfg.num_classes + 1)
        self.bbox_pred = nn.Linear(2048, 4 * cfg.num_classes)
        self.roi_pool = roi_align
        self.reset_parameters(generator)

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
        """(N, H, W, 3) f32 images -> (N, H/16, W/16, 1024) contiguous."""
        if images.dtype != torch.float32:
            raise NotImplementedError(
                f"detector in {images.dtype}: only float32 is ported (bf16 is "
                "queued, ROADMAP queue 1)"
            )
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.backbone(x).permute(0, 2, 3, 1).contiguous()

    def _rpn(self, feats: torch.Tensor):
        return self.rpn_head(feats.permute(0, 3, 1, 2))

    def _roi_forward(self, feats: torch.Tensor, boxes: torch.Tensor):
        """feats (N, h, w, C), boxes (N, P, 4) image coords -> (cls_logits
        (N, P, C+1), deltas (N, P, C, 4))."""
        c = self.cfg
        n, p = boxes.shape[:2]
        batch_idx = torch.arange(n, device=boxes.device, dtype=torch.int32
                                 ).repeat_interleave(p)
        pooled = self.roi_pool(feats, (boxes / c.stride).reshape(n * p, 4), batch_idx,
                               c.roi_pool_size, 2)
        embeddings = self.res5(pooled.permute(0, 3, 1, 2))  # (N*P, 2048)
        cls_logits = self.cls_score(embeddings).reshape(n, p, -1)
        deltas = self.bbox_pred(embeddings).reshape(n, p, c.num_classes, 4)
        return cls_logits, deltas

    # ------------------------------------------------------------ inference
    @torch.no_grad()
    def detect_from_features(self, feats: torch.Tensor,
                             image_hw: tuple) -> Dict[str, torch.Tensor]:
        """Everything after the backbone: RPN, proposals, RoI head and the
        class-aware NMS -> fixed-size detections: boxes (N, Dmax, 4),
        scores (N, Dmax), classes (N, Dmax), mask (N, Dmax)."""
        c = self.cfg
        h, w = image_hw
        n = feats.shape[0]
        logits, deltas = self._rpn(feats)
        anchors = make_anchors(feats.shape[1], feats.shape[2], c.stride,
                               c.anchor_sizes, c.anchor_ratios, device=feats.device)
        props = select_proposals(logits, deltas, anchors, (h, w), c.pre_nms_topk_test,
                                 c.post_nms_topk_test, c.rpn_nms_threshold)
        cls_logits, box_deltas = self._roi_forward(feats, props.boxes)
        probs = torch.softmax(cls_logits, dim=-1)[..., : c.num_classes]  # (N, P, C)
        boxes_per_class = decode_boxes(
            box_deltas, props.boxes[:, :, None, :].expand(box_deltas.shape)
        )
        boxes_per_class = clip_boxes(boxes_per_class, h, w)

        p = probs.shape[1]
        flat_scores = (probs * props.mask[..., None]).reshape(n, p * c.num_classes)
        flat_boxes = boxes_per_class.reshape(n, p * c.num_classes, 4)
        flat_classes = torch.arange(c.num_classes, device=feats.device).repeat(p)

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
