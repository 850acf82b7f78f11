"""2-D box coding for the detector (counterpart of tspn_tpu/ops/boxes.py).

R-CNN box-delta coding (dx, dy, dw, dh) with detectron2's dw/dh clamp,
clipping and horizontal flips, on torch tensors of any leading shape;
``anchor_grid`` stays NumPy, copied from the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

# detectron2's default clamp on dw/dh: log(1000/16)
BBOX_XFORM_CLIP = float(np.log(1000.0 / 16.0))


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """xyxy gt/anchors (..., 4) -> deltas (dx, dy, dw, dh)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    dx = (gx - ax) / aw.clamp(min=1e-6)
    dy = (gy - ay) / ah.clamp(min=1e-6)
    dw = torch.log(gw.clamp(min=1e-6) / aw.clamp(min=1e-6))
    dh = torch.log(gh.clamp(min=1e-6) / ah.clamp(min=1e-6))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_boxes with detectron2's dw/dh clamp."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dx, dy = deltas[..., 0], deltas[..., 1]
    dw = deltas[..., 2].clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    dh = deltas[..., 3].clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    x0 = boxes[..., 0].clamp(0.0, width)
    y0 = boxes[..., 1].clamp(0.0, height)
    x1 = boxes[..., 2].clamp(0.0, width)
    y1 = boxes[..., 3].clamp(0.0, height)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def hflip_boxes(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Map xyxy boxes between an image and its horizontal mirror
    (self-inverse). Used by detector test-time augmentation."""
    return torch.stack(
        [width - boxes[..., 2], boxes[..., 1], width - boxes[..., 0], boxes[..., 3]],
        dim=-1,
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0) * (
        boxes[..., 3] - boxes[..., 1]
    ).clamp(min=0.0)


@lru_cache(maxsize=None)
def _anchor_grid_cached(
    feat_h: int, feat_w: int, stride: int,
    sizes: Tuple[float, ...], ratios: Tuple[float, ...],
) -> np.ndarray:
    base = []
    for size in sizes:
        area = float(size) ** 2
        for ratio in ratios:
            w = np.sqrt(area / ratio)
            h = w * ratio
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)  # (A, 4)
    sx = (np.arange(feat_w) + 0.5) * stride
    sy = (np.arange(feat_h) + 0.5) * stride
    cx, cy = np.meshgrid(sx, sy)  # (H, W)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)  # (H*W*A, 4)


def anchor_grid(
    feat_h: int, feat_w: int, stride: int,
    sizes: Sequence[float], ratios: Sequence[float],
) -> np.ndarray:
    """RPN anchors over a feature map: (H*W*A, 4) xyxy, row-major over
    (y, x, anchor) with centers at (x + .5)*stride."""
    return _anchor_grid_cached(
        int(feat_h), int(feat_w), int(stride),
        tuple(float(s) for s in sizes), tuple(float(r) for r in ratios),
    )
