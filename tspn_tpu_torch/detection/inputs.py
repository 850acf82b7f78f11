"""Detector input policy: letterbox and detectron2's ResizeShortestEdge
with two orientation buckets, the training configuration and batch
assembly (copied host code from tspn_tpu/detection/train.py, held equal by
tests/test_torch_detection.py and tests/test_torch_detector_train.py).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from tspn_tpu_torch.data.layout import round_up


class DetectorTrainConfig(NamedTuple):
    """tspn_tpu/detection/train.py's DetectorTrainConfig, field for field:
    the reference recipe's operating point (IMS_PER_BATCH 4, BASE_LR
    2.5e-4, MAX_ITER 100k), SGD momentum 0.9 with weight decay 1e-4 and a
    linear warm-up from base/3, and the input policy."""

    ims_per_batch: int = 4
    base_lr: float = 2.5e-4
    max_iter: int = 100000
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 1000
    image_size: int = 640         # square letterbox target
    max_gt_boxes: int = 32
    log_every: int = 20
    # input policy: "letterbox" (fixed square) or "shortest_edge"
    # (detectron2 800/1333 semantics, two orientation buckets)
    input_policy: str = "letterbox"
    min_size: int = 800           # detectron2 MIN_SIZE_TRAIN default
    max_size: int = 1333          # detectron2 MAX_SIZE_TRAIN default
    pad_multiple: int = 32        # bucket dims round up to this
    # in-training evaluation (detectron2's DefaultTrainer evaluator hook)
    eval_every: int = 0           # 0 disables the hook
    keep_best: bool = True        # track and save the best-mAP parameters
    # bf16 compute with f32 parameters and gradients (the reference's
    # detectron2 recipe is f32 throughout)
    mixed_precision: bool = False


def shortest_edge_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    """detectron2 ResizeShortestEdge: scale the short side to min_size
    unless that would push the long side past max_size."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale


def input_bucket_shape(h: int, w: int, cfg) -> tuple[int, int]:
    """Padded canvas for an image under the active policy: the square
    letterbox, or one of two orientation buckets, landscape (min, max)
    or portrait (max, min)."""
    if cfg.input_policy == "letterbox":
        return cfg.image_size, cfg.image_size
    short = round_up(cfg.min_size, cfg.pad_multiple)
    long_ = round_up(cfg.max_size, cfg.pad_multiple)
    return (short, long_) if w >= h else (long_, short)


def _bilinear_resize(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Separable bilinear resample at the half-pixel-centre convention
    (``align_corners=False``), border-replicated."""
    h, w = image.shape[:2]
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    rows = image[y0] * (1.0 - wy) + image[y1] * wy  # (nh, w, C)
    out = rows[:, x0] * (1.0 - wx) + rows[:, x1] * wx
    return out.astype(image.dtype, copy=False)


def resize_shortest_edge(
    image: np.ndarray, boxes: np.ndarray, min_size: int, max_size: int
) -> tuple[np.ndarray, np.ndarray, float]:
    """Aspect-preserving bilinear resize at detectron2 semantics; returns
    (resized image, scaled boxes, scale)."""
    h, w = image.shape[:2]
    scale = shortest_edge_scale(h, w, min_size, max_size)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return _bilinear_resize(image, nh, nw), boxes * scale, scale


def load_record_image(record: dict) -> np.ndarray:
    """Record -> float32 HWC image in [0, 1], from an in-memory array
    (integer arrays are 0..255) or a file path."""
    if "image" in record:
        arr = np.asarray(record["image"])
        img = arr.astype(np.float32)
        if np.issubdtype(arr.dtype, np.integer):
            return img / 255.0
        return img / 255.0 if img.max() > 1.5 else img
    from PIL import Image

    with Image.open(record["file_name"]) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def letterbox(
    image: np.ndarray, boxes: np.ndarray, size: int
) -> tuple[np.ndarray, np.ndarray, float]:
    """Scale the long side to ``size``, pad bottom/right; returns
    (image (size, size, 3), scaled boxes, scale)."""
    h, w = image.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = _bilinear_resize(image, nh, nw)
    out = np.zeros((size, size, 3), np.float32)
    out[:nh, :nw] = resized
    return out, boxes * scale, scale


def record_hw(rec: dict) -> tuple[int, int]:
    """(height, width) without decoding the image when possible."""
    if "height" in rec and "width" in rec:
        return int(rec["height"]), int(rec["width"])
    img = np.asarray(rec["image"]) if "image" in rec else load_record_image(rec)
    return img.shape[0], img.shape[1]


def make_batch(records: List[dict], cfg: DetectorTrainConfig) -> Dict[str, np.ndarray]:
    """Records -> padded batch under the active input policy. With
    "shortest_edge", every record must share an orientation bucket (the
    train loop groups by aspect ratio, as detectron2's
    GroupedBatchSampler)."""
    b = len(records)
    g = cfg.max_gt_boxes
    h0, w0 = record_hw(records[0])
    ch, cw = input_bucket_shape(h0, w0, cfg)
    images = np.zeros((b, ch, cw, 3), np.float32)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_classes = np.zeros((b, g), np.int32)
    gt_mask = np.zeros((b, g), np.float32)
    for i, rec in enumerate(records):
        img = load_record_image(rec)
        boxes = np.asarray(
            [a["bbox"] for a in rec["annotations"]], np.float32
        ).reshape(-1, 4)
        if cfg.input_policy == "letterbox":
            img, boxes, _ = letterbox(img, boxes, cfg.image_size)
            images[i] = img
        else:
            assert input_bucket_shape(*img.shape[:2], cfg) == (ch, cw), (
                "mixed orientation buckets in one batch — group records "
                "by aspect ratio before batching"
            )
            img, boxes, _ = resize_shortest_edge(
                img, boxes, cfg.min_size, cfg.max_size
            )
            images[i, : img.shape[0], : img.shape[1]] = img
        n = min(len(boxes), g)
        gt_boxes[i, :n] = boxes[:n]
        gt_classes[i, :n] = [a["category_id"] for a in rec["annotations"]][:n]
        gt_mask[i, :n] = 1.0
    return {
        "image": images, "gt_boxes": gt_boxes,
        "gt_classes": gt_classes, "gt_mask": gt_mask,
    }


def group_by_orientation(records: List[dict], cfg: DetectorTrainConfig) -> List[np.ndarray]:
    """Index groups whose members share an input bucket (one group for
    letterbox; landscape / portrait for shortest_edge)."""
    if cfg.input_policy == "letterbox":
        return [np.arange(len(records))]
    buckets: Dict[tuple, list] = {}
    for i, rec in enumerate(records):
        h, w = record_hw(rec)
        buckets.setdefault(input_bucket_shape(h, w, cfg), []).append(i)
    return [np.asarray(v) for v in buckets.values()]
