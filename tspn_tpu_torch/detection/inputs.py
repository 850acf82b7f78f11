"""Detector input policy: letterbox and detectron2's ResizeShortestEdge
with two orientation buckets (copied host code from
tspn_tpu/detection/train.py, held equal by tests/test_torch_detection.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tspn_tpu_torch.data.layout import round_up


class DetectorTrainConfig(NamedTuple):
    """The input-policy fields of the JAX package's DetectorTrainConfig
    (the training fields come with detector training)."""

    image_size: int = 640         # square letterbox target
    # input policy: "letterbox" (fixed square) or "shortest_edge"
    # (detectron2 800/1333 semantics, two orientation buckets)
    input_policy: str = "letterbox"
    min_size: int = 800           # detectron2 MIN_SIZE_TRAIN default
    max_size: int = 1333          # detectron2 MAX_SIZE_TRAIN default
    pad_multiple: int = 32        # bucket dims round up to this


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
