"""Inputs made from a traffic file's parameters and a seed: training
records and the order of their batches, and detection frames. The same
seed gives the same inputs; the program and the reference get the same
records and frames.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng([stream, seed])


def make_records(traffic: dict, num_classes: int, seed: int) -> List[dict]:
    """``traffic["records"]`` uint8 frames of ``traffic["frame_hw"]``: dim
    noise with ``boxes_per_image`` flat boxes of random classes drawn on
    it, as COCO-style records with in-memory images."""
    rng = seed_rng(seed, 1)
    h, w = traffic["frame_hw"]
    lo, hi = traffic["boxes_per_image"]
    box_lo = traffic["box_min_side"]
    records = []
    for i in range(traffic["records"]):
        img = rng.integers(0, 64, (h, w, 3), dtype=np.uint8)
        anns = []
        for _ in range(int(rng.integers(lo, hi + 1))):
            bw, bh = int(rng.integers(box_lo, w // 2)), int(rng.integers(box_lo, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y0: y0 + bh, x0: x0 + bw] = rng.integers(64, 256, 3, dtype=np.uint8)
            anns.append({"bbox": [float(x0), float(y0), float(x0 + bw), float(y0 + bh)],
                         "category_id": int(rng.integers(0, num_classes)),
                         "bbox_mode": "XYXY_ABS"})
        records.append({"image": img, "image_id": i, "height": h, "width": w,
                        "annotations": anns})
    return records


def epoch_batches(n_records: int, per_batch: int, seed: int) -> List[List[int]]:
    """One epoch of record indices per batch, shuffled by the seed: every
    batch's images differ from every other's."""
    if n_records % per_batch:
        raise ValueError("records must fill whole batches")
    perm = seed_rng(seed, 2).permutation(n_records)
    return [perm[k: k + per_batch].tolist() for k in range(0, n_records, per_batch)]


def make_frames(traffic: dict, seed: int, device) -> np.ndarray:
    """(T, H, W, 3) float32 frames on a ``canvas_hw`` canvas: the image
    (``image_hw``, top left) dim noise in [0, 0.25) with ``rects_per_frame``
    flat coloured rectangles, zeros beyond it. The noise is drawn on
    ``device`` in one call."""
    t = traffic["frames"]
    ch, cw = traffic["canvas_hw"]
    ih, iw = traffic["image_hw"]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    frames = torch.zeros((t, ch, cw, 3), device=device)
    frames[:, :ih, :iw] = torch.rand((t, ih, iw, 3), generator=gen, device=device) * 0.25
    rng = seed_rng(seed, 3)
    lo, hi = traffic["rect_side"]
    for k in range(t):
        for _ in range(traffic["rects_per_frame"]):
            hh, ww = (int(v) for v in rng.integers(lo, hi + 1, 2))
            y0, x0 = int(rng.integers(0, ih - hh)), int(rng.integers(0, iw - ww))
            frames[k, y0: y0 + hh, x0: x0 + ww] = torch.as_tensor(
                rng.random(3, dtype=np.float32), device=device)
    return frames.cpu().numpy()
