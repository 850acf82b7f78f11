"""Inputs for checking ``ops/nms.py``, from numpy seeds: the CPU and card
tests (tests/test_torch_nms.py, tests/test_torch_nms_gpu.py) and
``chip_smoke.py``'s NMS phase use them.

- ``rpn_like``: (B, N) RPN-like candidates on an 800 x 1344 image, half
  around a few hundred objects (shapes alike, so IoU > 0.7 happens), half
  scattered, clipped to the image; ``valid`` is the RPN's positive-width
  test; scores are normal logits.
- ``class_aware``: the detector's class-aware field, 1000 proposals x 35
  classes, each class's boxes jittered from the proposal and offset by
  class as ``rcnn.detect_from_features`` does; scores are softmax
  probabilities with classes 0-2 raised, ``valid`` the 0.05 score cut.
- ``threshold_pairs``: pairs whose IoU, as ``box_iou`` computes it in f32,
  is exactly f32(thr) and one f32 ulp either side of it.
"""

import numpy as np
import torch

from tspn_tpu_torch.ops.nms import box_iou

H, W = 800, 1344
# (images B, candidates N, top_k, IoU threshold) of the calls the detector's
# cells make: the RPN in training and at test, the class-aware NMS
CELL_SHAPES = {"rpn_train": (4, 12000, 2000, 0.7), "rpn_detect": (8, 6000, 1000, 0.7),
               "class_aware": (8, 35000, 100, 0.5)}
CLASSES, PROPOSALS = 35, 1000


def rpn_like(seed: int, b: int, n: int, objects: int = 300):
    """-> boxes (B, N, 4) f32, scores (B, N) f32, valid (B, N) bool."""
    rng = np.random.RandomState(seed)
    ocx, ocy = rng.uniform(0, W, (b, objects)), rng.uniform(0, H, (b, objects))
    osize = 2.0 ** rng.uniform(5, 9, (b, objects))
    oratio = rng.choice([0.5, 1.0, 2.0], (b, objects))
    obj = rng.randint(0, objects, (b, n))
    rows = np.arange(b)[:, None]
    near = rng.rand(b, n) < 0.5
    cx = np.where(near, ocx[rows, obj] + rng.normal(0, 6, (b, n)), rng.uniform(-40, W + 40, (b, n)))
    cy = np.where(near, ocy[rows, obj] + rng.normal(0, 6, (b, n)), rng.uniform(-40, H + 40, (b, n)))
    size = np.where(near, osize[rows, obj], 2.0 ** rng.uniform(3, 9, (b, n)))
    size = size * np.exp(rng.normal(0, 0.1, (b, n)))
    ratio = np.where(near, oratio[rows, obj], rng.choice([0.5, 1.0, 2.0], (b, n)))
    bw, bh = size / np.sqrt(ratio), size * np.sqrt(ratio)
    boxes = np.stack([np.clip(cx - bw / 2, 0, W), np.clip(cy - bh / 2, 0, H),
                      np.clip(cx + bw / 2, 0, W), np.clip(cy + bh / 2, 0, H)], -1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = ((boxes[..., 2] - boxes[..., 0]) > 0) & ((boxes[..., 3] - boxes[..., 1]) > 0)
    scores = torch.from_numpy(rng.normal(0, 2, (b, n)).astype(np.float32))
    return boxes, scores, valid


def class_aware(seed: int, b: int, proposals: int = PROPOSALS, classes: int = CLASSES):
    """-> boxes (B, P * C, 4) f32 offset by class, scores (B, P * C) f32,
    valid (B, P * C) bool, flattened proposal-major as the detector does."""
    rng = np.random.RandomState(seed)
    props, _, mask = rpn_like(seed + 1, b, proposals)
    jitter = rng.normal(0, 4, (b, proposals, classes, 4)).astype(np.float32)
    boxes = props[:, :, None, :] + torch.from_numpy(jitter)
    boxes = torch.stack([boxes[..., 0].clamp(0, W), boxes[..., 1].clamp(0, H),
                         boxes[..., 2].clamp(0, W), boxes[..., 3].clamp(0, H)], -1)
    logits = rng.normal(0, 1, (b, proposals, classes + 1)).astype(np.float32)
    logits[..., :3] += 3.0
    probs = torch.softmax(torch.from_numpy(logits), -1)[..., :classes]
    scores = (probs * mask[..., None]).reshape(b, proposals * classes)
    flat_classes = torch.arange(classes).repeat(proposals)
    offset = flat_classes[:, None] * (max(H, W) + 2.0)
    boxes = boxes.reshape(b, proposals * classes, 4) + offset
    return boxes, scores, scores > 0.05


def _with_iou(target: np.float32):
    """(a, t) with box_iou([0, 0, 1, t], [0, 0, 1, a]) == target exactly:
    the first a of a few heights for which some f32 t near a * target
    hits it."""
    for a in (1.0, 2.0, 1.5, 1.25, 3.0, 0.75):
        base = np.float32(a * target)
        ts = (np.array([base], np.float32).view(np.int32)
              + np.arange(-4096, 4097, dtype=np.int32)).view(np.float32)
        lower = torch.from_numpy(np.stack([np.zeros_like(ts), np.zeros_like(ts),
                                           np.ones_like(ts), ts], 1))
        iou = box_iou(lower, torch.tensor([[0.0, 0.0, 1.0, a]]))[:, 0].numpy()
        hits = np.nonzero(iou == target)[0]
        if len(hits):
            return a, float(ts[hits[0]])
    raise ValueError(f"no box pair with IoU {target!r}")


def threshold_pairs(thr: float):
    """Three pairs, side by side: a box of unit width (the higher score)
    and one of the same width below it whose IoU with it is f32(thr), the
    f32 just above and the f32 just below. -> boxes (6, 4), scores (6,),
    and the expected keep of each lower box (kept unless its IoU >
    f32(thr))."""
    t32 = np.float32(thr)
    targets = [t32, np.nextafter(t32, np.float32(1)), np.nextafter(t32, np.float32(0))]
    boxes, scores = [], []
    for j, target in enumerate(targets):
        x = 4.0 * j
        a, t = _with_iou(target)
        boxes += [[x, 0.0, x + 1.0, a], [x, 0.0, x + 1.0, t]]
        scores += [3.0 - 0.1 * j, 1.0 - 0.1 * j]
    expected = [not target > t32 for target in targets]
    return (torch.tensor(boxes, dtype=torch.float32),
            torch.tensor(scores, dtype=torch.float32), expected)
