"""Frame-level detection evaluation, per-class AP and mAP (counterpart of
tspn_tpu/detection/eval.py).

VOC-style over COCO-format records and fixed-size detection dicts: per
class, predictions sorted by score greedily claim unclaimed ground truth
at IoU >= threshold; AP integrates the precision envelope (``voc_ap``,
copied from tspn_tpu/evaluation/common.py). ``run_detector_eval`` runs
the port's FasterRCNN over the records first.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    """PASCAL VOC average precision from a precision/recall curve (the
    11-point VOC-07 variant, or the exact area under the envelope)."""
    recall = np.asarray(recall, dtype=np.float64)
    precision = np.asarray(precision, dtype=np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            p = float(np.max(precision[mask])) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    r = np.concatenate(([0.0], recall, [1.0]))
    p = np.concatenate(([0.0], precision, [0.0]))
    p = np.maximum.accumulate(p[::-1])[::-1]  # precision envelope
    steps = np.flatnonzero(r[1:] != r[:-1])
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


def _frame_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)

    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def evaluate_detections(
    records: List[dict],
    detections: Dict[int, dict],
    iou_threshold: float = 0.5,
) -> Tuple[float, Dict[int, float]]:
    """records: COCO-format dicts; detections: {image_id: {boxes (D, 4),
    scores (D,), classes (D,), mask (D,)}}. Returns (mAP over classes
    with ground truth, per-class AP)."""
    return _evaluate_at_threshold(records, detections, iou_threshold)


def evaluate_detections_coco(
    records: List[dict],
    detections: Dict[int, dict],
) -> Dict[str, float]:
    """COCO-protocol summary: AP = mean over IoU thresholds
    0.50:0.95:0.05, plus AP50 and AP75."""
    thresholds = np.arange(0.50, 0.96, 0.05)
    maps = {
        round(float(t), 2): _evaluate_at_threshold(records, detections, float(t))[0]
        for t in thresholds
    }
    return {
        "AP": float(np.mean(list(maps.values()))),
        "AP50": maps[0.5],
        "AP75": maps[0.75],
    }


def _evaluate_at_threshold(
    records: List[dict],
    detections: Dict[int, dict],
    iou_threshold: float,
) -> Tuple[float, Dict[int, float]]:
    gt_by_class: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    for rec in records:
        by_cls = defaultdict(list)
        for ann in rec["annotations"]:
            by_cls[ann["category_id"]].append(ann["bbox"])
        for c, boxes in by_cls.items():
            gt_by_class[c][rec["image_id"]] = np.asarray(boxes, np.float64)

    preds_by_class: Dict[int, list] = defaultdict(list)
    for image_id, det in detections.items():
        mask = np.asarray(det["mask"], bool)
        for box, score, cls in zip(
            np.asarray(det["boxes"])[mask],
            np.asarray(det["scores"])[mask],
            np.asarray(det["classes"])[mask],
        ):
            preds_by_class[int(cls)].append((image_id, float(score), box))

    ap_per_class: Dict[int, float] = {}
    for c, gt_map in gt_by_class.items():
        npos = sum(len(v) for v in gt_map.values())
        preds = sorted(preds_by_class.get(c, []), key=lambda x: -x[1])
        claimed = {img: np.zeros(len(v), bool) for img, v in gt_map.items()}
        tp = np.zeros(len(preds))
        fp = np.zeros(len(preds))
        for i, (img, _score, box) in enumerate(preds):
            gts = gt_map.get(img)
            if gts is None or not len(gts):
                fp[i] = 1
                continue
            ious = _frame_iou(np.asarray(box, np.float64)[None], gts)[0]
            ious[claimed[img]] = -1
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold:
                tp[i] = 1
                claimed[img][j] = True
            else:
                fp[i] = 1
        cum_tp, cum_fp = np.cumsum(tp), np.cumsum(fp)
        recall = cum_tp / max(npos, 1)
        precision = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float64).eps)
        ap_per_class[c] = voc_ap(recall, precision) if len(preds) else 0.0

    mean_ap = float(np.mean(list(ap_per_class.values()))) if ap_per_class else 0.0
    return mean_ap, ap_per_class


def run_detector_eval(
    model, records: List[dict], *, device, image_loader=None, tta: bool = False,
    train_cfg=None,
):
    """Run ``model.detect`` (``detect_tta`` with ``tta``) over the records,
    one image per call, and evaluate. ``model`` must be on ``device``;
    ``image_loader`` maps a record to an (H, W, 3) float image
    (``load_record_image`` by default). With ``train_cfg`` (a
    DetectorTrainConfig) the images get the training input policy
    (letterbox, or ResizeShortestEdge zero-padded into its orientation
    bucket), and the boxes are mapped back to annotation coordinates."""
    from tspn_tpu_torch.detection.inputs import (
        input_bucket_shape,
        letterbox,
        load_record_image,
        resize_shortest_edge,
    )
    from tspn_tpu_torch.pipeline import to_numpy

    loader = image_loader or load_record_image
    detect = model.detect_tta if tta else model.detect
    no_boxes = np.zeros((0, 4), np.float32)
    detections = {}
    for rec in records:
        img = loader(rec)
        scale = 1.0
        if train_cfg is not None:
            if train_cfg.input_policy == "letterbox":
                img, _, scale = letterbox(img, no_boxes, train_cfg.image_size)
            else:
                h0, w0 = img.shape[:2]
                img, _, scale = resize_shortest_edge(
                    img, no_boxes, train_cfg.min_size, train_cfg.max_size
                )
                bh, bw = input_bucket_shape(h0, w0, train_cfg)
                canvas = np.zeros((bh, bw, 3), np.float32)
                canvas[: img.shape[0], : img.shape[1]] = img
                img = canvas
        images = torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
        out = {k: to_numpy(v[0]) for k, v in detect(images).items()}
        out["boxes"] = out["boxes"] / scale  # back to annotation coords
        detections[rec["image_id"]] = out
    return evaluate_detections(records, detections)
