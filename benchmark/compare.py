"""The numbers that decide ``correct``: what the timed path produced against
the plain reference. Each number is compared with its cell's limit
(``benchmark/limits/<workload>.json``); a run is correct when every number
is finite and within its limit and no work failed.

Training (the reference follows the first three steps from the same
weights and batches):
  loss_gap    the worst relative gap of a step's loss (four losses, three steps)
  grad_gap    the worst leaf's gap between the norms of the first update
              direction as SGD holds it (g + wd * p, its momentum buffer
              after step 1), over the reference leaf's norm or the median
              leaf's, whichever is larger
  change_gap  the same for each leaf's change over the three steps, over the
              leaves whose reference gradient is not nought to rounding
              (at least a thousandth of the median leaf's)
A cell's limits file names the numbers it compares (see ``train_numbers``
for the steadier forms).
Detection (a sample of batches drawn from the seed, every call's answer
for them):
  score_gap   the widest score gap between matched detections (same class,
              IoU >= 0.5, matched in descending score), or an unmatched
              detection's score above the other side's cut (its lowest
              kept score when it kept its full number, else the score
              threshold)
  box_gap_px  the widest coordinate gap between matched detections, pixels
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

GRAD_FLOOR = 1e-3  # leaves below this share of the median gradient are left out


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().double().norm() for k in names]).tolist()
    return dict(zip(names, vals))


def leaf_gaps(program: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Each leaf's gap of norms over its reference norm or the median
    leaf's, whichever is larger."""
    leaves = list(ref) if leaves is None else leaves
    median = float(np.median([ref[k] for k in leaves]))
    return {k: abs(program[k] - ref[k]) / max(ref[k], median, 1e-30) for k in leaves}


def train_numbers(prog_losses: List[Dict[str, float]], ref_losses: List[Dict[str, float]],
                  prog_first: Dict[str, float], ref_first: Dict[str, float],
                  prog_change: Dict[str, float], ref_change: Dict[str, float],
                  ref_grad: Dict[str, float]) -> Tuple[Dict[str, float], dict]:
    """-> (numbers, where the worst of each lies). Besides the three above:
    ``loss_gap_step1`` (the first step's four losses) and
    ``rpn_loss_gap_step1`` (its two RPN losses: means over 256 sampled
    anchors an image, which a swap of two near-equal anchors moves by
    rounding only)."""
    keys = [k for k in ref_losses[0] if k != "loss"]
    steps = [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in keys}
             for p, r in zip(prog_losses, ref_losses)]
    median_grad = float(np.median(list(ref_grad.values())))
    moved = [k for k, g in ref_grad.items() if g >= GRAD_FLOOR * median_grad]
    grad = leaf_gaps(prog_first, ref_first)
    change = leaf_gaps(prog_change, ref_change, moved)
    worst_step = max(range(len(steps)), key=lambda i: max(steps[i].values()))
    rpn = [k for k in keys if k.startswith("loss_rpn")]
    numbers = {"loss_gap": max(max(s.values()) for s in steps),
               "loss_gap_step1": max(steps[0].values()),
               "rpn_loss_gap_step1": max(steps[0][k] for k in rpn),
               "grad_gap": max(grad.values()), "change_gap": max(change.values())}
    where = {"loss_gaps": steps, "worst_loss_step": worst_step + 1,
             "grad_worst": max(grad, key=grad.get), "change_worst": max(change, key=change.get),
             "left_out": len(ref_grad) - len(moved)}
    return numbers, where


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), axis=-1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def frame_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], f: int,
               capacity: int, threshold: float) -> Tuple[List[float], List[float]]:
    """(score gaps, box gaps) of one frame's detections: one score gap per
    detection of either side (matched pairs once), one box gap per pair."""
    def kept(d):
        if f >= len(d["mask"]):  # a frame the answer left out keeps nothing
            return np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
        m = np.asarray(d["mask"][f], bool)
        return (np.asarray(d["boxes"][f], np.float64)[m], np.asarray(d["scores"][f], np.float64)[m],
                np.asarray(d["classes"][f])[m])

    pb, ps, pc = kept(prog)
    rb, rs, rc = kept(ref)
    cut_p = ps.min() if len(ps) >= capacity else threshold
    cut_r = rs.min() if len(rs) >= capacity else threshold
    overlap = _iou(rb, pb) if len(rb) and len(pb) else np.zeros((len(rb), len(pb)))
    used = np.zeros(len(pb), bool)
    scores, boxes = [], []
    for i in np.argsort(-rs, kind="stable"):
        cand = np.flatnonzero((pc == rc[i]) & ~used & (overlap[i] >= 0.5))
        if not len(cand):
            scores.append(max(rs[i] - cut_p, 0.0))
            continue
        j = cand[np.argmax(overlap[i, cand])]
        used[j] = True
        scores.append(abs(ps[j] - rs[i]))
        boxes.append(float(np.abs(pb[j] - rb[i]).max()))
    scores += [max(ps[j] - cut_r, 0.0) for j in np.flatnonzero(~used)]
    return [float(v) for v in scores], boxes


def detect_numbers(calls: List[Dict[str, np.ndarray]], refs: Dict[int, Dict[str, np.ndarray]],
                   batch: int, capacity: int, threshold: float) -> Tuple[Dict[str, float], dict]:
    """``refs``: sampled batch index -> the reference's detections of its
    frames; each call's answer for those frames is compared."""
    out = {"score_gap": 0.0, "box_gap_px": 0.0}
    kept = sum(int(r["mask"].sum()) for r in refs.values())
    for call in calls:
        for b, ref in refs.items():
            part = {k: v[b * batch: (b + 1) * batch] for k, v in call.items()}
            for f in range(ref["mask"].shape[0]):
                scores, boxes = frame_gaps(part, ref, f, capacity, threshold)
                out["score_gap"] = max([out["score_gap"]] + scores)
                out["box_gap_px"] = max([out["box_gap_px"]] + boxes)
    return out, {"reference_kept": kept, "calls": len(calls), "batches": sorted(refs)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float], failed: int) -> Tuple[bool, list]:
    """-> (correct, [(name, value, limit)]): every number finite and within
    its limit, and nothing failed."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = failed == 0 and all(math.isfinite(v) and v <= lim for _k, v, lim in rows)
    return ok, rows
