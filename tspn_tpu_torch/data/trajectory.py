"""Array-based object trajectories and vectorized cubic (volumetric) IoU
(copy of tspn_tpu/data/trajectory.py).

Boxes live in a (T, 4) float64 array; the pairwise cubic IoU is one
broadcast pass. The traj_cls JSON layout (pstart / pend / rois / score /
category / classeme / vsig / gt_trackid) is the JAX package's, so its
artifacts load unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from tspn_tpu_torch.data.segments import get_traj_proposal_file


@dataclass
class Trajectory:
    """A tracklet: per-frame boxes over [pstart, pend) plus classeme."""

    pstart: int
    pend: int
    rois: np.ndarray  # (T, 4) float64 (left, top, right, bottom)
    score: float = 0.0
    category: int = -1
    classeme: Optional[Sequence[float]] = None
    vsig: Optional[str] = None
    gt_trackid: int = -1
    # optional learned appearance embedding (models/reid) — consumed by
    # features/extraction when FEATURES.APPEARANCE == "learned"; not
    # serialized into traj_cls JSON (a derived, regenerable quantity)
    appearance: Optional[np.ndarray] = None
    # optional (3000,) HoG/HoF/MBH bag-of-words (features/idt) — consumed
    # by features/extraction when FEATURES.APPEARANCE == "idt"; likewise
    # derived and not serialized
    idt: Optional[np.ndarray] = None

    def __post_init__(self):
        self.rois = np.asarray(self.rois, dtype=np.float64).reshape(-1, 4)
        assert self.rois.shape[0] == self.pend - self.pstart, (
            f"{self.rois.shape[0]} boxes for span [{self.pstart},{self.pend})"
        )

    def length(self) -> int:
        return self.pend - self.pstart

    def roi_at(self, p: int) -> np.ndarray:
        return self.rois[p - self.pstart]

    def bbox_at(self, p: int):
        """(left, top, width, height) like trajectory.py:51-56."""
        l, t, r, b = self.roi_at(p)
        return (l, t, r - l, b - t)

    def copy(self) -> "Trajectory":
        return Trajectory(
            pstart=self.pstart, pend=self.pend, rois=self.rois.copy(),
            score=self.score, category=self.category,
            classeme=None if self.classeme is None else list(self.classeme),
            vsig=self.vsig, gt_trackid=self.gt_trackid,
        )

    def serialize(self) -> dict:
        return {
            "pstart": int(self.pstart),
            "pend": int(self.pend),
            "rois": [tuple(float(v) for v in roi) for roi in self.rois],
            "score": float(self.score),
            "category": int(self.category),
            "classeme": [float(x) for x in (self.classeme or [])],
            "vsig": self.vsig,
            "gt_trackid": int(self.gt_trackid),
        }


def merge_trajectories(head: Trajectory, tail: Trajectory) -> Trajectory:
    """Stitch two temporally overlapping tracklets of the same object.

    Boxes in the overlap window are averaged, then the tail's remainder is
    appended — semantics of association._merge_trajs
    (the reference's association.py:16-32), vectorized.
    """
    assert head.pend > tail.pstart and head.pstart < tail.pend, (
        f"{head.pstart}-{head.pend} does not overlap {tail.pstart}-{tail.pend}"
    )
    overlap = max(head.pend - tail.pstart, 0)
    rois = head.rois.copy()
    if overlap:
        rois[len(rois) - overlap:] = 0.5 * (
            rois[len(rois) - overlap:] + tail.rois[:overlap]
        )
    merged = np.concatenate([rois, tail.rois[overlap:]], axis=0)
    out = head.copy()
    out.rois = merged
    out.pend = head.pstart + merged.shape[0]
    return out


def cubic_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise volumetric IoU between two aligned trajectory stacks.

    boxes: (n, T, 4) — all trajectories share the same T frames. Returns
    (n1, n2). Same math as trajectory.py:85-141 (+1 pixel convention),
    computed with broadcasting over (T, n1, n2) in one shot.
    """
    b1 = np.asarray(boxes1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    a = b1.transpose(1, 0, 2)[:, :, None, :]  # (T, n1, 1, 4)
    b = b2.transpose(1, 0, 2)[:, None, :, :]  # (T, 1, n2, 4)
    iw = np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]) + 1, 0, None)
    inter = np.sum(iw * ih, axis=0)  # (n1, n2)
    vol1 = np.sum((b1[..., 2] - b1[..., 0] + 1) * (b1[..., 3] - b1[..., 1] + 1), axis=1)
    vol2 = np.sum((b2[..., 2] - b2[..., 0] + 1) * (b2[..., 3] - b2[..., 1] + 1), axis=1)
    union = vol1[:, None] + vol2[None, :] - inter
    return inter / union


def traj_iou(trajs1: List[Trajectory], trajs2: List[Trajectory]) -> np.ndarray:
    """Pairwise cubic IoU of Trajectory lists (aligned spans)."""
    b1 = np.stack([t.rois for t in trajs1])
    b2 = b1 if trajs1 is trajs2 else np.stack([t.rois for t in trajs2])
    return cubic_iou(b1, b2)


def overlap_traj_iou(t1: Trajectory, t2: Trajectory) -> float:
    """Cubic IoU restricted to the temporal overlap of two tracklets.

    Semantics of association._traj_iou (association.py:35-48): zero when
    disjoint; otherwise IoU of the clipped, aligned windows.
    """
    if t1.pend <= t2.pstart or t2.pend <= t1.pstart:
        return 0.0
    first, second = (t1, t2) if t1.pstart <= t2.pstart else (t2, t1)
    a = first.rois[second.pstart - first.pstart: first.pend - first.pstart]
    b = second.rois[: first.pend - second.pstart]
    return float(cubic_iou(a[None], b[None])[0, 0])


def load_trajectory_proposals(
    vid: str, fstart: int, fend: int, gt: bool = False, logit_only: bool = False
):
    """Load cached per-segment trajectory proposals (traj_cls JSON).

    Mirrors trajectory.object_trajectory_proposal (trajectory.py:161-180)
    and VRDataset._get_object_trajectory_proposal; missing file -> [].
    """
    path = get_traj_proposal_file(vid, fstart, fend, gt=gt)
    if not os.path.exists(path):
        return []
    with open(path, "r") as f:
        raw = json.load(f)
    if logit_only:
        return [t["classeme"] for t in raw]
    return [Trajectory(**t) for t in raw]


def save_trajectory_proposals(
    trajs: List[Trajectory], vid: str, fstart: int, fend: int, gt: bool = False
) -> str:
    """Write proposals in the reference's traj_cls JSON layout."""
    path = get_traj_proposal_file(vid, fstart, fend, gt=gt)
    with open(path, "w") as f:
        json.dump([t.serialize() for t in trajs], f)
    return path
