"""Greedy cross-segment relational association, on the host (copy of
tspn_tpu/association.py).

Segment-level (score, triplet, (s_tid, o_tid)) predictions are stitched
into video-level relations by greedily extending an existing relation
when the triplet matches and both subject and object tracklets overlap
the relation's trajectories with cubic IoU >= 0.5 inside the 15-frame
segment overlap. As in the JAX package, a relation started in a later
segment keeps its prediction's confidence (the reference records 1).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tspn_tpu_torch.data.segments import get_segment_signature
from tspn_tpu_torch.data.trajectory import (
    Trajectory,
    load_trajectory_proposals,
    merge_trajectories,
    overlap_traj_iou,
)


class VideoRelation:
    """A video-level relation instance under construction."""

    def __init__(self, vid, s_cid, pid, o_cid, straj: Trajectory, otraj: Trajectory, confs=1.0):
        self.vid = vid
        self.s_cid = int(s_cid)
        self.pid = int(pid)
        self.o_cid = int(o_cid)
        self.straj = straj
        self.otraj = otraj
        self.confs_list = [float(confs)]
        self.fstart = straj.pstart
        self.fend = straj.pend

    def __repr__(self):
        return "<VideoRelation {}[{:04d}-{:04d}] {}-{}-{}>".format(
            self.vid, self.fstart, self.fend, self.s_cid, self.pid, self.o_cid
        )

    def triplet(self) -> Tuple[int, int, int]:
        return (self.s_cid, self.pid, self.o_cid)

    def mean_confs(self) -> float:
        return float(np.mean(self.confs_list))

    def both_overlap(self, straj: Trajectory, otraj: Trajectory, iou_thr=0.5) -> bool:
        return (
            overlap_traj_iou(self.straj, straj) >= iou_thr
            and overlap_traj_iou(self.otraj, otraj) >= iou_thr
        )

    def extend(self, straj: Trajectory, otraj: Trajectory, confs: float):
        self.straj = merge_trajectories(self.straj, straj)
        self.otraj = merge_trajectories(self.otraj, otraj)
        self.confs_list.append(float(confs))
        self.fstart = self.straj.pstart
        self.fend = self.otraj.pend

    def serialize(self, dataset) -> dict:
        return {
            "triplet": [
                dataset.get_object_name(self.s_cid),
                dataset.get_predicate_name(self.pid),
                dataset.get_object_name(self.o_cid),
            ],
            "score": self.mean_confs(),
            "duration": [int(self.fstart), int(self.fend)],
            "sub_traj": [list(map(float, roi)) for roi in self.straj.rois],
            "obj_traj": [list(map(float, roi)) for roi in self.otraj.rois],
        }


def greedy_relational_association(
    dataset,
    short_term_relations: List[tuple],
    max_traj_num_in_clip: int = 100,
) -> List[dict]:
    """Stitch per-segment predictions into serialized video relations.

    short_term_relations: [(index, (pred_list, iou, trackid)), ...] where
    index = (vid, fstart, fend) — the grouping of the reference's
    base.py:92-96.
    """
    ordered = sorted(short_term_relations, key=lambda x: int(x[0][1]))
    video_relations: List[VideoRelation] = []
    last_modified: List[VideoRelation] = []

    for seg_i, (index, prediction) in enumerate(ordered):
        vid, fstart, fend = index
        pred_list = prediction[0]
        preds = sorted(pred_list, key=lambda x: x[0], reverse=True)[:max_traj_num_in_clip]

        trajs = load_trajectory_proposals(vid, fstart, fend)
        for traj in trajs:
            traj.pstart = fstart
            traj.pend = fend
            traj.vsig = get_segment_signature(vid, fstart, fend)

        current: List[VideoRelation] = []
        for conf, triplet, pair_tid in preds:
            s_cid, pid, o_cid = (int(v) for v in triplet)
            straj = trajs[int(pair_tid[0])].copy()
            otraj = trajs[int(pair_tid[1])].copy()
            merged = False
            if seg_i > 0:
                last_modified.sort(key=lambda r: r.mean_confs(), reverse=True)
                for rel in last_modified:
                    if (s_cid, pid, o_cid) != rel.triplet():
                        continue
                    if (
                        straj.pstart < rel.fend
                        and otraj.pstart < rel.fend
                        and rel.both_overlap(straj, otraj)
                    ):
                        rel.extend(straj, otraj, conf)
                        last_modified.remove(rel)
                        current.append(rel)
                        merged = True
                        break
            if not merged:
                rel = VideoRelation(vid, s_cid, pid, o_cid, straj, otraj, confs=conf)
                video_relations.append(rel)
                current.append(rel)
        last_modified = current

    return [rel.serialize(dataset) for rel in video_relations]
