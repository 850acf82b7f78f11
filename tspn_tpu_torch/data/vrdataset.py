"""Segment-level relation dataset over the per-segment h5 artifacts (copy
of ``SegmentDataset`` and its helpers in tspn_tpu/data/vrdataset.py, with
the reads of tspn_tpu/data/feature_store.py that it needs).

``SegmentDataset`` enumerates the segments that carry GT relations and
assembles the port's ``SegmentRecord``s (data/loader.py): labels indexed
by pair row and OR-ed over GT relations (the two deliberate departures
of the JAX package from the reference), proposal-proposal pairs only,
BoW blocks L1-normalized on the host, or rows RAW in the device layout
under ``MODEL.FUSED_CLASSIFIER``. h5py is imported only inside the
functions that read a file. ``tests/test_torch_host.py`` holds the
records equal to the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from tspn_tpu_torch.config import compute_dtype
from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.data.loader import SegmentRecord
from tspn_tpu_torch.data.segments import get_relation_feature_file, segment_video
from tspn_tpu_torch.data.trajectory import load_trajectory_proposals

SegmentIndex = Tuple[str, int, int]


@dataclass
class SegmentFeatures:
    """Raw contents of one <vsig>-relation.h5 file.

    trackid: (N+GT,) int — proposals are -1, GT tracks carry dataset tids
    pairs:   (P, 2) int  — ordered pairs among the N+GT tracklets
    feats:   (P, dim) float32 — per-pair relation feature
    iou:     (N+GT, N+GT) float32 — cubic IoU between tracklets
    """

    trackid: np.ndarray
    pairs: np.ndarray
    feats: np.ndarray
    iou: np.ndarray

    @property
    def num_tracklets(self) -> int:
        return int(self.trackid.shape[0])


def segment_feature_exists(vid: str, fstart: int, fend: int) -> bool:
    return os.path.exists(get_relation_feature_file(vid, fstart, fend))


def read_segment_features(vid: str, fstart: int, fend: int) -> Optional[SegmentFeatures]:
    import h5py

    path = get_relation_feature_file(vid, fstart, fend)
    if not os.path.exists(path):
        return None
    with h5py.File(path, "r") as f:
        return SegmentFeatures(
            trackid=np.asarray(f["trackid"][:]),
            pairs=np.asarray(f["pairs"][:]),
            feats=np.asarray(f["feats"][:], dtype=np.float32),
            iou=np.asarray(f["iou"][:], dtype=np.float32),
        )


def l1_normalize_bow_blocks(feats: np.ndarray, layout: FeatureLayout) -> np.ndarray:
    """L1-normalize the eight 1000-d BoW blocks of storage-layout rows;
    a zero block is left unchanged."""
    lo, hi = layout.bow_start, layout.rel_start
    out = np.array(feats, dtype=np.float32, copy=True)
    bow = out[:, lo:hi].reshape(
        out.shape[0], layout.num_bow_blocks, layout.bow_block_size
    )
    denom = np.sum(np.abs(bow), axis=-1, keepdims=True)
    denom[denom == 0] = 1.0
    out[:, lo:hi] = (bow / denom).reshape(out.shape[0], hi - lo)
    return out


class SegmentDataset:
    """Enumerates segments with GT relations and assembles SegmentRecords.

    The train phase tiles each GT relation's duration into 30/15
    segments; the test phase tiles the whole video; segments without a
    cached feature file are dropped.
    """

    def __init__(self, cfg, dataset, phase: str):
        self.cfg = cfg
        self.phase = phase
        self.num_predicates = cfg.PREDICT.PREDICATE_NUM
        self.num_objects = cfg.PREDICT.OBJECT_NUM
        self.logit_only = cfg.DATASET.LOGIT_ONLY
        self.use_gt_obj_trajs = cfg.DATASET.USE_GT_OBJ_TRAJS
        self.iou_threshold = 0.5
        # fused classifier: features stay RAW, in the device layout
        self.fused = bool(cfg.MODEL.get("FUSED_CLASSIFIER", False))

        self.gt_rel_insts: Dict[SegmentIndex, List[tuple]] = {}
        is_train = "train" in phase  # 'train' and VidOR's 'training'
        for vid in dataset.get_index(split=phase):
            anno = None if is_train else dataset.get_anno(vid)
            for rel in dataset.get_relation_insts(vid, no_traj=True):
                sub_name, pred_name, obj_name = rel["triplet"]
                entry = (
                    rel["subject_tid"],
                    rel["object_tid"],
                    dataset.get_object_id(sub_name),
                    dataset.get_object_id(obj_name),
                    dataset.get_predicate_id(pred_name),
                )
                if is_train:
                    segs = segment_video(*rel["duration"])
                else:
                    segs = segment_video(0, anno["frame_count"])
                for fstart, fend in segs:
                    if segment_feature_exists(vid, fstart, fend):
                        self.gt_rel_insts.setdefault((vid, fstart, fend), []).append(entry)
        self.index: List[SegmentIndex] = list(self.gt_rel_insts.keys())

    def __len__(self) -> int:
        return len(self.index)

    def _match_labels(self, seg: SegmentFeatures, insts: List[tuple]) -> np.ndarray:
        """(P_all, num_predicates) multi-hot over ALL pair rows: proposal
        pair (i, j) is positive for predicate p if some GT relation
        (s, p, o) has iou(i, gt_s) >= 0.5 and iou(j, gt_o) >= 0.5, i != j,
        and both i and j are proposals."""
        n_all = seg.num_tracklets
        labels_matrix = np.zeros((n_all, n_all, self.num_predicates), dtype=np.float32)
        is_proposal = seg.trackid < 0
        gt_pos = {int(tid): k for k, tid in enumerate(seg.trackid) if tid >= 0}
        for sub_tid, obj_tid, _sub_cls, _obj_cls, pred_idx in insts:
            if sub_tid not in gt_pos or obj_tid not in gt_pos:
                continue
            sub_hit = (seg.iou[:, gt_pos[sub_tid]] >= self.iou_threshold) & is_proposal
            obj_hit = (seg.iou[:, gt_pos[obj_tid]] >= self.iou_threshold) & is_proposal
            pos = np.outer(sub_hit, obj_hit)
            np.fill_diagonal(pos, False)
            labels_matrix[..., pred_idx] = np.maximum(
                labels_matrix[..., pred_idx], pos.astype(np.float32)
            )
        return labels_matrix[seg.pairs[:, 0], seg.pairs[:, 1]]

    def num_proposals_of(self, idx: int) -> int:
        """Cheap bucket probe: read only the small trackid dataset."""
        import h5py

        vid, fstart, fend = self.index[idx]
        with h5py.File(get_relation_feature_file(vid, fstart, fend), "r") as f:
            trackid = np.asarray(f["trackid"][:])
        return int(np.sum(trackid < 0))

    def load_segment(self, idx: int, with_labels: bool = True) -> SegmentRecord:
        index = self.index[idx]
        vid, fstart, fend = index
        seg = read_segment_features(vid, fstart, fend)
        if seg is None:
            raise FileNotFoundError(f"missing relation feature for {index}")

        labels = (
            self._match_labels(seg, self.gt_rel_insts[index])
            if with_labels else None
        )
        # keep only proposal-proposal pairs
        is_proposal = seg.trackid < 0
        keep = is_proposal[seg.pairs[:, 0]] & is_proposal[seg.pairs[:, 1]]
        layout = FeatureLayout.for_objects(self.num_objects)
        if self.fused:
            from tspn_tpu_torch.ops.pairwise import to_device_layout

            feats = to_device_layout(seg.feats[keep], layout)
        else:
            feats = l1_normalize_bow_blocks(seg.feats[keep], layout)
        pairs = seg.pairs[keep].astype(np.int64)
        if labels is not None:
            labels = labels[keep]

        return SegmentRecord(
            index=index,
            feats=feats,
            pairs=pairs,
            labels=labels,
            cls_logits=self._load_cls_logits(vid, fstart, fend),
            num_proposals=int(np.sum(is_proposal)),
            iou=seg.iou,
            trackid=seg.trackid.astype(np.int64),
        )

    def _load_cls_logits(self, vid: str, fstart: int, fend: int) -> np.ndarray:
        """Per-tracklet classeme logits from the traj_cls store."""
        trajs = load_trajectory_proposals(
            vid, fstart, fend, gt=self.use_gt_obj_trajs, logit_only=self.logit_only
        )
        rows = trajs if self.logit_only else [t.classeme for t in trajs]
        if not rows:
            return np.zeros((0, self.num_objects), dtype=np.float32)
        return np.asarray(rows, dtype=np.float32)


def effective_feats_dtype(cfg):
    """Dtype of the float feature leaves (``BucketedLoader(feats_dtype=)``):
    the model's compute dtype, ``config.compute_dtype`` (the JAX package's
    ``ml_dtypes.bfloat16`` / ``np.float32``)."""
    return compute_dtype(cfg)


def effective_feature_dim(cfg) -> int:
    """Per-pair feature width of the batch leaves: the storage layout
    (11070 for VidVRD, 11160 for VidOR), or the device layout (11264 /
    11392) under the fused classifier."""
    if cfg.MODEL.get("FUSED_CLASSIFIER", False):
        return FeatureLayout.for_objects(cfg.PREDICT.OBJECT_NUM).device_dim
    return cfg.PREDICT.FEATURE_DIM
