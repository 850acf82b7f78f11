"""Seeded in-memory segments at full VidVRD width, for serving and
training without data.

Per segment of N tracklets, with the statistics of the JAX package's
synthetic artifacts (tspn_tpu/data/synthetic.py):

* classeme logits: normal(0, 0.3) per category, +6 at the tracklet's own;
* motion BoW: sparse counts, each of the 4 x 1000 per-tracklet bins set
  to 1 with probability 0.002;
* relative rows: normal(0, 0.05), with 3.0 at the predicate slot of a
  few related pairs, whose multi-hot labels (P, R) mark that predicate.

Pairs are all ordered (i, j), i != j, subject-major. A set is made in
one of four modes:

* "q8f": factored int8 records (per-tracklet descriptors + per-pair
  relative rows), the BoW blocks L1-normalized before quantization;
* "q8": expanded int8 device-layout rows, likewise;
* "f32": storage-layout f32 rows with host-normalized BoW blocks (what
  the unfused model reads), with labels;
* "f32dev": the same rows RAW in the device layout (what the fused
  model reads; its kernel normalizes), with labels.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.data.loader import SegmentRecord
from tspn_tpu_torch.ops import pairwise as pw


def ordered_pairs(n: int) -> np.ndarray:
    """All ordered (i, j), i != j, subject-major -> (n(n-1), 2) int64."""
    sub, obj = np.nonzero(~np.eye(n, dtype=bool))
    return np.stack([sub, obj], axis=1).astype(np.int64)


MODES = ("q8f", "q8", "f32", "f32dev")


class InMemorySegments:
    """Dataset view over a list of SegmentRecords (the loader's contract);
    ``mode`` is the records' kind, one of MODES."""

    def __init__(self, records: List[SegmentRecord], mode: str):
        if mode not in MODES:
            raise ValueError(f"unknown segment mode {mode!r}")
        self.records = records
        self.quantized = mode in ("q8f", "q8")
        self.factored = mode == "q8f"
        self.index = [r.index for r in records]

    def __len__(self) -> int:
        return len(self.records)

    def num_proposals_of(self, i: int) -> int:
        return self.records[i].num_proposals

    def load_segment(self, i: int, with_labels: bool = True) -> SegmentRecord:
        record = self.records[i]
        if not with_labels and record.labels is not None:
            return dataclasses.replace(record, labels=None)
        return record

    def feature_width(self) -> int:
        return int(self.records[0].feats.shape[1])


def _l1_blocks(bow: np.ndarray, size: int) -> np.ndarray:
    blocks = bow.reshape(bow.shape[0], -1, size)
    denom = blocks.sum(axis=-1, keepdims=True)
    return (blocks / np.where(denom > 0, denom, 1.0)).reshape(bow.shape)


def synthetic_segments(
    num_segments: int, mode: str, seed: int = 0, num_objects: int = 35,
    num_predicates: int = 132, max_tracklets: int = 32,
    relations_per_segment: int = 4,
) -> InMemorySegments:
    """``num_segments`` segments of 2..max_tracklets tracklets, at least
    half of them at max_tracklets, as records of ``mode`` (see MODES)."""
    rng = np.random.RandomState(seed)
    layout = FeatureLayout.for_objects(num_objects)
    c, bs = layout.classeme_dim, layout.bow_block_size
    half = layout.num_bow_blocks // 2 * bs
    n_full = (num_segments + 1) // 2
    sizes = np.concatenate([
        np.full(n_full, max_tracklets),
        rng.randint(2, max_tracklets, size=num_segments - n_full),
    ])
    rng.shuffle(sizes)
    records = []
    for k, n in enumerate(sizes):
        n = int(n)
        pairs = ordered_pairs(n)
        cats = rng.randint(num_objects, size=n)
        cls = rng.normal(0, 0.3, size=(n, c)).astype(np.float32)
        cls[np.arange(n), cats] += 6.0
        raw = (rng.rand(n, half) < 0.002).astype(np.float32)
        bow = raw if mode == "f32dev" else _l1_blocks(raw, bs)
        rel = rng.normal(0, 0.05, size=(pairs.shape[0], layout.rel_dim)).astype(np.float32)
        hot = rng.randint(pairs.shape[0], size=relations_per_segment)
        preds = rng.randint(num_predicates, size=relations_per_segment)
        rel[hot, preds] = 3.0
        labels = scales = trk_q = trk_s = None
        if mode == "q8f":
            trk_q, trk_s = pw.factor_tracklet_features_q8(cls, bow, layout)
            feats, scales = pw.factor_rel_features_q8(rel, layout)
        else:
            rows = np.concatenate(
                [cls[pairs[:, 0]], cls[pairs[:, 1]], bow[pairs[:, 0]],
                 bow[pairs[:, 1]], rel], axis=1,
            )
            if mode == "q8":
                feats, head_scale = pw.to_device_layout_q8(rows, layout)
                scales = pw.precompute_q8_scales(feats, head_scale, layout)
            else:
                feats = pw.to_device_layout(rows, layout) if mode == "f32dev" else rows
                labels = np.zeros((pairs.shape[0], num_predicates), np.float32)
                labels[hot, preds] = 1.0
        records.append(SegmentRecord(
            index=(f"SYN_{seed:02d}_{k:05d}", 0, 30),
            feats=feats, pairs=pairs, labels=labels, cls_logits=cls,
            num_proposals=n, iou=np.eye(n, dtype=np.float32),
            trackid=np.full(n, -1, np.int64), q8_scales=scales,
            trk_feats=trk_q, trk_scales=trk_s,
        ))
    return InMemorySegments(records, mode)
