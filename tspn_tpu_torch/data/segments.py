"""Temporal segmentation and artifact paths (copy of tspn_tpu/data/segments.py).

The 30-frame / 15-frame-overlap tiling of the whole system, segment
signature strings, and the on-disk layout of the intermediate features
(``<OUTPUT_DIR>/features/<name>/<vid>/...``), bit-compatible with the
artifacts of the JAX package's ``--preprocess``. The output root is a
module global, set from ``ETC.OUTPUT_DIR`` by the CLI.
"""

from __future__ import annotations

import os
from typing import List, Tuple

SEGMENT_LENGTH = 30
SEGMENT_STRIDE = 15

_output_dir = "./vidvrd-baseline-output"


def set_output_dir(path: str) -> None:
    """Redirect the artifact root."""
    global _output_dir
    _output_dir = path


def get_output_dir() -> str:
    return _output_dir


def get_segment_signature(vid: str, fstart: int, fend: int) -> str:
    return "{}-{:04d}-{:04d}".format(vid, fstart, fend)


def segment_video(fstart: int, fend: int) -> List[Tuple[int, int]]:
    """30-frame windows with 15-frame overlap over [fstart, fend): windows
    start every SEGMENT_STRIDE frames and only full windows are made."""
    return [
        (i, i + SEGMENT_LENGTH)
        for i in range(fstart, fend - SEGMENT_LENGTH + 1, SEGMENT_STRIDE)
    ]


def get_feature_path(name: str, vid: str) -> str:
    """Directory for per-video intermediate features, created on demand."""
    path = os.path.join(_output_dir, "features", name, vid)
    os.makedirs(path, exist_ok=True)
    return path


def get_model_path() -> str:
    path = os.path.join(_output_dir, "models")
    os.makedirs(path, exist_ok=True)
    return path


def get_relation_feature_file(vid: str, fstart: int, fend: int) -> str:
    vsig = get_segment_signature(vid, fstart, fend)
    return os.path.join(get_feature_path("relation", vid), f"{vsig}-relation.h5")


def get_traj_proposal_file(vid: str, fstart: int, fend: int, gt: bool = False) -> str:
    name = "traj_cls_gt" if gt else "traj_cls"
    vsig = get_segment_signature(vid, fstart, fend)
    return os.path.join(get_feature_path(name, vid), f"{vsig}-{name}.json")
