"""VidVRD / VidOR annotations -> COCO-style per-frame dataset dicts (a copy
of tspn_tpu/detection/coco_format.py, held equal by
tests/test_torch_detector_train.py).

Plain dicts (file_name, image_id, height, width, annotations with XYXY
bbox + category_id) that the detection trainer consumes directly; ids are
always resolved through one vocabulary.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from tspn_tpu_torch.data.vocab import VIDOR_OBJECTS, VIDVRD_OBJECTS


def _anno_to_records(
    anno: dict, image_root: str, obj_to_idx: Dict[str, int], start_image_id: int
) -> List[dict]:
    vid = anno["video_id"]
    tid_to_cls = {o["tid"]: o["category"] for o in anno["subject/objects"]}
    records = []
    for fid, frame in enumerate(anno["trajectories"]):
        if not frame:
            continue
        objs = []
        for roi in frame:
            b = roi["bbox"]
            objs.append({
                "bbox": [b["xmin"], b["ymin"], b["xmax"], b["ymax"]],
                "bbox_mode": "XYXY_ABS",
                "category_id": obj_to_idx[tid_to_cls[roi["tid"]]],
                "tid": roi["tid"],
            })
        records.append({
            # frame files as written by the vidvrd_to_image.sh layout
            "file_name": os.path.join(image_root, vid, f"{fid + 1:05d}.jpg"),
            "image_id": start_image_id + fid,
            "video_id": vid,
            "frame_id": fid,
            "height": anno["height"],
            "width": anno["width"],
            "annotations": objs,
        })
    return records


def _convert(
    anno_files: Sequence[str], image_root: str, vocabulary: Sequence[str]
) -> List[dict]:
    obj_to_idx = {name: i for i, name in enumerate(vocabulary)}
    records = []
    next_id = 0
    for path in sorted(anno_files):
        with open(path, "r") as f:
            anno = json.load(f)
        recs = _anno_to_records(anno, image_root, obj_to_idx, next_id)
        next_id += len(anno["trajectories"])
        records.extend(recs)
    return records


def vidvrd_to_coco_format(
    anno_dir: str, split: str, image_root: str = "image",
    vocabulary: Optional[Sequence[str]] = None,
) -> List[dict]:
    """{anno_dir}/{split}/*.json -> dataset dicts (35-class VidVRD vocab)."""
    files = glob.glob(os.path.join(anno_dir, split, "*.json"))
    assert files, f"no annotations under {anno_dir}/{split}"
    return _convert(files, image_root, vocabulary or VIDVRD_OBJECTS)


def vidor_to_coco_format(
    anno_dir: str, split: str, image_root: str = "image",
    vocabulary: Optional[Sequence[str]] = None,
) -> List[dict]:
    """{anno_dir}/{split}/*/*.json -> dataset dicts (80-class VidOR vocab)."""
    files = glob.glob(os.path.join(anno_dir, split, "*", "*.json"))
    assert files, f"no annotations under {anno_dir}/{split}"
    return _convert(files, image_root, vocabulary or VIDOR_OBJECTS)


def dump_coco_json(records: List[dict], path: str) -> None:
    """Persist as one JSON list (the vidvrd_coco_format.json dump)."""
    with open(path, "w") as f:
        json.dump(records, f)
