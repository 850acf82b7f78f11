"""Annotation layer (copy of tspn_tpu/data/annotations.py): VidVRD and
VidOR JSON annotations with a shared vocabulary.

Semantics that must match exactly, or ids shift:

* vocab = sorted() over the union of categories / predicates observed in
  ALL loaded splits; index = position in sorted order.
* get_index falls back to substring split-name inference.
* instance accessors return the same dict schemas.

Host-side pure Python; ``BaseVidVRD`` and ``BaseVidOR`` are the
reference-compatible aliases of ``tspn_tpu/data/__init__.py``.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


class AnnotationDataset:
    """Per-video JSON annotations + category/predicate vocabulary.

    Covers both the plain and the "VERSION 1.0" (VidOR) annotation
    formats; `low_memory=True` drops trajectories at load and re-reads
    the JSON on demand (dataset.py:211-254).
    """

    #: None -> forbid a "version" field (VidVRD); otherwise required value.
    required_version: Optional[str] = None

    def __init__(
        self,
        anno_rpath: str,
        video_rpath: str,
        splits: Sequence[str],
        low_memory: bool = False,
    ):
        self.anno_rpath = anno_rpath
        self.video_rpath = video_rpath
        self.low_memory = low_memory
        self.split_index: Dict[str, List[str]] = defaultdict(list)
        self.annos: Dict[str, dict] = {}
        self._load(splits)

    # ------------------------------------------------------------------ load
    def _anno_files(self, split: str) -> List[str]:
        raise NotImplementedError

    def _validate(self, anno: dict) -> dict:
        if self.required_version is None:
            assert "version" not in anno, "unexpected version field in annotation"
        else:
            assert anno.get("version") == self.required_version, (
                f"annotation version must be {self.required_version!r}"
            )
            if self.low_memory:
                del anno["trajectories"]
        return anno

    def _load(self, splits: Sequence[str]) -> None:
        objects, predicates = set(), set()
        for split in splits:
            paths = self._anno_files(split)
            assert len(paths) > 0, (
                f"No annotation file found for split {split!r} under {self.anno_rpath}"
            )
            for path in paths:
                with open(path, "r") as f:
                    anno = self._validate(json.load(f))
                vid = anno["video_id"]
                self.annos[vid] = anno
                self.split_index[split].append(vid)
                for obj in anno["subject/objects"]:
                    objects.add(obj["category"])
                for rel in anno["relation_instances"]:
                    predicates.add(rel["predicate"])
        # sorted-order vocabulary: ids are positions in lexicographic order
        self.soid2so = dict(enumerate(sorted(objects)))
        self.so2soid = {name: i for i, name in self.soid2so.items()}
        self.pid2pred = dict(enumerate(sorted(predicates)))
        self.pred2pid = {name: i for i, name in self.pid2pred.items()}

    # ------------------------------------------------------------ vocabulary
    def get_object_num(self) -> int:
        return len(self.soid2so)

    def get_object_name(self, cid: int) -> str:
        return self.soid2so[cid]

    def get_object_id(self, name: str) -> int:
        return self.so2soid[name]

    def get_predicate_num(self) -> int:
        return len(self.pid2pred)

    def get_predicate_name(self, pid: int) -> str:
        return self.pid2pred[pid]

    def get_predicate_id(self, name: str) -> int:
        return self.pred2pid[name]

    # --------------------------------------------------------------- access
    def infer_test_split(self) -> str:
        """The evaluation split's actual name: 'test' when resolvable
        (VidVRD), otherwise 'validation' (VidOR's naming)."""
        try:
            self.get_index("test")
            return "test"
        except KeyError:
            return "validation"

    def get_index(self, split: str) -> List[str]:
        """Video ids of a split, with substring-based name inference."""
        if split in self.split_index:
            return self.split_index[split]
        for s in self.split_index:
            if split in s:
                print(f"INFO: infer the split name '{s}' in this dataset from '{split}'")
                return self.split_index[s]
        raise KeyError(f'Unknown split "{split}" in the loaded dataset')

    def get_anno(self, vid: str) -> dict:
        if not self.low_memory:
            return self.annos[vid]
        for split, vids in self.split_index.items():
            if vid in vids:
                rel = self.annos[vid]["video_path"].replace(".mp4", ".json")
                with open(os.path.join(self.anno_rpath, split, rel), "r") as f:
                    return json.load(f)
        raise KeyError(f"{vid} not found in any split in the loaded dataset")

    def get_video_path(self, vid: str) -> str:
        raise NotImplementedError

    def _get_action_predicates(self) -> List[str]:
        raise NotImplementedError

    # ----------------------------------------------------------- instances
    def get_object_insts(self, vid: str) -> List[dict]:
        """Labeled object trajectories: tid, category, {fid: box} dict."""
        anno = self.get_anno(vid)
        tid2cls = {o["tid"]: o["category"] for o in anno["subject/objects"]}
        trajectories: Dict[int, Dict[str, tuple]] = defaultdict(dict)
        for fid, frame in enumerate(anno["trajectories"]):
            for roi in frame:
                b = roi["bbox"]
                trajectories[roi["tid"]][str(fid)] = (
                    b["xmin"], b["ymin"], b["xmax"], b["ymax"],
                )
        return [
            {"tid": tid, "category": tid2cls[tid], "trajectory": traj}
            for tid, traj in trajectories.items()
        ]

    def get_action_insts(self, vid: str) -> List[dict]:
        """Relation instances whose predicate is an action verb."""
        anno = self.get_anno(vid)
        actions = set(self._get_action_predicates())
        insts = []
        for rel in anno["relation_instances"]:
            if rel["predicate"] not in actions:
                continue
            begin, end = rel["begin_fid"], rel["end_fid"]
            traj = []
            for frame in anno["trajectories"][begin:end]:
                for roi in frame:
                    if roi["tid"] == rel["subject_tid"]:
                        b = roi["bbox"]
                        traj.append((b["xmin"], b["ymin"], b["xmax"], b["ymax"]))
            insts.append({
                "category": rel["predicate"],
                "duration": (begin, end),
                "trajectory": traj,
            })
        return insts

    def get_relation_insts(self, vid: str, no_traj: bool = False) -> List[dict]:
        """Visual relation instances; no_traj skips per-frame boxes."""
        anno = self.get_anno(vid)
        tid2cls = {o["tid"]: o["category"] for o in anno["subject/objects"]}
        if not no_traj:
            frame_boxes: List[Dict[int, tuple]] = []
            for frame in anno["trajectories"]:
                frame_boxes.append({
                    roi["tid"]: (
                        roi["bbox"]["xmin"], roi["bbox"]["ymin"],
                        roi["bbox"]["xmax"], roi["bbox"]["ymax"],
                    )
                    for roi in frame
                })
        insts = []
        for rel in anno["relation_instances"]:
            inst = {
                "triplet": (
                    tid2cls[rel["subject_tid"]],
                    rel["predicate"],
                    tid2cls[rel["object_tid"]],
                ),
                "subject_tid": rel["subject_tid"],
                "object_tid": rel["object_tid"],
                "duration": (rel["begin_fid"], rel["end_fid"]),
            }
            if not no_traj:
                window = frame_boxes[rel["begin_fid"]:rel["end_fid"]]
                inst["sub_traj"] = [fb[rel["subject_tid"]] for fb in window]
                inst["obj_traj"] = [fb[rel["object_tid"]] for fb in window]
            insts.append(inst)
        return insts

    def get_triplets(self, split: str) -> set:
        triplets = set()
        for vid in self.get_index(split):
            triplets.update(
                inst["triplet"] for inst in self.get_relation_insts(vid, no_traj=True)
            )
        return triplets


class VidVRD(AnnotationDataset):
    """ImageNet-VidVRD: flat {split}/*.json annotations, 35 objects / 132
    predicates (base_vidvrd.py:7-42)."""

    required_version = None

    def __init__(self, anno_rpath, video_rpath, splits):
        super().__init__(anno_rpath, video_rpath, splits, low_memory=False)
        print("VidVRD dataset loaded.")

    def _anno_files(self, split):
        return sorted(glob.glob(os.path.join(self.anno_rpath, split, "*.json")))

    def get_video_path(self, vid, imagenet_struture: bool = False):
        if imagenet_struture:
            if "train" in vid:
                matches = glob.glob(os.path.join(
                    self.video_rpath, "Data/VID/snippets/train/*", f"{vid}.mp4"))
                return matches[0]
            if "val" in vid:
                return os.path.join(
                    self.video_rpath, "Data/VID/snippets/val", f"{vid}.mp4")
            raise KeyError(f"Unknown video ID {vid}")
        return os.path.join(self.video_rpath, f"{vid}.mp4")


class VidOR(AnnotationDataset):
    """VidOR: nested {split}/{group}/*.json VERSION 1.0 annotations, 80
    objects / 50 predicates (base_vidor.py:7-43)."""

    required_version = "VERSION 1.0"

    ACTIONS = [
        "watch", "bite", "kiss", "lick", "smell", "caress", "knock", "pat",
        "point_to", "squeeze", "hold", "press", "touch", "hit", "kick",
        "lift", "throw", "wave", "carry", "grab", "release", "pull",
        "push", "hug", "lean_on", "ride", "chase", "get_on", "get_off",
        "hold_hand_of", "shake_hand_with", "wave_hand_to", "speak_to",
        "shout_at", "feed", "open", "close", "use", "cut", "clean",
        "drive", "play(instrument)",
    ]

    def __init__(self, anno_rpath, video_rpath, splits, low_memory=True):
        super().__init__(anno_rpath, video_rpath, splits, low_memory=low_memory)
        suffix = " (low memory mode enabled)" if low_memory else ""
        print(f"VidOR dataset loaded.{suffix}")

    def _anno_files(self, split):
        return sorted(glob.glob(os.path.join(self.anno_rpath, split, "*", "*.json")))

    def _get_action_predicates(self):
        for action in self.ACTIONS:
            assert action in self.pred2pid, f"action predicate {action} missing"
        return list(self.ACTIONS)

    def get_video_path(self, vid):
        return os.path.join(self.video_rpath, self.annos[vid]["video_path"])


# reference-compatible aliases
BaseVidVRD = VidVRD
BaseVidOR = VidOR
