"""Reading half of the consolidated store (copy of
tspn_tpu/data/preprocess.py: ``consolidated_path``, ``load_consolidated``,
``ConsolidatedStore`` and ``ConsolidatedSegmentDataset``).

A consolidated split file holds every segment's rows in one HDF5 (f32
storage rows, int8 ``q8`` device-layout rows with their scales, or the
factored ``q8f`` per-tracklet and per-pair rows) with per-segment offset
tables. Writing it (``consolidate_split``) is still the JAX package's
``--preprocess``. h5py is imported only inside the functions that read
a file.
"""

from __future__ import annotations

import os

import numpy as np

from tspn_tpu_torch.data.loader import SegmentRecord
from tspn_tpu_torch.data.segments import get_output_dir


def consolidated_path(phase: str) -> str:
    root = os.path.join(get_output_dir(), "preprocessed_data")
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"preprocessed_{phase}_dataset.hdf5")


def _strings(values) -> list:
    return [s.decode() if isinstance(s, bytes) else s for s in values]


def load_consolidated(path: str) -> dict:
    """Whole-file view of one consolidated store. Always carries "mode"
    ("f32" / "q8" / "q8f"); q8f stores also carry the per-tracklet half
    (trk_feats / trk_scales / trk_offsets)."""
    import h5py

    with h5py.File(path, "r") as f:
        quantized = bool(f.attrs.get("quantized", False))
        mode = str(f.attrs.get("mode", "q8" if quantized else "f32"))
        out = {
            "feats": np.asarray(f["feats"]),
            "pairs": np.asarray(f["pairs"]),
            "pred_label": np.asarray(f["pred_label"]),
            "segment_id": np.asarray(f["segment_id"]),
            "segments": _strings(f["segments"]),
            "mode": mode,
        }
        if quantized:
            out["q8_scales"] = np.asarray(f["q8_scales"])
        if mode == "q8f":
            out["trk_feats"] = np.asarray(f["trk_feats"])
            out["trk_scales"] = np.asarray(f["trk_scales"])
            out["trk_offsets"] = np.asarray(f["trk_offsets"])
        return out


class ConsolidatedStore:
    """Random access to one consolidated split file: per-segment reads of
    contiguous row slabs from a single open handle."""

    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")
        self.quantized = bool(self._f.attrs.get("quantized", False))
        self.mode = str(
            self._f.attrs.get("mode", "q8" if self.quantized else "f32")
        )
        self.factored = self.mode == "q8f"
        if self.factored:
            self._trk_off = np.asarray(self._f["trk_offsets"][:])
        self.num_objects = int(self._f.attrs["num_objects"])
        self.num_predicates = int(self._f.attrs["num_predicates"])
        self.signatures = _strings(self._f["segments"][:])
        self.row_ranges = np.asarray(self._f["row_ranges"][:])
        self._iou_off = np.asarray(self._f["iou_offsets"][:])
        self._tid_off = np.asarray(self._f["trackid_offsets"][:])
        self._cls_off = np.asarray(self._f["cls_logits_offsets"][:])
        self.num_proposals = np.asarray(self._f["num_proposals"][:])
        self.index_of = {sig: k for k, sig in enumerate(self.signatures)}
        # h5py makes a new Dataset proxy on every group lookup: resolve
        # each dataset once
        names = ["feats", "pairs", "pred_label", "iou_flat",
                 "trackid_flat", "cls_logits_flat"]
        if self.quantized:
            names.append("q8_scales")
        if self.factored:
            names += ["trk_feats", "trk_scales"]
        self._ds = {name: self._f[name] for name in names}

    def close(self):
        self._f.close()

    def __len__(self) -> int:
        return len(self.signatures)

    def read(self, k: int, with_labels: bool = True) -> dict:
        """-> dict with feats, pairs, labels (None without labels),
        cls_logits, iou, trackid, num_proposals for segment k, plus
        q8_scales and the tracklet half where the store has them."""
        lo, hi = self.row_ranges[k]
        n_tid = self._tid_off[k + 1] - self._tid_off[k]
        n_all = int(np.sqrt(self._iou_off[k + 1] - self._iou_off[k]))
        if n_tid != n_all:
            raise ValueError(f"segment {k}: {n_tid} track ids for a {n_all}-wide iou")
        ds = self._ds
        out = {
            "feats": np.asarray(ds["feats"][lo:hi]),
            "pairs": np.asarray(ds["pairs"][lo:hi]),
            "labels": (
                np.asarray(ds["pred_label"][lo:hi]) if with_labels else None
            ),
            "iou": np.asarray(
                ds["iou_flat"][self._iou_off[k] : self._iou_off[k + 1]]
            ).reshape(n_all, n_all),
            "trackid": np.asarray(
                ds["trackid_flat"][self._tid_off[k] : self._tid_off[k + 1]]
            ),
            "cls_logits": np.asarray(
                ds["cls_logits_flat"][self._cls_off[k] : self._cls_off[k + 1]]
            ).reshape(-1, self.num_objects),
            "num_proposals": int(self.num_proposals[k]),
        }
        if self.quantized:
            out["q8_scales"] = np.asarray(ds["q8_scales"][lo:hi])
        if self.factored:
            t0, t1 = self._trk_off[k], self._trk_off[k + 1]
            out["trk_feats"] = np.asarray(ds["trk_feats"][t0:t1])
            out["trk_scales"] = np.asarray(ds["trk_scales"][t0:t1])
        return out


def _parse_signature(sig: str):
    """'<vid>-<fstart:04d>-<fend:04d>' -> (vid, fstart, fend); vids may
    themselves contain dashes, so split from the right."""
    vid, fstart, fend = sig.rsplit("-", 2)
    return vid, int(fstart), int(fend)


class ConsolidatedSegmentDataset:
    """SegmentDataset-shaped view over one consolidated split file (the
    loader's contract: ``index``, ``load_segment``, ``num_proposals_of``)."""

    def __init__(self, cfg, store_path: str):
        self.cfg = cfg
        self.store = ConsolidatedStore(store_path)
        self.quantized = self.store.quantized
        self.factored = self.store.factored
        self.num_predicates = self.store.num_predicates
        self.num_objects = self.store.num_objects
        if self.num_predicates != cfg.PREDICT.PREDICATE_NUM:
            raise ValueError(
                f"store has {self.num_predicates} predicates, config "
                f"{cfg.PREDICT.PREDICATE_NUM}"
            )
        if self.num_objects != cfg.PREDICT.OBJECT_NUM:
            raise ValueError(
                f"store was consolidated with a {self.num_objects}-wide "
                f"classeme layout but PREDICT.OBJECT_NUM is "
                f"{cfg.PREDICT.OBJECT_NUM}: rebuild the store or fix the config"
            )
        self.index = [_parse_signature(s) for s in self.store.signatures]

    def __len__(self) -> int:
        return len(self.index)

    def num_proposals_of(self, idx: int) -> int:
        return int(self.store.num_proposals[idx])

    def feature_width(self) -> int:
        """Stored per-pair width (device_dim when quantized)."""
        return int(self.store._ds["feats"].shape[1])

    def load_segment(self, idx: int, with_labels: bool = True) -> SegmentRecord:
        rec = self.store.read(idx, with_labels=with_labels)
        return SegmentRecord(
            index=self.index[idx],
            feats=rec["feats"],
            pairs=rec["pairs"].astype(np.int64),
            labels=rec["labels"],
            cls_logits=rec["cls_logits"],
            num_proposals=rec["num_proposals"],
            iou=rec["iou"],
            trackid=rec["trackid"].astype(np.int64),
            q8_scales=rec.get("q8_scales"),
            trk_feats=rec.get("trk_feats"),
            trk_scales=rec.get("trk_scales"),
        )
