"""Hierarchical configuration (copy of tspn_tpu/config/config.py).

The same key hierarchy as the reference's yacs tree (MODEL / SOLVER /
DATASET / PREDICT / RELPN / ETC) plus the MESH and BUCKETS sections, so
every ``configs/*.yaml`` merges unchanged. A small attribute dict with
yacs-style ``merge_from_file`` / ``merge_from_list`` / ``dump``. PyYAML
is imported only inside the functions that parse or write YAML.
``tests/test_torch_host.py`` holds the defaults and the merge of every
``configs/*.yaml`` equal to the original's. ``compute_dtype`` reads
MODEL.DTYPE as a torch dtype.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable


class Config(dict):
    """A dict with attribute access and yacs-style merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    # -- merging ----------------------------------------------------------
    def merge_from_dict(self, other: dict) -> None:
        for key, value in other.items():
            if key not in self:
                raise KeyError(f"Unknown config key: {key}")
            current = self[key]
            if isinstance(current, Config):
                if not isinstance(value, dict):
                    raise TypeError(
                        f"Config node {key} must merge from a mapping, got {type(value)}"
                    )
                current.merge_from_dict(value)
            else:
                self[key] = _coerce(value, current)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[Any]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError("merge_from_list expects KEY VALUE pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                import yaml

                value = yaml.safe_load(value)
            node[leaf] = _coerce(value, node[leaf])

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def dump_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump())

    @staticmethod
    def from_dict(data: dict) -> "Config":
        node = Config()
        for key, value in data.items():
            node[key] = Config.from_dict(value) if isinstance(value, dict) else value
        return node


def _coerce(value: Any, reference: Any) -> Any:
    """Coerce a merged value to the default's type where that is safe."""
    if reference is None or value is None:
        return value
    if isinstance(reference, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Expected bool, got {value!r}")
    if isinstance(reference, float) and isinstance(value, (int, float, str)):
        return float(value)
    if isinstance(reference, int) and not isinstance(reference, bool):
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, int):
            return value
        raise TypeError(f"Expected int, got {value!r}")
    if isinstance(reference, (list, tuple)):
        return list(value)
    return value


def get_default_config() -> Config:
    """Default config tree: a key-for-key superset of the reference's
    defaults, so its YAMLs merge cleanly. The comments of the original
    explain each key; the values here are the same."""
    return Config.from_dict(
        {
            "MODEL": {
                "NAME": "baseline",
                "DTYPE": "float32",
                # feats flow RAW in the device layout and the classifier
                # kernel L1-normalizes them
                "FUSED_CLASSIFIER": False,
            },
            "FEATURES": {
                "APPEARANCE": "learned",
            },
            "SOLVER": {
                "MAX_ITER": 2000,
                "BASE_LR": 1e-2,
                "BIAS_LR_FACTOR": 2,
                "WEIGHT_DECAY": 5e-4,
                "WEIGHT_DECAY_BIAS": 0.0,
                "OPTIMIZER": {
                    "TYPE": "adam",  # "sgd"
                    "MOMENTUM": 0.9,
                },
                "SCHEDULER": {
                    "TYPE": "warmup_multi",  # "multi", "plateau"
                    "MILESTONES": [1000, 1500],
                    "GAMMA": 0.1,
                    "WARMUP_FACTOR": 1.0 / 3,
                    "WARMUP_ITERS": 500,
                    "WARMUP_METHOD": "linear",
                },
            },
            "DATASET": {
                "TRAIN_BATCH_SIZE": 1024,
                "TEST_BATCH_SIZE": 1,
                "TRAIN_NUM_WORKERS": 0,
                "TEST_NUM_WORKERS": 4,
                "LOGIT_ONLY": False,
                "USE_GT_OBJ_TRAJS": False,
            },
            "PREDICT": {
                "OBJECT_NUM": 35,
                "PREDICATE_NUM": 132,
                "TOPK_PER_PAIR": 20,
                "TOPK_PER_SEG": 200,
                "FEATURE_DIM": 11070,
                # "" = per-segment h5 files; "f32" / "q8" / "q8f" = one
                # consolidated store per split
                "CONSOLIDATED": "",
                "SHARD_INFERENCE": False,
            },
            "RELPN": {
                "OBJECT_DIM": 1024,
                "USE_PPN": True,
                "USE_DPN": True,
                "PPN": {
                    "NUM_PAIR_PROPOSALS": 256,
                    "IN_CHANNELS": 35,
                    "HIDDEN_CHANNELS": 64,
                    "OUT_CHANNELS": 35,
                    "BATCH_SIZE_PER_SEGMENT": 256,
                    "POSITIVE_FRACTION": 0.5,
                    # score only the top NUM_PAIR_PROPOSALS pair rows at
                    # inference
                    "PRUNE_AT_INFERENCE": False,
                    # multiply the PPN pair relatedness into the final
                    # relation confidence when pruning
                    "FUSE_SCORE": False,
                },
                "DPN": {
                    "NUM_DURATION_PROPOSALS": 64,
                    "DPN_ONLY": False,
                    "IN_CHANNELS": 1024,
                    "NUM_ANCHORS_PER_LOCATION": 4,
                    "ANCHOR_SIZES": [15, 30, 45, 60],
                    "ANCHOR_STRIDE": 15,
                    "FG_IOU_THRESHOLD": 0.7,
                    "BG_IOU_THRESHOLD": 0.3,
                    "NMS_THRESHOLD": 0.5,
                    "JOINT_OBJECTIVE": False,
                    "AUGMENT": False,
                },
            },
            "ETC": {
                "RANDOM_SEED": 0,
                "DISPLAY_FREQ": 1,
                "SAVE_FREQ": 20,
                "MODEL_DUMP_FILE": "baseline_weights_epoch_100.pt",
                "OUTPUT_DIR": "./vidvrd-baseline-output",
            },
            "MESH": {
                "DATA_AXIS": "data",
                "NUM_DEVICES": -1,  # -1: all available devices
            },
            "BUCKETS": {
                # each segment is padded up to the smallest bucket >= its
                # proposal count
                "NUM_TRACKLETS": [8, 16, 24, 32],
                "SEGMENTS_PER_STEP": 8,
            },
        }
    )


def compute_dtype(cfg):
    """MODEL.DTYPE as a torch dtype: torch.bfloat16 for "bfloat16", else
    torch.float32. It is the model's compute dtype and the dtype of the
    float feature leaves; parameters stay f32."""
    import torch

    if cfg.MODEL.get("DTYPE", "float32") == "bfloat16":
        return torch.bfloat16
    return torch.float32
