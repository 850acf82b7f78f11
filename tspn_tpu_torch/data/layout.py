"""Geometry of the per-pair relation feature vector (numpy only).

Copy of ``tspn_tpu/data/feature_store.py::FeatureLayout``; that module
imports h5py at its top, which the port's device path must not need.
``tests/test_torch_pairwise.py`` holds the two equal field by field.

Storage layout (the h5 artifacts), for C object categories:
    [0, 2C)              subject + object classeme
    [2C, 2C+8000)        8 x 1000 BoW blocks (sub 4, obj 4), L1-normalized
    [2C+8000, 2C+11000)  relative position / size / motion (3 x 1000)

Device layout: [classeme | relative | pad to 128 | 8 x (BoW 1000 + 24 pad)],
so every BoW block starts on a multiple of 64 bytes of an int8 row.
VidVRD (C = 35): dim 11070, dev_head_pad 3072, device_dim 11264.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class FeatureLayout:
    classeme_dim: int = 35
    num_bow_blocks: int = 8
    bow_block_size: int = 1000
    rel_dim: int = 3000
    dev_block: int = 1024  # BoW block slot in the device layout

    # ---- storage layout ----
    @property
    def head(self) -> int:
        return 2 * self.classeme_dim

    @property
    def bow_start(self) -> int:
        return self.head

    @property
    def rel_start(self) -> int:
        return self.head + self.num_bow_blocks * self.bow_block_size

    @property
    def dim(self) -> int:
        return self.rel_start + self.rel_dim

    @property
    def bow_block_starts(self) -> tuple:
        return tuple(
            self.bow_start + k * self.bow_block_size
            for k in range(self.num_bow_blocks)
        )

    # ---- device layout ----
    @property
    def dev_head_dim(self) -> int:
        return self.head + self.rel_dim

    @property
    def dev_head_pad(self) -> int:
        return round_up(self.dev_head_dim, 128)

    @property
    def device_dim(self) -> int:
        return self.dev_head_pad + self.num_bow_blocks * self.dev_block

    # ---- constructors ----
    @classmethod
    def for_objects(cls, num_objects: int) -> "FeatureLayout":
        return cls(classeme_dim=int(num_objects))

    @classmethod
    def from_dim(cls, dim: int) -> "FeatureLayout":
        """Infer the layout from a STORED width dim = 2C + 11000; device
        widths (11264, 11392, ...) are rejected."""
        c2 = dim - (8 * 1000 + 3000)
        if c2 < 2 or c2 % 2 or dim in _device_dims():
            raise ValueError(
                f"feature width {dim} does not match a 2C+11000 storage layout"
            )
        return cls(classeme_dim=c2 // 2)


@lru_cache(maxsize=1)
def _device_dims() -> frozenset:
    return frozenset(
        FeatureLayout(classeme_dim=c).device_dim for c in range(1, 513)
    )


DEFAULT_LAYOUT = FeatureLayout()  # VidVRD
