"""Operations and bytes that the work needs, counted from the published
architecture and a cell's shapes, never from what the program launched.

A multiply-add is two operations. Training counts three times the forward
of every layer whose weights get a gradient (forward, input gradient,
weight gradient), and twice for the stem, whose input (the images) takes
no gradient. Elementwise work (the frozen affines, ReLUs, pooling) is not
counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.arch import Arch, feature_hw, layers


def layer_flops(layer) -> int:
    h, w = layer.out_hw
    return 2 * h * w * layer.cout * layer.cin * layer.k * layer.k


def forward_flops(a: Arch, canvas_hw: Tuple[int, int], rois: int, pool: int) -> Dict[str, int]:
    """Forward operations of one image at ``canvas_hw`` with ``rois`` RoIs
    through the box head, by part: "stem", "backbone" (res2-res4), "rpn",
    "res5" and "predictor"."""
    parts: Dict[str, int] = {}
    for layer in layers(a, canvas_hw, pool):
        per = rois if layer.part in ("res5", "predictor") else 1
        parts[layer.part] = parts.get(layer.part, 0) + per * layer_flops(layer)
    return parts


def image_flops(a: Arch, canvas_hw, rois: int, pool: int, train: bool) -> Dict[str, int]:
    """{"conv": ..., "model": ...}: an image's convolution operations and
    all its model operations (convolutions and the dense predictor), in
    training (forward and backward) or detection (forward)."""
    parts = forward_flops(a, canvas_hw, rois, pool)
    if train:
        parts = {k: v * (2 if k == "stem" else 3) for k, v in parts.items()}
    conv = sum(v for k, v in parts.items() if k != "predictor")
    return {"conv": conv, "model": conv + parts.get("predictor", 0)}


def roi_align_bytes(a: Arch, canvas_hw, images: int, rois: int, pool: int,
                    elem: int, backward: bool) -> int:
    """Least bytes of one RoIAlign over ``images`` maps and ``rois`` RoIs
    in all: the map read once and the output written once; with the
    backward, the output's gradient read once and the map's written once
    besides."""
    fh, fw = feature_hw(canvas_hw)
    c4 = a.res2_out << 2
    map_bytes = images * fh * fw * c4 * elem
    out_bytes = rois * pool * pool * c4 * elem
    once = map_bytes + out_bytes
    return 2 * once if backward else once
