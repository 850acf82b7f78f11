"""The Faster R-CNN R-C4 detector as the benchmark reads it from a
configuration file (``"arch": "rc4"``): its parameters (names, shapes,
initializers), its convolutions and dense layers (shapes for the counts),
the operations and bytes its work needs, the port's configuration, the
program that runs it and its plain reference.

What the harness takes from an architecture module:
  PROGRAM        (module, model class, config class) of the port's model,
                 built by ``sut.py``
  port_configs   the configuration as the port's config fields
  param_specs    every parameter, in the order the weights are drawn
  work           the work of one image or frame and of one step
  reference      the plain reference detector; ``train_batch`` its input

Parameter names are the port's ``state_dict`` keys, so the benchmark's
seeded weights load into the program by name; the plain reference reads
the same dict. Nothing here imports the program.

Operations and bytes are counted from the published architecture and a
cell's shapes, never from what the program launched. A multiply-add is two
operations. Training counts three times the forward of every layer whose
weights get a gradient (forward, input gradient, weight gradient), and
twice for the stem, whose input (the images) takes no gradient.
Elementwise work (the frozen affines, ReLUs, pooling) is not counted.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

from benchmark.reference.rcnn import train_batch  # noqa: F401  (the interface's input)

PROGRAM = ("tspn_tpu_torch.detection.rcnn", "FasterRCNN", "DetectionConfig")

# bottleneck blocks per stage (res2, res3, res4, res5); 26 is a one-block
# network for the CPU tests
STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
STRIDE = 16


class Arch(NamedTuple):
    depth: int
    num_classes: int
    num_anchors: int
    stem: int          # stem output channels
    res2_out: int      # res2 output channels (each later stage doubles)
    width: int         # res2 bottleneck width (each later stage doubles)


class Param(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: Tuple        # ("lecun",), ("normal", std), ("ones",), ("zeros",)


class Layer(NamedTuple):
    """A conv (k x k; dense layers have k = 1 and out_hw (1, 1)) at one
    output size; ``part`` is "stem", "backbone", "rpn", "res5" (per RoI)
    or "predictor" (per RoI)."""
    name: str
    cin: int
    cout: int
    k: int
    out_hw: Tuple[int, int]
    part: str


def arch_of(config: dict) -> Arch:
    sizes = config["MODEL.ANCHOR_GENERATOR.SIZES"][0]
    ratios = config["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0]
    if config["MODEL.RESNETS.NUM_GROUPS"] != 1 or config["MODEL.RESNETS.STRIDE_IN_1X1"]:
        raise ValueError("the port's ResNet has one group and strides the 3x3 conv")
    return Arch(config["MODEL.RESNETS.DEPTH"], config["MODEL.ROI_HEADS.NUM_CLASSES"],
                len(sizes) * len(ratios), config["MODEL.RESNETS.STEM_OUT_CHANNELS"],
                config["MODEL.RESNETS.RES2_OUT_CHANNELS"],
                config["MODEL.RESNETS.WIDTH_PER_GROUP"])


def stages(a: Arch) -> List[Tuple[str, int, int, int, int, int]]:
    """(prefix, blocks, cin, cout, width, first stride) of res2..res5."""
    out = []
    cin = a.stem
    for i, blocks in enumerate(STAGE_BLOCKS[a.depth]):
        cout, width = a.res2_out << i, a.width << i
        prefix = f"backbone.res{i + 2}" if i < 3 else "res5.res5"
        out.append((prefix, blocks, cin, cout, width, 1 if i == 0 else 2))
        cin = cout
    return out


def block_convs(prefix: str, blocks: int, cin: int, cout: int, width: int, stride: int
                ) -> Iterator[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, k, stride) of a stage's convs, in the order the
    block runs them."""
    for b in range(blocks):
        p = f"{prefix}.block{b}"
        c_in = cin if b == 0 else cout
        s = stride if b == 0 else 1
        if c_in != cout or s != 1:
            yield f"{p}.shortcut", c_in, cout, 1, s
        yield f"{p}.conv1", c_in, width, 1, 1
        yield f"{p}.conv2", width, width, 3, s
        yield f"{p}.conv3", width, cout, 1, 1


def _norm_of(conv: str) -> str:
    if conv.endswith(".shortcut"):
        return conv + "_norm"
    if conv.endswith(".stem_conv"):
        return conv[: -len("conv")] + "norm"
    return conv[: -len("convN")] + "norm" + conv[-1]


def params(a: Arch) -> List[Param]:
    """Every parameter of the detector, in the order the weights are drawn."""
    out = []

    def conv(name, cin, cout, k, init=("lecun",), bias=False):
        out.append(Param(f"{name}.weight", (cout, cin, k, k), init))
        if bias:
            out.append(Param(f"{name}.bias", (cout,), ("zeros",)))
        else:
            norm = _norm_of(name)
            out.append(Param(f"{norm}.scale", (cout,), ("ones",)))
            out.append(Param(f"{norm}.bias", (cout,), ("zeros",)))

    conv("backbone.stem_conv", 3, a.stem, 7)
    for prefix, blocks, cin, cout, width, stride in stages(a):
        for name, ci, co, k, _s in block_convs(prefix, blocks, cin, cout, width, stride):
            conv(name, ci, co, k)
    c4 = a.res2_out << 2
    conv("rpn_head.conv", c4, c4, 3, ("normal", 0.01), bias=True)
    conv("rpn_head.objectness", c4, a.num_anchors, 1, ("normal", 0.01), bias=True)
    conv("rpn_head.deltas", c4, 4 * a.num_anchors, 1, ("normal", 0.01), bias=True)
    c5 = a.res2_out << 3
    out.append(Param("cls_score.weight", (a.num_classes + 1, c5), ("normal", 0.01)))
    out.append(Param("cls_score.bias", (a.num_classes + 1,), ("zeros",)))
    out.append(Param("bbox_pred.weight", (4 * a.num_classes, c5), ("normal", 0.001)))
    out.append(Param("bbox_pred.bias", (4 * a.num_classes,), ("zeros",)))
    return out


def _out(size: int, k: int, stride: int) -> int:
    """Output size of a conv or pool with padding k // 2."""
    return (size + 2 * (k // 2) - k) // stride + 1


def layers(a: Arch, canvas_hw: Tuple[int, int], pool: int) -> List[Layer]:
    """The convolutions and dense layers of one image at ``canvas_hw``
    (stem to res4 and the RPN) and of one RoI pooled to ``pool`` x
    ``pool`` (res5 and the box predictor)."""
    h, w = _out(canvas_hw[0], 7, 2), _out(canvas_hw[1], 7, 2)
    out = [Layer("backbone.stem_conv", 3, a.stem, 7, (h, w), "stem")]
    h, w = _out(h, 3, 2), _out(w, 3, 2)  # max-pool 3x3 / 2
    for prefix, blocks, cin, cout, width, stride in stages(a):
        part = "res5" if prefix.startswith("res5") else "backbone"
        if part == "res5":
            h = w = pool
        for name, ci, co, k, s in block_convs(prefix, blocks, cin, cout, width, stride):
            if name.endswith(("shortcut", "conv1")):  # each block's input size
                bh, bw = h, w
            if k == 1 and s > 1:  # the strided 1x1 shortcut, unpadded
                oh, ow = (bh - 1) // s + 1, (bw - 1) // s + 1
            else:
                oh, ow = _out(bh, k, s), _out(bw, k, s)
            out.append(Layer(name, ci, co, k, (oh, ow), part))
            if name.endswith("conv2"):
                bh, bw = oh, ow
            if name.endswith("conv3"):
                h, w = oh, ow
        if part == "backbone" and prefix.endswith("res4"):
            c4, rpn_hw = cout, (h, w)
    out.append(Layer("rpn_head.conv", c4, c4, 3, rpn_hw, "rpn"))
    out.append(Layer("rpn_head.objectness", c4, a.num_anchors, 1, rpn_hw, "rpn"))
    out.append(Layer("rpn_head.deltas", c4, 4 * a.num_anchors, 1, rpn_hw, "rpn"))
    c5 = a.res2_out << 3
    out.append(Layer("cls_score", c5, a.num_classes + 1, 1, (1, 1), "predictor"))
    out.append(Layer("bbox_pred", c5, 4 * a.num_classes, 1, (1, 1), "predictor"))
    return out


def feature_hw(canvas_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The stride-16 map of a canvas whose sides are multiples of 16."""
    return canvas_hw[0] // STRIDE, canvas_hw[1] // STRIDE


def port_configs(config: dict) -> Dict[str, dict]:
    """The configuration file as the port's DetectionConfig and
    DetectorTrainConfig fields; refuses a file that sets what the port
    fixes in code."""
    fixed = {"MODEL.RPN.IOU_THRESHOLDS": [0.3, 0.7],
             "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO": 2,
             "MODEL.ROI_BOX_HEAD.POOLER_TYPE": "ROIAlignV2",
             "MODEL.RPN.SMOOTH_L1_BETA": 0.0, "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA": 0.0,
             "MODEL.PIXEL_MEAN": [0.0, 0.0, 0.0], "MODEL.PIXEL_STD": [255.0, 255.0, 255.0],
             "MODEL.ANCHOR_GENERATOR.OFFSET": 0.5,
             "MODEL.RPN.BBOX_REG_WEIGHTS": [1.0, 1.0, 1.0, 1.0],
             "MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS": [1.0, 1.0, 1.0, 1.0],
             "MODEL.ROI_HEADS.PROPOSAL_APPEND_GT": True, "SOLVER.WARMUP_METHOD": "linear",
             "MODEL.RESNETS.STEM_OUT_CHANNELS": 64, "MODEL.RESNETS.RES2_OUT_CHANNELS": 256,
             "MODEL.RESNETS.WIDTH_PER_GROUP": 64, "MODEL.BACKBONE.FREEZE_AT": 0}
    for key, want in fixed.items():
        if config[key] != want:
            raise ValueError(f"{key} = {config[key]}: the port fixes it at {want}")
    if abs(config["SOLVER.WARMUP_FACTOR"] - 1 / 3) > 1e-12:
        raise ValueError("the port's warm-up starts at base/3")
    if min(config["SOLVER.STEPS"], default=math.inf) <= config["SOLVER.MAX_ITER"]:
        raise ValueError("the port's rate stays constant after the warm-up: no step before MAX_ITER")
    a = arch_of(config)
    detection = dict(
        num_classes=a.num_classes, depth=a.depth, stride=STRIDE,
        anchor_sizes=tuple(config["MODEL.ANCHOR_GENERATOR.SIZES"][0]),
        anchor_ratios=tuple(config["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0]),
        pre_nms_topk_train=config["MODEL.RPN.PRE_NMS_TOPK_TRAIN"],
        post_nms_topk_train=config["MODEL.RPN.POST_NMS_TOPK_TRAIN"],
        pre_nms_topk_test=config["MODEL.RPN.PRE_NMS_TOPK_TEST"],
        post_nms_topk_test=config["MODEL.RPN.POST_NMS_TOPK_TEST"],
        rpn_nms_threshold=config["MODEL.RPN.NMS_THRESH"],
        rpn_batch_size=config["MODEL.RPN.BATCH_SIZE_PER_IMAGE"],
        rpn_positive_fraction=config["MODEL.RPN.POSITIVE_FRACTION"],
        roi_batch_size=config["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"],
        roi_positive_fraction=config["MODEL.ROI_HEADS.POSITIVE_FRACTION"],
        roi_fg_threshold=config["MODEL.ROI_HEADS.IOU_THRESHOLDS"][0],
        roi_pool_size=config["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"],
        score_threshold=config["MODEL.ROI_HEADS.SCORE_THRESH_TEST"],
        test_nms_threshold=config["MODEL.ROI_HEADS.NMS_THRESH_TEST"],
        max_detections=config["TEST.DETECTIONS_PER_IMAGE"])
    train = dict(
        ims_per_batch=config["SOLVER.IMS_PER_BATCH"], base_lr=config["SOLVER.BASE_LR"],
        max_iter=config["SOLVER.MAX_ITER"], momentum=config["SOLVER.MOMENTUM"],
        weight_decay=config["SOLVER.WEIGHT_DECAY"],
        warmup_iters=config["SOLVER.WARMUP_ITERS"], input_policy="shortest_edge",
        min_size=config["INPUT.MIN_SIZE_TRAIN"][-1],
        max_size=config["INPUT.MAX_SIZE_TRAIN"], pad_multiple=32, max_gt_boxes=32,
        mixed_precision=config["compute_dtype"] == "bfloat16")
    return {"detection": detection, "train": train}


def param_specs(config: dict) -> List[Param]:
    return params(arch_of(config))


# ------------------------------------------------------------------ work
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


def work(config: dict, shapes: dict, train: bool) -> Dict[str, Dict[str, int]]:
    """The work at a cell's ``shapes`` (``canvas_hw``, ``images_per_step``,
    ``rois_per_image``): {"unit": of one image or frame, "step": of one
    step or batch}. ``conv_flops``: the convolutions; ``model_flops``: they
    and the dense predictor; ``k7_bytes``: RoIAlign's least bytes."""
    a = arch_of(config)
    pool = port_configs(config)["detection"]["roi_pool_size"]
    canvas, per, rois = shapes["canvas_hw"], shapes["images_per_step"], shapes["rois_per_image"]
    flops = image_flops(a, canvas, rois, pool, train)
    elem = 2 if config["compute_dtype"] == "bfloat16" else 4
    return {"unit": {"conv_flops": flops["conv"], "model_flops": flops["model"]},
            "step": {"k7_bytes": roi_align_bytes(a, canvas, per, per * rois, pool, elem,
                                                 backward=train)}}


def reference(config: dict, weights, precision: str, train: bool = False,
              channels_last: bool = True):
    """The plain reference detector over ``weights`` at ``precision``."""
    from benchmark.reference.rc4 import Detector

    return Detector(arch_of(config), port_configs(config)["detection"], weights, precision,
                    train=train, channels_last=channels_last)
