"""The Faster R-CNN X101-32x8d-FPN detector as the benchmark reads it from a
configuration file (``"arch": "fpn"``): its parameters (names, shapes,
initializers), its convolutions and dense layers (shapes for the counts),
the operations and bytes its work needs, the port's configuration, the
program that runs it and its plain reference. ``archs/rc4.py`` says what
the harness takes from such a module.

The network: a ResNeXt stem and res2-res5 (each 3x3 conv in NUM_GROUPS
groups; bottleneck width NUM_GROUPS * WIDTH_PER_GROUP in res2, doubling a
stage), an FPN (lateral 1x1 and output 3x3 convs with bias over res2-res5
to 256 channels, P6 a stride-2 subsample of P5), an RPN head shared by
P2-P6 (a 3x3 conv and 1x1 objectness and delta convs, one anchor size a
level, three ratios), RoIAlign 7x7 on P2-P5 by RoI size, and two FC
layers of 1024 before the class scores and deltas.

Operations are counted as ``archs/rc4.py`` counts them: a multiply-add is
two; a grouped conv does cin / groups multiply-adds an output; training
counts three times the forward of every layer whose weights get a
gradient and twice the stem's; elementwise work (affines, ReLUs, the
top-down adds and upsampling, pooling) is not counted.

K7's bytes are a least bound that holds whatever the proposals: the pooled
output written once and, in training, its gradient read once. The maps
are not counted: with 7 x 7 bins of 256 channels the output of a batch
outweighs the maps, and the part of each map that the RoIs touch depends
on the RoIs (RoIs that all sample one small region read a few rows), so
no count of map bytes is a bound for every set of RoIs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

from benchmark.archs.rc4 import STAGE_BLOCKS, Param, _norm_of, _out
from benchmark.reference.rcnn import train_batch  # noqa: F401  (the interface's input)

PROGRAM = ("tspn_tpu_torch.detection.fpn", "FPNFasterRCNN", "FPNConfig")

STRIDES = (4, 8, 16, 32, 64)  # P2..P6
FEATURES = {"MODEL.RPN.IN_FEATURES": ["p2", "p3", "p4", "p5", "p6"],
            "MODEL.ROI_HEADS.IN_FEATURES": ["p2", "p3", "p4", "p5"],
            "MODEL.FPN.IN_FEATURES": ["res2", "res3", "res4", "res5"],
            "MODEL.RESNETS.OUT_FEATURES": ["res2", "res3", "res4", "res5"]}


class Arch(NamedTuple):
    depth: int
    num_classes: int
    groups: int
    width: int         # res2 bottleneck width (each later stage doubles)
    stem: int          # stem output channels
    res2_out: int      # res2 output channels (each later stage doubles)
    fpn: int           # FPN channels
    anchors: int       # anchors a place of a level (sizes x ratios)
    pool: int          # RoIAlign output side
    fc: int            # FC width


class Layer(NamedTuple):
    """A conv (k x k, ``groups`` groups; dense layers have k = 1 and
    out_hw (1, 1)) at one output size; ``part`` is "stem", "backbone",
    "fpn", "rpn" or "box_head" (per RoI)."""
    name: str
    cin: int
    cout: int
    k: int
    out_hw: Tuple[int, int]
    part: str
    groups: int = 1


def arch_of(config: dict) -> Arch:
    want = {**FEATURES, "MODEL.RESNETS.STRIDE_IN_1X1": False, "MODEL.FPN.NORM": "",
            "MODEL.FPN.FUSE_TYPE": "sum", "MODEL.ROI_BOX_HEAD.NAME": "FastRCNNConvFCHead",
            "MODEL.ROI_BOX_HEAD.NUM_CONV": 0, "MODEL.ROI_BOX_HEAD.NUM_FC": 2}
    for key, value in want.items():
        if config[key] != value:
            raise ValueError(f"{key} = {config[key]}: the port's FPN detector has {value}")
    groups = config["MODEL.RESNETS.NUM_GROUPS"]
    sizes = anchor_sizes(config)
    if len({len(s) for s in sizes}) != 1:
        raise ValueError("every level needs as many anchor sizes: the RPN head is shared")
    return Arch(config["MODEL.RESNETS.DEPTH"], config["MODEL.ROI_HEADS.NUM_CLASSES"], groups,
                groups * config["MODEL.RESNETS.WIDTH_PER_GROUP"],
                config["MODEL.RESNETS.STEM_OUT_CHANNELS"],
                config["MODEL.RESNETS.RES2_OUT_CHANNELS"], config["MODEL.FPN.OUT_CHANNELS"],
                len(sizes[0]) * len(config["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0]),
                config["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"],
                config["MODEL.ROI_BOX_HEAD.FC_DIM"])


def anchor_sizes(config: dict) -> List[List[float]]:
    """Each level's anchor sizes: ANCHOR_GENERATOR.SIZES, one list a level,
    or one list for every level (detectron2 broadcasts it)."""
    sizes = config["MODEL.ANCHOR_GENERATOR.SIZES"]
    if len(sizes) == 1:
        return sizes * len(STRIDES)
    if len(sizes) != len(STRIDES):
        raise ValueError(f"anchor sizes for {len(sizes)} levels; the FPN has {len(STRIDES)}")
    return sizes


def stages(a: Arch) -> List[Tuple[str, int, int, int, int, int]]:
    """(prefix, blocks, cin, cout, width, first stride) of res2..res5."""
    out = []
    cin = a.stem
    for i, blocks in enumerate(STAGE_BLOCKS[a.depth]):
        cout, width = a.res2_out << i, a.width << i
        out.append((f"backbone.res{i + 2}", blocks, cin, cout, width, 1 if i == 0 else 2))
        cin = cout
    return out


def block_convs(prefix: str, blocks: int, cin: int, cout: int, width: int, stride: int,
                groups: int) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """(name, cin, cout, k, stride, groups) of a stage's convs, in the
    order the block runs them."""
    for b in range(blocks):
        p = f"{prefix}.block{b}"
        c_in = cin if b == 0 else cout
        s = stride if b == 0 else 1
        if c_in != cout or s != 1:
            yield f"{p}.shortcut", c_in, cout, 1, s, 1
        yield f"{p}.conv1", c_in, width, 1, 1, 1
        yield f"{p}.conv2", width, width, 3, s, groups
        yield f"{p}.conv3", width, cout, 1, 1, 1


def params(a: Arch) -> List[Param]:
    """Every parameter of the detector, in the order the weights are drawn
    (the port's ``state_dict`` order)."""
    out = []

    def conv(name, cin, cout, k, groups=1, init=("lecun",), bias=False):
        out.append(Param(f"{name}.weight", (cout, cin // groups, k, k), init))
        if bias:
            out.append(Param(f"{name}.bias", (cout,), ("zeros",)))
        else:
            norm = _norm_of(name)
            out.append(Param(f"{norm}.scale", (cout,), ("ones",)))
            out.append(Param(f"{norm}.bias", (cout,), ("zeros",)))

    def dense(name, cin, cout, init=("lecun",)):
        out.append(Param(f"{name}.weight", (cout, cin), init))
        out.append(Param(f"{name}.bias", (cout,), ("zeros",)))

    conv("backbone.stem_conv", 3, a.stem, 7)
    for prefix, blocks, cin, cout, width, stride in stages(a):
        for name, ci, co, k, _s, g in block_convs(prefix, blocks, cin, cout, width, stride,
                                                  a.groups):
            conv(name, ci, co, k, g)
    for lvl, (_p, _b, _ci, cout, _w, _s) in enumerate(stages(a), start=2):
        conv(f"fpn.lateral{lvl}", cout, a.fpn, 1, bias=True)
        conv(f"fpn.output{lvl}", a.fpn, a.fpn, 3, bias=True)
    rpn = ("normal", 0.01)
    conv("rpn_head.conv", a.fpn, a.fpn, 3, init=rpn, bias=True)
    conv("rpn_head.objectness", a.fpn, a.anchors, 1, init=rpn, bias=True)
    conv("rpn_head.deltas", a.fpn, 4 * a.anchors, 1, init=rpn, bias=True)
    dense("box_head.fc1", a.fpn * a.pool * a.pool, a.fc)
    dense("box_head.fc2", a.fc, a.fc)
    dense("cls_score", a.fc, a.num_classes + 1, ("normal", 0.01))
    dense("bbox_pred", a.fc, 4 * a.num_classes, ("normal", 0.001))
    return out


def layers(a: Arch, canvas_hw: Tuple[int, int]) -> List[Layer]:
    """The convolutions of one image at ``canvas_hw`` (stem to res5, the
    FPN, the RPN head on each level) and the dense layers of one RoI."""
    h, w = _out(canvas_hw[0], 7, 2), _out(canvas_hw[1], 7, 2)
    out = [Layer("backbone.stem_conv", 3, a.stem, 7, (h, w), "stem")]
    h, w = _out(h, 3, 2), _out(w, 3, 2)  # max-pool 3x3 / 2
    res = []
    for prefix, blocks, cin, cout, width, stride in stages(a):
        for name, ci, co, k, s, g in block_convs(prefix, blocks, cin, cout, width, stride,
                                                 a.groups):
            if name.endswith(("shortcut", "conv1")):  # each block's input size
                bh, bw = h, w
            if k == 1 and s > 1:  # the strided 1x1 shortcut, unpadded
                oh, ow = (bh - 1) // s + 1, (bw - 1) // s + 1
            else:
                oh, ow = _out(bh, k, s), _out(bw, k, s)
            out.append(Layer(name, ci, co, k, (oh, ow), "backbone", g))
            if name.endswith("conv2"):
                bh, bw = oh, ow
            if name.endswith("conv3"):
                h, w = oh, ow
        res.append((cout, (h, w)))
    for lvl, (cout, hw) in enumerate(res, start=2):
        out.append(Layer(f"fpn.lateral{lvl}", cout, a.fpn, 1, hw, "fpn"))
        out.append(Layer(f"fpn.output{lvl}", a.fpn, a.fpn, 3, hw, "fpn"))
    hws = [hw for _c, hw in res] + [(-(-res[-1][1][0] // 2), -(-res[-1][1][1] // 2))]
    for lvl, hw in enumerate(hws, start=2):
        out.append(Layer(f"rpn_head.conv@p{lvl}", a.fpn, a.fpn, 3, hw, "rpn"))
        out.append(Layer(f"rpn_head.objectness@p{lvl}", a.fpn, a.anchors, 1, hw, "rpn"))
        out.append(Layer(f"rpn_head.deltas@p{lvl}", a.fpn, 4 * a.anchors, 1, hw, "rpn"))
    out.append(Layer("box_head.fc1", a.fpn * a.pool * a.pool, a.fc, 1, (1, 1), "box_head"))
    out.append(Layer("box_head.fc2", a.fc, a.fc, 1, (1, 1), "box_head"))
    out.append(Layer("cls_score", a.fc, a.num_classes + 1, 1, (1, 1), "box_head"))
    out.append(Layer("bbox_pred", a.fc, 4 * a.num_classes, 1, (1, 1), "box_head"))
    return out


def port_configs(config: dict) -> Dict[str, dict]:
    """The configuration file as the port's FPNConfig and
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
             "MODEL.BACKBONE.FREEZE_AT": 0, "compute_dtype": "float32"}
    for key, want in fixed.items():
        if config[key] != want:
            raise ValueError(f"{key} = {config[key]}: the port fixes it at {want}")
    if abs(config["SOLVER.WARMUP_FACTOR"] - 1 / 3) > 1e-12:
        raise ValueError("the port's warm-up starts at base/3")
    if min(config["SOLVER.STEPS"], default=math.inf) <= config["SOLVER.MAX_ITER"]:
        raise ValueError("the port's rate stays constant after the warm-up: no step before MAX_ITER")
    a = arch_of(config)
    detection = dict(
        num_classes=a.num_classes, depth=a.depth, groups=a.groups,
        width_per_group=config["MODEL.RESNETS.WIDTH_PER_GROUP"], fpn_channels=a.fpn,
        anchor_sizes=tuple(tuple(s) for s in anchor_sizes(config)),
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
        roi_pool_size=a.pool, fc_dim=a.fc,
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
        mixed_precision=False)
    return {"detection": detection, "train": train}


def param_specs(config: dict) -> List[Param]:
    return params(arch_of(config))


# ------------------------------------------------------------------ work
def layer_flops(layer: Layer) -> int:
    h, w = layer.out_hw
    return 2 * h * w * layer.cout * (layer.cin // layer.groups) * layer.k * layer.k


def image_flops(a: Arch, canvas_hw, rois: int, train: bool) -> Dict[str, int]:
    """{"conv", "grouped_conv", "model"}: an image's convolution operations
    (its grouped 3x3 convs among them) and all its model operations (the
    convolutions and the box head over ``rois`` RoIs), in training
    (forward and backward) or detection (forward)."""
    out = {"conv": 0, "grouped_conv": 0, "model": 0}
    for layer in layers(a, canvas_hw):
        per = rois if layer.part == "box_head" else 1
        times = (2 if layer.part == "stem" else 3) if train else 1
        flops = per * times * layer_flops(layer)
        out["model"] += flops
        if layer.part != "box_head":
            out["conv"] += flops
        if layer.groups > 1:
            out["grouped_conv"] += flops
    return out


def roi_align_bytes(a: Arch, rois: int, elem: int, backward: bool) -> int:
    """Least bytes of one multi-level RoIAlign of ``rois`` RoIs in all, for
    any RoIs: the output written once; with the backward, its gradient read
    once besides (module docstring)."""
    out_bytes = rois * a.pool * a.pool * a.fpn * elem
    return 2 * out_bytes if backward else out_bytes


def work(config: dict, shapes: dict, train: bool) -> Dict[str, Dict[str, int]]:
    """The work at a cell's ``shapes`` (``canvas_hw``, ``images_per_step``,
    ``rois_per_image``): {"unit": of one image or frame, "step": of one
    step or batch}. ``conv_flops``: the convolutions; ``grouped_conv_flops``:
    the grouped ones among them; ``model_flops``: the convolutions and the
    box head; ``k7_bytes``: RoIAlign's least bytes."""
    a = arch_of(config)
    canvas, per, rois = shapes["canvas_hw"], shapes["images_per_step"], shapes["rois_per_image"]
    flops = image_flops(a, canvas, rois, train)
    return {"unit": {"conv_flops": flops["conv"], "grouped_conv_flops": flops["grouped_conv"],
                     "model_flops": flops["model"]},
            "step": {"k7_bytes": roi_align_bytes(a, per * rois, 4, backward=train)}}


def reference(config: dict, weights, precision: str, train: bool = False,
              channels_last: bool = True):
    """The plain reference detector over ``weights`` at ``precision``."""
    from benchmark.reference.fpn import Detector

    return Detector(arch_of(config), port_configs(config)["detection"], weights, precision,
                    train=train, channels_last=channels_last)
