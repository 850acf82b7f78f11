"""A toy second architecture, for the test that the harness takes a new one
as files alone (``test_bench_open.py``): R-C4's stem to res4 and its RPN,
then a two-layer FC box head (detectron2's ``FastRCNNConvFCHead``) on
RoIAlign crops of the res4 map in place of res5. The port has no model of
it: its runs put its reference in the program's place.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.archs import rc4
from benchmark.archs.rc4 import Layer, Param, port_configs, train_batch  # noqa: F401

PROGRAM = None
FC_INIT = {"cls_score": ("normal", 0.01), "bbox_pred": ("normal", 0.001)}


def head_layers(config: dict) -> List[Layer]:
    """The box head's dense layers, for one RoI."""
    a = rc4.arch_of(config)
    pool = config["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = config["MODEL.ROI_BOX_HEAD.FC_DIM"]
    dims = [pool * pool * (a.res2_out << 2)] + [fc] * config["MODEL.ROI_BOX_HEAD.NUM_FC"]
    out = [Layer(f"box_head.fc{i + 1}", cin, cout, 1, (1, 1), "head")
           for i, (cin, cout) in enumerate(zip(dims, dims[1:]))]
    return out + [Layer("cls_score", fc, a.num_classes + 1, 1, (1, 1), "head"),
                  Layer("bbox_pred", fc, 4 * a.num_classes, 1, (1, 1), "head")]


def param_specs(config: dict) -> List[Param]:
    trunk = [p for p in rc4.params(rc4.arch_of(config))
             if not p.name.startswith(("res5.", "cls_score.", "bbox_pred."))]
    head = []
    for layer in head_layers(config):
        head += [Param(f"{layer.name}.weight", (layer.cout, layer.cin),
                       FC_INIT.get(layer.name, ("lecun",))),
                 Param(f"{layer.name}.bias", (layer.cout,), ("zeros",))]
    return trunk + head


def work(config: dict, shapes: dict, train: bool) -> Dict[str, Dict[str, int]]:
    """As ``rc4.work``, less res5, with the FC head's operations apart
    (``fc_flops``, in ``model_flops`` but not ``conv_flops``)."""
    a = rc4.arch_of(config)
    pool = port_configs(config)["detection"]["roi_pool_size"]
    canvas, per, rois = shapes["canvas_hw"], shapes["images_per_step"], shapes["rois_per_image"]
    trunk = [layer for layer in rc4.layers(a, canvas, pool)
             if layer.part in ("stem", "backbone", "rpn")]
    conv = sum(rc4.layer_flops(layer) * (1 if not train else 2 if layer.part == "stem" else 3)
               for layer in trunk)
    fc = rois * sum(rc4.layer_flops(layer) for layer in head_layers(config)) * (3 if train else 1)
    elem = 2 if config["compute_dtype"] == "bfloat16" else 4
    return {"unit": {"conv_flops": conv, "fc_flops": fc, "model_flops": conv + fc},
            "step": {"k7_bytes": rc4.roi_align_bytes(a, canvas, per, per * rois, pool, elem,
                                                     backward=train)}}


def reference(config: dict, weights, precision: str, train: bool = False,
              channels_last: bool = True):
    from benchmark.reference.toy import Detector

    return Detector(rc4.arch_of(config), port_configs(config)["detection"], weights, precision,
                    train=train, channels_last=channels_last)
