"""The X101-32x8d-FPN architecture module (``archs/fpn.py``) and its reader:
the counts at both cells' shapes pinned, the backbone's against the
published figure, a grouped conv's by hand, K7's bytes against the bound
that holds for any RoIs, its parameters against the port's ``state_dict``,
and ``levels_idle_share`` on a trace built by hand."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.archs import fpn
from benchmark.trace import DeviceTrace

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CONFIG = json.loads((harness.ROOT / "configs" / "frcnn-x101-fpn.json").read_text())

# at the cells' shapes: training 800 x 1344, 4 images of 128 RoIs a step
# (2.800 TFLOP an image); detection 768 x 1344, 8 frames of 1000 RoIs a
# batch (0.922 TFLOP a frame); K7's bytes in float32
WORK = {
    "frcnn-x101-fpn.train": {"unit": {"conv_flops": 2789327826432,
                                      "grouped_conv_flops": 245248819200,
                                      "model_flops": 2800136547840},
                             "step": {"k7_bytes": 51380224}},
    "frcnn-x101-fpn.detect": {"unit": {"conv_flops": 894191413248,
                                       "grouped_conv_flops": 78479622144,
                                       "model_flops": 922339125248},
                              "step": {"k7_bytes": 401408000}},
}


def _cell(workload):
    c = harness.cell(BENCH, workload)
    return c, harness.driver(c).shapes(c.config, c.traffic), c.traffic["kind"] == "train"


@pytest.mark.parametrize("workload", sorted(WORK))
def test_full_size_work_pinned(workload):
    c, shapes, train = _cell(workload)
    assert fpn.work(c.config, shapes, train) == WORK[workload]


@pytest.mark.parametrize("workload", sorted(WORK))
def test_k7_bytes_is_at_most_the_output_and_its_gradient(workload):
    """The least a sound K7 moves for any RoIs: each pooled output written
    once and, in training, its gradient read once (7 x 7 x 256 f32)."""
    c, shapes, train = _cell(workload)
    rois = shapes["images_per_step"] * shapes["rois_per_image"]
    bound = rois * 7 * 7 * 256 * 4 * (2 if train else 1)
    assert fpn.work(c.config, shapes, train)["step"]["k7_bytes"] <= bound


def test_backbone_matches_the_published_count():
    """torchvision's ResNeXt-101 32x8d: 16.41 GMAC at 224 x 224 (its fc,
    2 MMAC, is not in a detector)."""
    layers = fpn.layers(fpn.arch_of(CONFIG), (224, 224))
    macs = sum(fpn.layer_flops(x) for x in layers if x.part in ("stem", "backbone")) / 2
    assert macs == pytest.approx(16.41e9, rel=1e-3)


def test_a_grouped_conv_by_hand():
    """res2's grouped 3x3 at 800 x 1344: 200 x 336 outputs of 256 channels,
    each 8 inputs (a group's) x 9 taps."""
    layers = {x.name: x for x in fpn.layers(fpn.arch_of(CONFIG), (800, 1344))}
    conv2 = layers["backbone.res2.block0.conv2"]
    assert (conv2.groups, conv2.out_hw) == (32, (200, 336))
    assert fpn.layer_flops(conv2) == 2 * 200 * 336 * 256 * 8 * 9
    assert layers["rpn_head.conv@p6"].out_hw == (13, 21)  # P6: 25 x 42 subsampled
    assert sum(x.groups > 1 for x in layers.values()) == 33


def test_params_are_the_ports_state_dict():
    torch = pytest.importorskip("torch")
    from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN

    cfg = dict(CONFIG, **{"MODEL.RESNETS.DEPTH": 26})
    det = fpn.port_configs(cfg)["detection"]
    with torch.device("meta"):
        model = FPNFasterRCNN(FPNConfig(**det))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert [(p.name, p.shape) for p in fpn.param_specs(cfg)] == list(shapes.items())


def test_the_new_metric_lists_only_the_new_cells():
    mine = {m["name"]: m for m in BENCH["per_layer"] if m["name"].startswith("levels_idle")}
    assert {k: v["workloads"] for k, v in mine.items()} == {
        "levels_idle_share.train": ["frcnn-x101-fpn.train"],
        "levels_idle_share.detect": ["frcnn-x101-fpn.detect"]}


# a 10 s window; the device busy over [0, 3), [5, 6) and [8, 9.5)
DEV = [("k1", 0.0, 2.0, "aten::mm"), ("k2", 1.5, 3.0, "aten::mm"),
       ("k3", 5.0, 6.0, "aten::add"), ("k4", 8.0, 9.5, "aten::add")]
HOST = [
    ("bench.step", 0.0, 10.0),
    ("tspn.fpn", -1.0, -0.5),              # before the window: not counted
    ("tspn.fpn", 2.0, 3.5),                # idle inside: [3, 3.5)
    ("tspn.rpn", 3.5, 6.5),
    ("tspn.rpn.levels", 4.0, 5.5),         # idle inside: [4, 5)
    ("tspn.nms", 4.5, 5.0),                # not a level's span
    ("tspn.roi_head", 6.5, 9.0),
    ("tspn.roi_levels", 6.8, 8.2),         # idle inside: [6.8, 8)
    ("tspn.roi_levels", 7.0, 7.5),         # nested: the union counts it once
]


def _read(form, trace):
    return harness.metric_reader(f"levels_idle_share.{form}").read(
        SimpleNamespace(trace=trace, units=1))


@pytest.mark.parametrize("form", ["train", "detect"])
def test_levels_idle_share_on_a_trace_by_hand(form):
    trace = DeviceTrace(10.0, DEV, HOST)
    assert _read(form, trace) == pytest.approx((0.5 + 1.0 + 1.2) / 10.0 * 100.0, rel=1e-12)
    device_idle = harness.metric_reader(f"device_idle_share.{form}").read(
        SimpleNamespace(trace=trace))
    assert _read(form, trace) <= device_idle
    assert _read(form, DeviceTrace(10.0, DEV, [h for h in HOST if "levels" not in h[0]
                                               and h[0] != "tspn.fpn"])) is None
    assert _read(form, None) is None
