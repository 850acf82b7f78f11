"""The readers of the program's spans (``benchmark/spans.py`` and the
``nms_*`` metrics) on a trace built by hand, whose busy intervals and
spans give every number in closed form, and on a CPU profile of the port's
NMS through the harness's own tracer."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.trace import DeviceTrace, Tracer

NAMES = ["nms_syncs_per_image", "nms_ms_per_image", "nms_idle_share"]
FORMS = [f"{n}.{cell}" for n in NAMES for cell in ("train", "detect")]

# a 10 s window; the device busy over [0, 3) (two overlapping kernels),
# [5, 6) and [8, 9.5): idle 2 + 2 + 0.5 = 4.5 s
DEV = [("k1", 0.0, 2.0, "aten::mm"), ("k2", 1.5, 3.0, "aten::mm"),
       ("Memcpy HtoD", 5.0, 6.0, "aten::copy_"), ("k3", 8.0, 9.5, "aten::add")]
HOST = [
    ("bench.step", 0.0, 10.0),
    ("tspn.nms.sync", -0.5, -0.4),           # before the window: not counted
    ("tspn.nms", 2.5, 5.5),                  # idle inside: [3, 5)
    ("tspn.nms.sync", 2.6, 2.7),
    ("tspn.nms.sync", 3.0, 4.0),
    ("aten::stack", 3.1, 3.2),
    ("tspn.nms.sync", 5.2, 5.4),
    ("tspn.rpn", 6.5, 9.0),
    ("tspn.nms", 7.0, 8.5),                  # idle inside: [7, 8)
    ("tspn.nms", 7.2, 7.8),                  # nested: the union counts it once
    ("tspn.nms.sync", 7.5, 7.6),
    ("tspn.nms.sync", 9.9, 10.2),            # starts inside, cut at the end
]
UNITS = 3


def context(trace, units=UNITS):
    return SimpleNamespace(trace=trace, units=units)


def read(name, trace, units=UNITS):
    return harness.metric_reader(name).read(context(trace, units))


@pytest.fixture
def trace():
    return DeviceTrace(10.0, DEV, HOST)


@pytest.mark.parametrize("name", FORMS)
def test_readers_exact(trace, name):
    want = {"nms_syncs_per_image": 5 / UNITS,         # 2.6, 3.0, 5.2, 7.5, 9.9
            "nms_ms_per_image": (3.0 + 1.5) / UNITS * 1e3,
            "nms_idle_share": (2.0 + 1.0) / 10.0 * 100.0}[name.split(".")[0]]
    assert read(name, trace) == pytest.approx(want, rel=1e-12)


def test_idle_share_within_the_device_idle_share(trace):
    device_idle = harness.metric_reader("device_idle_share.train").read(context(trace))
    assert device_idle == pytest.approx(45.0, rel=1e-12)
    assert read("nms_idle_share.train", trace) <= device_idle
    # NMS over the whole window, the device idle throughout: both 100%
    whole = DeviceTrace(10.0, [], [("tspn.nms", 0.0, 10.0)])
    assert read("nms_idle_share.detect", whole) == pytest.approx(100.0)


@pytest.mark.parametrize("name", FORMS)
def test_readers_none_without_nms_spans(name):
    others = [h for h in HOST if h[0] != "tspn.nms"]
    assert read(name, DeviceTrace(10.0, DEV, others)) is None
    assert read(name, None) is None


def test_zero_syncs_is_a_reading():
    only = DeviceTrace(10.0, DEV, [("tspn.nms", 1.0, 2.0)])
    assert read("nms_syncs_per_image.train", only) == 0.0
    assert read("nms_idle_share.train", only) == 0.0  # the device busy throughout


def test_summary(trace):
    s = spans.summary(trace)
    assert set(s) == {"tspn.nms", "tspn.nms.sync", "tspn.rpn"}
    want = {
        # self: 3 less its syncs' 1.3; 1.5 less the nested 0.6; 0.6 less 0.1
        "tspn.nms": {"count": 3, "host_s": 5.1, "self_s": 1.7 + 0.9 + 0.5,
                     "idle_s": 2.0 + 1.0 + 0.6},
        "tspn.nms.sync": {"count": 5, "host_s": 1.5, "self_s": 1.5, "idle_s": 1.2},
        "tspn.rpn": {"count": 1, "host_s": 2.5, "self_s": 1.0, "idle_s": 1.5},
    }
    for name, row in want.items():
        assert s[name]["count"] == row["count"]
        for key in ("host_s", "self_s", "idle_s"):
            assert s[name][key] == pytest.approx(row[key], rel=1e-12, abs=1e-12), (name, key)


def test_busy_before_and_union():
    busy = spans.union(torch.tensor([[8.0, 9.5], [0.0, 2.0], [1.5, 3.0], [5.0, 6.0]]).numpy())
    assert busy.tolist() == [[0.0, 3.0], [5.0, 6.0], [8.0, 9.5]]
    got = spans.busy_before(busy, [0.0, 1.0, 3.0, 4.0, 5.5, 9.0, 10.0])
    assert got.tolist() == pytest.approx([0.0, 1.0, 3.0, 3.0, 3.5, 5.0, 5.5])


def test_cpu_profile_of_the_port_nms():
    """The port's spans land in the harness's own trace: one NMS call of
    known geometry (disjoint boxes, top_k 40, blocks of 16) reads 4 syncs."""
    from tspn_tpu_torch.ops.nms import nms

    x = torch.arange(64, dtype=torch.float32) * 2.0
    boxes = torch.stack([x, torch.zeros(64), x + 1.0, torch.ones(64)], dim=1)
    tracer = Tracer(True)
    with tracer.window():
        nms(boxes, torch.linspace(1.0, 0.1, 64), 0.5, 40)
    trace = DeviceTrace.from_profiler(tracer.prof)
    assert read("nms_syncs_per_image.train", trace, units=2) == 2.0
    assert read("nms_ms_per_image.detect", trace, units=1) > 0.0
    summary = spans.summary(trace)
    assert summary["tspn.nms"]["count"] == 1 and summary["tspn.nms.sync"]["count"] == 4
    assert summary["tspn.nms"]["self_s"] < summary["tspn.nms"]["host_s"]
