"""The yardstick's arithmetic against values worked out by hand: FLOP and
byte counts at small shapes, the trace's union of device time and its
idle gaps, and the metric readers."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.archs.rc4 import arch_of, forward_flops, image_flops, roi_align_bytes
from benchmark.trace import DeviceTrace

CONFIG = json.loads((harness.ROOT / "configs" / "frcnn-r101-c4.json").read_text())


def small_arch():
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update({"MODEL.RESNETS.DEPTH": 26, "MODEL.ROI_HEADS.NUM_CLASSES": 5,
                "MODEL.ANCHOR_GENERATOR.SIZES": [[16, 32]]})
    return arch_of(cfg)


# one block a stage at a 64 x 96 canvas (stem 32 x 48, pool 16 x 24, res3
# 8 x 12, res4 4 x 6), 6 anchors, 5 classes; each term 2 * positions * cout * cin * k^2
STEM = 2 * 32 * 48 * 64 * 3 * 49
RES2 = 2 * 384 * (256 * 64 + 64 * 64 + 64 * 64 * 9 + 256 * 64)
RES3 = 2 * 96 * 512 * 256 + 2 * 384 * 128 * 256 + 2 * 96 * 128 * 128 * 9 + 2 * 96 * 512 * 128
RES4 = 2 * 24 * 1024 * 512 + 2 * 96 * 256 * 512 + 2 * 24 * 256 * 256 * 9 + 2 * 24 * 1024 * 256
RPN = 2 * 24 * 1024 * 1024 * 9 + 2 * 24 * 6 * 1024 + 2 * 24 * 24 * 1024
RES5 = (2 * 49 * 2048 * 1024 + 2 * 196 * 512 * 1024 + 2 * 49 * 512 * 512 * 9
        + 2 * 49 * 2048 * 512)
PRED = 2 * 6 * 2048 + 2 * 20 * 2048


def test_forward_flops_by_hand():
    assert (STEM, RES2 + RES3 + RES4, RPN, RES5, PRED) == (
        28901376, 239075328, 454459392, 745013248, 106496)
    got = forward_flops(small_arch(), (64, 96), rois=2, pool=14)
    assert got == {"stem": STEM, "backbone": RES2 + RES3 + RES4, "rpn": RPN,
                   "res5": 2 * RES5, "predictor": 2 * PRED}


def test_training_counts_three_passes_and_two_for_the_stem():
    a = small_arch()
    conv = 2 * STEM + 3 * (RES2 + RES3 + RES4 + RPN + 2 * RES5)
    assert image_flops(a, (64, 96), 2, 14, train=True) == {"conv": conv,
                                                           "model": conv + 3 * 2 * PRED}
    fwd = STEM + RES2 + RES3 + RES4 + RPN + 2 * RES5
    assert image_flops(a, (64, 96), 2, 14, train=False) == {"conv": fwd,
                                                            "model": fwd + 2 * PRED}


def test_full_size_counts():
    a = arch_of(CONFIG)
    # R101 stem to res4 at 224 x 224: 7.0 GMAC, the published ~7.8 GMAC less res5
    assert forward_flops(a, (224, 224), 0, 14)["backbone"] + forward_flops(
        a, (224, 224), 0, 14)["stem"] == pytest.approx(13.98e9, rel=1e-3)
    assert image_flops(a, (800, 1344), 128, 14, True)["model"] * 4 == pytest.approx(
        7.02e12, rel=1e-3)


def test_roi_align_bytes_by_hand():
    a = small_arch()
    once = 2 * 4 * 6 * 1024 * 4 + 4 * 14 * 14 * 1024 * 4
    assert roi_align_bytes(a, (64, 96), 2, 4, 14, 4, backward=False) == once == 3407872
    assert roi_align_bytes(a, (64, 96), 2, 4, 14, 2, backward=True) == once


def synthetic_trace():
    dev = [("sm90_xmma_fprop", 1.0, 2.0, "aten::cudnn_convolution"),
           ("sm90_xmma_dgrad", 1.5, 3.0, "aten::convolution_backward"),
           ("Memcpy HtoD (Pageable -> Device)", 5.0, 6.0, ""),
           ("void roi_align_kernel<float>", 8.0, 8.5, "tspn_roi_align_launch")]
    host = [("bench.step", 0.0, 10.0), ("aten::item", 3.5, 4.5),
            ("cudaStreamSynchronize", 3.6, 4.4)]
    return DeviceTrace(10.0, dev, host)


def test_union_gaps_and_labels():
    t = synthetic_trace()
    assert t.busy_intervals().tolist() == [[1.0, 3.0], [5.0, 6.0], [8.0, 8.5]]
    assert t.busy_s() == 3.5
    assert t.idle_gaps() == [["bench.step>cudaStreamSynchronize", 2.0],
                             ["bench.step", 2.0], ["bench.step", 1.5], ["bench.step", 1.0]]
    assert t.device_ops(2) == [["sm90_xmma_dgrad", 1.5], ["sm90_xmma_fprop", 1.0]]


def test_metric_readers():
    t = synthetic_trace()
    ctx = SimpleNamespace(kind="train", trace=t, counts={"window_s": 10.0},
                          units=40, steps=10, conv_flops=67e12, k7_bytes=3.35e11,
                          rate_units=60, rate_window_s=10.0, model_flops=134e12,
                          peak_flops=67e12, peak_bytes=3.35e12)

    def read(name):
        return harness.metric_reader(name).read(ctx)

    assert read("conv_roofline.train") == pytest.approx(100.0 / 2.5)
    assert read("k7_roofline.train") == pytest.approx(20.0)
    assert read("h2d_ms_per_image.train") == pytest.approx(25.0)
    assert read("device_idle_share.train") == pytest.approx(65.0)
    assert read("mfu.train") == pytest.approx(20.0)
    ctx.trace = DeviceTrace(1.0, [], [])
    assert all(read(n) is None for n in ("conv_roofline.detect", "k7_roofline.detect",
                                         "h2d_ms_per_image.detect",
                                         "device_idle_share.detect"))
    # mfu is read from the untraced window: it needs no trace, only its units
    assert read("mfu.detect") == pytest.approx(20.0)
    ctx.rate_units = 0
    assert read("mfu.detect") is None
