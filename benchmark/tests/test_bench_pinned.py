"""What the harness read before the R-C4 architecture moved behind its module
(``archs/rc4.py``), pinned by literals taken from the harness before the
move: the tiny C4 configuration's seeded weights (each tensor's name,
shape and sum, digested), the work of both cells at their shapes, and the
counts that ``metric_context`` gives the readers for a window."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import archs, harness
from benchmark.weights import make_weights

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")

# 61 tensors of the tiny configuration (conftest.tiny_cell), seed 2**31 + 5
WEIGHTS_DIGEST = "504067bc26d7795b1b8e5e49187ad5e5be7911fbfa9fc30e258e851b915d44d7"

# at the cells' shapes: training 800 x 1344, 4 images of 128 RoIs a step
# (7.02 TFLOP a step); detection 768 x 1344, 8 frames of 1000 RoIs a batch
# (1.984 TFLOP a frame); K7's bytes in float32
WORK = {
    "frcnn-r101-c4.train": {"unit": {"conv_flops": 1754919419904,
                                     "model_flops": 1755196243968},
                            "step": {"k7_bytes": 959709184}},
    "frcnn-r101-c4.detect": {"unit": {"conv_flops": 1982791286784,
                                      "model_flops": 1983512182784},
                             "step": {"k7_bytes": 6554648576}},
}


def shapes_of(c):
    return harness.driver(c).shapes(c.config, c.traffic)


def test_tiny_weights_as_before(tiny):
    c = tiny("frcnn-r101-c4.train")
    w = make_weights(c.config, 2 ** 31 + 5, torch.device("cpu"))
    lines = [f"{k} {tuple(v.shape)} {float(np.sum(v.numpy().astype(np.float64)))!r}"
             for k, v in w.items()]
    assert len(lines) == 61
    assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == WEIGHTS_DIGEST


@pytest.mark.parametrize("workload", sorted(WORK))
def test_full_size_work_as_before(workload):
    c = harness.cell(BENCH, workload)
    train = c.traffic["kind"] == "train"
    assert archs.of(c.config).work(c.config, shapes_of(c), train) == WORK[workload]


@pytest.mark.parametrize("workload", sorted(WORK))
def test_metric_context_counts_as_before(workload):
    """The traced window's counts for the rooflines, the untraced window's
    for ``mfu``."""
    c = harness.cell(BENCH, workload)
    unit, step = ("images", "steps") if c.traffic["kind"] == "train" else ("frames", "batches")
    out = {"shapes": shapes_of(c),
           "counts": {unit: 344, step: 86, "window_s": 51.0},
           "traced_counts": {unit: 124, step: 31, "window_s": 20.0}}
    ctx = harness.metric_context(c, out, None)
    per = WORK[workload]
    assert (ctx.conv_flops, ctx.k7_bytes, ctx.model_flops) == (
        per["unit"]["conv_flops"] * 124, per["step"]["k7_bytes"] * 31,
        per["unit"]["model_flops"] * 344)
    assert ctx.work == {"conv_flops": per["unit"]["conv_flops"] * 124,
                        "model_flops": per["unit"]["model_flops"] * 124,
                        "k7_bytes": per["step"]["k7_bytes"] * 31}
    assert ctx.config is c.config and (ctx.units, ctx.steps, ctx.rate_units) == (124, 31, 344)
