"""A whole run of each cell at a CPU test's size (the look for a chip
skipped, the cell's own limits): sound, it comes out correct; with the
control in the program's place, or with the timed path broken underneath
by each fault the cell can have, it comes out not correct. The card's
version runs the same at the same size through the port's kernels."""

import time

import pytest
import torch

from benchmark import control, harness

CELLS = [w["name"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]
SEED = 2 ** 31 + 11


def run(c, device, make_program=None):
    return harness.run_cell(c, SEED, 0.5, False, device, time.perf_counter(), make_program)[0]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    r = run(tiny(workload), torch.device("cpu"))
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    c = tiny(workload)
    lower = control.LOWER[c.config["compute_dtype"]]
    r = run(c, torch.device("cpu"), control.control_factory(c.traffic["kind"], lower))
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS
                                            for f in control.FAULTS[w.rsplit(".", 1)[1]]])
def test_fault_is_not_correct(tiny, workload, fault):
    c = tiny(workload)
    r = run(c, torch.device("cpu"), control.fault_factory(c.traffic["kind"], fault))
    assert not r["correct"], r["compared"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card(tiny, cuda_device, workload):
    c = tiny(workload)
    assert run(c, cuda_device)["correct"]
    lower = control.LOWER[c.config["compute_dtype"]]
    assert not run(c, cuda_device, control.control_factory(c.traffic["kind"], lower))["correct"]
