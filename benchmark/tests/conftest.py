"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root (the card's tests, marked gpu, skip without one)."""

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


# At this size a detection's score and box move less under the TF32 control
# than at the cell's (score 4.5e-6, box 9.1e-4 px against the cell's 2.91e-5
# and 0.0068 px on the card), while sound runs read 0 here as there; so the
# detection cells take limits set the same way from this size's readings.
TINY_DETECT_LIMITS = {"score_gap": 1e-6, "box_gap_px": 1e-4}


def tiny_cell(workload: str, compute_dtype: str = "float32"):
    """A cell of BENCHMARK.json cut to a CPU test's size: a
    one-block-a-stage ResNet at the port's widths, 5 classes, small
    images and few proposals, computing in ``compute_dtype``. Its limits
    are the cell's own (detection's are this size's)."""
    from benchmark import harness

    c = harness.cell(harness.load_json(harness.REPO / "BENCHMARK.json"), workload)
    if c.traffic["kind"] == "detect":
        c.limits = dict(TINY_DETECT_LIMITS)
    cfg = dict(c.config)
    cfg.update({"MODEL.RESNETS.DEPTH": 26, "MODEL.ROI_HEADS.NUM_CLASSES": 5,
                "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 16,
                "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 32,
                "MODEL.RPN.PRE_NMS_TOPK_TEST": 200, "MODEL.RPN.POST_NMS_TOPK_TEST": 32,
                "MODEL.ANCHOR_GENERATOR.SIZES": [[16, 32]], "TEST.DETECTIONS_PER_IMAGE": 20,
                "INPUT.MIN_SIZE_TRAIN": [64], "INPUT.MAX_SIZE_TRAIN": 96,
                "SOLVER.IMS_PER_BATCH": 2, "compute_dtype": compute_dtype})
    c.config = cfg
    traffic = copy.deepcopy(c.traffic)
    if traffic["kind"] == "train":
        traffic.update(records=8, frame_hw=[48, 72], box_min_side=8)
    else:
        traffic.update(frames=8, canvas_hw=[64, 96], image_hw=[60, 90], rect_side=[8, 30],
                       batch_size=4, sample_batches=1)
    c.traffic = traffic
    return c


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's RoIAlign kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    return tiny_cell
