"""The port's host spans (tspn_tpu_torch/runtime/spans.py) on the CPU.

* Without a profiler ``span`` hands back the one shared no-op.
* Under ``torch.profiler`` a call of ``ops.nms.nms`` is one ``tspn.nms``
  span, the 2-D form's batched call included, with one ``tspn.nms.sync``
  span for each check of its loop: each block run and the check that ends
  it.
* Every ``tspn.*`` event is at FUNCTION scope, not a user annotation, so
  the profiler does not mirror it onto the device as device activity.
* ``FasterRCNN.detect`` (a TINY detector) records its stages' spans, and
  ``detect_video_frames`` and a training step their copies, readback,
  backward pass and optimizer step (over a stand-in model); detections,
  losses and updated parameters are bit-equal with the profiler on and
  off.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tspn_tpu_torch import pipeline
from tspn_tpu_torch.detection import train as ttrain
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
from tspn_tpu_torch.ops import nms as tnms
from tspn_tpu_torch.runtime import spans

TINY = DetectionConfig(num_classes=3, depth=26, anchor_sizes=(32, 64), pre_nms_topk_test=50,
                       post_nms_topk_test=4, max_detections=8)


def _traced(fn):
    """fn() under the CPU profiler -> (its result, the tspn.* events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tspn.")]
    return out, events


def _count(events, name):
    return sum(e.name() == name for e in events)


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("tspn.nms") is spans.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("tspn.nms") is not spans.OFF


def _disjoint(n, batch=None):
    """n disjoint unit boxes with distinct scores."""
    x = torch.arange(n, dtype=torch.float32) * 2.0
    boxes = torch.stack([x, torch.zeros(n), x + 1.0, torch.ones(n)], dim=1)
    scores = torch.linspace(1.0, 0.1, n)
    if batch:
        boxes, scores = boxes.expand(batch, n, 4), scores.expand(batch, n)
    return boxes, scores


@pytest.mark.parametrize("n,batch,top_k,checks", [
    (64, None, 40, 4),  # 2-D: blocks of 16, 16, 8 fill top_k; a 4th check ends
    (64, 3, 40, 4),     # batched: one check a block for all images
    (20, None, 40, 3),  # 20 survive: blocks of 16 and 4 empty the field
])
def test_nms_is_one_span_with_a_sync_span_per_check(n, batch, top_k, checks):
    boxes, scores = _disjoint(n, batch)
    (idx, keep), events = _traced(lambda: tnms.nms(boxes, scores, 0.5, top_k))
    assert _count(events, "tspn.nms") == 1
    assert _count(events, "tspn.nms.sync") == checks
    assert {e.name() for e in events} == {"tspn.nms", "tspn.nms.sync"}
    assert not any(e.is_user_annotation() for e in events)
    ref_idx, ref_keep = tnms.nms(boxes, scores, 0.5, top_k)
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
    assert int(keep.sum()) == min(n, top_k) * (batch or 1)


@pytest.fixture(scope="module")
def detector():
    """TINY with normal weights of variance 1 / fan-in, unit FrozenAffine
    scales and zero biases (the seeded init takes seconds on the CPU), and
    a raised class-0 bias, so the score threshold keeps detections."""
    with torch.device("meta"):
        model = FasterRCNN(TINY)
    model = model.to_empty(device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, math.prod(p.shape[1:]) ** -0.5, generator=gen)
            else:
                p.fill_(1.0 if name.endswith("scale") else 0.0)
        model.cls_score.bias[0] = 2.0
    return model


def test_detect_spans_and_outputs_unchanged(detector):
    images = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 96, 3).astype(np.float32))
    plain = detector.detect(images)
    traced, events = _traced(lambda: detector.detect(images))
    assert set(plain) == set(traced) and bool(plain["mask"].any())
    for k in plain:
        assert torch.equal(traced[k], plain[k]), k
    # the four stages, and two NMS calls: the RPN's and the class-aware one
    for name, want in (("tspn.backbone", 1), ("tspn.rpn", 1), ("tspn.roi_head", 1),
                       ("tspn.postprocess", 1), ("tspn.nms", 2)):
        assert _count(events, name) == want, name
    assert _count(events, "tspn.nms.sync") >= 4
    assert not any(e.is_user_annotation() for e in events)


class _Stub(torch.nn.Module):
    """A model with the detector's training and detection signatures."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(0.5, 1.5, 3))

    def forward(self, images, gt_boxes, gt_classes, gt_mask):
        s = (images.mean(dim=(1, 2)) * self.w).sum() + gt_boxes.sum() * gt_mask.sum()
        return {k: s * (i + 1) for i, k in enumerate(ttrain.LOSS_KEYS)}

    @torch.no_grad()
    def detect(self, images):
        return {"scores": images.mean(dim=(1, 2)) * self.w, "mask": images[:, 0, :3, 0] > 0.5}


def test_copy_readback_backward_and_optimizer_spans():
    """The pipeline's copy and readback, the training step's copy,
    backward and optimizer step, over a stand-in model."""
    rng = np.random.RandomState(1)
    frames = rng.rand(3, 8, 8, 3).astype(np.float32)
    batch = {"image": rng.rand(2, 8, 8, 3).astype(np.float32),
             "gt_boxes": rng.rand(2, 2, 4).astype(np.float32),
             "gt_classes": np.zeros((2, 2), np.int64), "gt_mask": np.ones((2, 2), np.float32)}
    cfg = DetectorTrainConfig(base_lr=0.1, warmup_iters=2)

    def run():
        model = _Stub()
        optimizer, scheduler = ttrain.build_detector_optimizer(model.parameters(), cfg)
        dets = pipeline.detect_video_frames(model, frames, device="cpu", batch_size=2)
        losses = ttrain.detector_train_step(model, optimizer, scheduler,
                                            ttrain.batch_to_device(batch, "cpu"))
        return dets, losses, model.w.detach().clone()

    plain = run()
    traced, events = _traced(run)
    for k in plain[0]:
        np.testing.assert_array_equal(traced[0][k], plain[0][k])
    for k in plain[1]:
        assert torch.equal(traced[1][k], plain[1][k]), k
    assert torch.equal(traced[2], plain[2]) and not torch.equal(plain[2], _Stub().w)
    for name, want in (("tspn.h2d", 3), ("tspn.d2h", 2), ("tspn.backward", 1),
                       ("tspn.optimizer", 1)):
        assert _count(events, name) == want, name
    assert not any(e.is_user_annotation() for e in events)
