"""ops/nms.py on the CPU: the plain path that the card's kernel is held to.

* A CPU call runs the blocked loop: it leaves ``LAUNCHES`` as it was and
  never builds or loads the CUDA library.
* The IoU threshold is compared in f32, as PyTorch rounds a Python float
  against an f32 tensor: a box whose IoU with a kept one is exactly
  f32(thr) is kept, one ulp above it is suppressed, one ulp below kept
  (``tools/nms_cases.py``; the card's test uses the same pairs).
* A +inf, -inf or NaN score is never kept and takes no slot in the
  blocked loop, which equals ``nms_sequential`` with those candidates
  marked invalid (the relation the card's test leans on).
* Tensors on another device raise.
"""

import pytest
import torch

from tspn_tpu_torch.ops import _cuda
from tspn_tpu_torch.ops import nms as tnms
from tspn_tpu_torch.tools import nms_cases


def test_cpu_calls_never_launch_or_load_the_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU call loaded the CUDA library {name}")

    monkeypatch.setattr(_cuda, "library", refuse)
    before = dict(tnms.LAUNCHES)
    boxes, scores, valid = nms_cases.rpn_like(0, 2, 200)
    idx, keep = tnms.nms(boxes, scores, 0.7, 50, valid=valid)
    idx1, keep1 = tnms.nms(boxes[1], scores[1], 0.7, 50, valid=valid[1])
    assert idx.shape == keep.shape == (2, 50) and bool(keep.all())
    assert torch.equal(idx1, idx[1]) and torch.equal(keep1, keep[1])
    assert tnms.LAUNCHES == before


@pytest.mark.parametrize("thr", [0.3, 0.7, 0.5])
def test_threshold_is_compared_in_f32(thr):
    boxes, scores, expected = nms_cases.threshold_pairs(thr)
    for idx, keep in (tnms.nms(boxes, scores, thr, 6),
                      tnms.nms_sequential(boxes, scores, thr, 6)):
        kept = idx[keep].tolist()
        assert kept[:3] == [0, 2, 4]  # the upper boxes, disjoint
        assert [2 * j + 1 in kept for j in range(3)] == expected
    assert expected == [True, False, True]


def test_non_finite_scores_are_skipped_without_a_slot():
    boxes, scores, valid = nms_cases.rpn_like(3, 2, 300)
    gen = torch.Generator().manual_seed(3)
    pick = torch.rand(scores.shape, generator=gen)
    scores = torch.where(pick < 0.05, float("nan"), scores)
    scores = torch.where((pick >= 0.05) & (pick < 0.08), float("inf"), scores)
    scores = torch.where((pick >= 0.08) & (pick < 0.1), float("-inf"), scores)
    idx, keep = tnms.nms(boxes, scores, 0.7, 120, valid=valid)
    for b in range(2):
        ref = tnms.nms_sequential(boxes[b], scores[b], 0.7, 120,
                                  valid=valid[b] & torch.isfinite(scores[b]))
        assert torch.equal(idx[b], ref[0]) and torch.equal(keep[b], ref[1])
        assert bool(torch.isfinite(scores[b][idx[b][keep[b]]]).all())


def test_other_devices_raise():
    boxes = torch.zeros((3, 4), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tnms.nms(boxes, torch.zeros(3, device="meta"), 0.5, 2)
