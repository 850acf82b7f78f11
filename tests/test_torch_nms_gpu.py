"""The NMS kernel (csrc/nms.cu) on a card (marked gpu; each test skips
without one).

Imports only torch, numpy and the port:
``python -m pytest tests/test_torch_nms_gpu.py -q``.

Every case runs ``nms`` on CUDA tensors under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync on the card's
path fails it, checks that ``LAUNCHES["nms"]`` rose by one (by none where
the output is empty), and holds the kernel's (indices, keep) bit-equal to
the blocked loop on CPU copies and to ``nms_sequential`` image by image
(with a +inf or NaN score marked invalid, since the sequential oracle
spends a slot on one and the other two skip it):

* the three calls of the detector's cells (``tools/nms_cases.py``): the
  RPN in training (4 x 12,000 -> 2,000 at 0.7) and at test (8 x 6,000 ->
  1,000), and the class-aware field (8 x 35,000 -> 100 at 0.5, most
  below the score cut);
* a kept list of more than 10,000 boxes, past what a block's shared
  memory would hold;
* tied scores, and bf16 scores (ties by the thousand);
* pairs with IoU exactly f32(thr) and one ulp either side;
* an image with no valid candidate beside a full one;
* top_k > N, N < 32, top_k == 0, and the 2-D form;
* NaN and +-inf scores.

Boxes in another type than f32 raise.
"""

import pytest
import torch

from tspn_tpu_torch.tools import nms_cases
from tspn_tpu_torch.ops import nms as tnms

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the nms kernel has no CPU mode")
    return torch.device("cuda")


def _sequential(boxes, scores, thr, top_k, valid):
    """nms_sequential image by image, non-finite scores marked invalid."""
    ok = torch.isfinite(scores) if valid is None else valid & torch.isfinite(scores)
    if boxes.dim() == 2:
        return tnms.nms_sequential(boxes, scores, thr, top_k, valid=ok)
    pairs = [tnms.nms_sequential(boxes[b], scores[b], thr, top_k, valid=ok[b])
             for b in range(boxes.shape[0])]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _check(dev, boxes, scores, thr, top_k, valid=None):
    """The kernel against both plain versions -> the kernel's output."""
    args = [t.to(dev) for t in (boxes, scores)]
    v = None if valid is None else valid.to(dev)
    torch.cuda.synchronize()
    before = tnms.LAUNCHES["nms"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, keep = tnms.nms(*args, thr, top_k, valid=v)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    idx, keep = idx.cpu(), keep.cpu()
    want_k = min(top_k, scores.shape[-1])
    assert idx.shape == keep.shape == (*scores.shape[:-1], want_k)
    assert idx.dtype == torch.int64 and keep.dtype == torch.bool
    assert tnms.LAUNCHES["nms"] == before + (1 if idx.numel() else 0)
    ref = tnms.nms(boxes, scores, thr, top_k, valid=valid)
    assert torch.equal(idx, ref[0]) and torch.equal(keep, ref[1])
    seq = _sequential(boxes, scores, thr, top_k, valid)
    assert torch.equal(idx, seq[0]) and torch.equal(keep, seq[1])
    return idx, keep


@pytest.mark.parametrize("shape", sorted(nms_cases.CELL_SHAPES))
def test_cell_shapes(cuda_device, shape):
    b, n, top_k, thr = nms_cases.CELL_SHAPES[shape]
    if shape == "class_aware":
        boxes, scores, valid = nms_cases.class_aware(11, b)
    else:
        boxes, scores, valid = nms_cases.rpn_like(11, b, n)
    assert scores.shape == (b, n)
    idx, keep = _check(cuda_device, boxes, scores, thr, top_k, valid)
    assert bool(keep.any(dim=1).all())


def test_kept_list_in_global_memory(cuda_device):
    # scattered boxes, most kept: the kept list outgrows the 227 KB of
    # shared memory a block may have (20 B a box)
    boxes, scores, valid = nms_cases.rpn_like(5, 2, 16000, objects=16000)
    idx, keep = _check(cuda_device, boxes, scores, 0.7, 12000, valid)
    assert int(keep.sum(dim=1).min()) > 10400


def test_tied_scores(cuda_device):
    boxes, scores, valid = nms_cases.rpn_like(7, 3, 3000)
    _check(cuda_device, boxes, torch.round(scores * 2) / 2, 0.7, 600, valid)


def test_bf16_scores(cuda_device):
    boxes, scores, valid = nms_cases.rpn_like(8, 4, 6000)
    _check(cuda_device, boxes, scores.to(torch.bfloat16), 0.7, 1000, valid)


@pytest.mark.parametrize("thr", [0.3, 0.7, 0.5])
def test_iou_at_the_f32_threshold(cuda_device, thr):
    boxes, scores, expected = nms_cases.threshold_pairs(thr)
    idx, keep = _check(cuda_device, boxes, scores, thr, 6)
    kept = idx[keep].tolist()
    assert [2 * j + 1 in kept for j in range(3)] == expected == [True, False, True]


def test_empty_image_beside_a_full_one(cuda_device):
    boxes, scores, valid = nms_cases.rpn_like(9, 2, 2500)
    valid[0] = False
    idx, keep = _check(cuda_device, boxes, scores, 0.7, 500, valid)
    assert not bool(keep[0].any()) and not bool(idx[0].any()) and bool(keep[1].any())


@pytest.mark.parametrize("n,top_k", [(5, 9), (20, 7), (300, 0), (40, 40)])
def test_small_and_clipped_top_k(cuda_device, n, top_k):
    boxes, scores, valid = nms_cases.rpn_like(n, 3, n, objects=4)
    _check(cuda_device, boxes, scores, 0.5, top_k, valid)


def test_single_image_form(cuda_device):
    boxes, scores, valid = nms_cases.rpn_like(10, 1, 3000)
    _check(cuda_device, boxes[0], scores[0], 0.7, 700, valid[0])
    _check(cuda_device, boxes[0], scores[0], 0.7, 700)


def test_non_finite_scores(cuda_device):
    boxes, scores, valid = nms_cases.rpn_like(12, 4, 4000)
    gen = torch.Generator().manual_seed(12)
    pick = torch.rand(scores.shape, generator=gen)
    scores = torch.where(pick < 0.05, float("nan"), scores)
    scores = torch.where((pick >= 0.05) & (pick < 0.08), float("inf"), scores)
    scores = torch.where((pick >= 0.08) & (pick < 0.1), float("-inf"), scores)
    idx, keep = _check(cuda_device, boxes, scores, 0.7, 800, valid)
    assert bool(torch.isfinite(torch.gather(scores, 1, idx)[keep]).all())


def test_boxes_of_another_type_raise(cuda_device):
    boxes, scores, _ = nms_cases.rpn_like(13, 1, 64)
    with pytest.raises(TypeError, match="float32"):
        tnms.nms(boxes.to(cuda_device, torch.float64), scores.to(cuda_device), 0.5, 8)
