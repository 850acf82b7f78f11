"""The port's Faster R-CNN X101-FPN (``detection/fpn.py``) on the CPU, held
against the benchmark's plain reference (``benchmark/reference/fpn.py``,
plain PyTorch that imports nothing of the port) on seeded weights at a
small size: depth 26, 4 groups of 4 in res2, an FPN of 32 channels, two
96 x 128 images.

Tolerances. Both sides run the same float32 operations in the same order
on one CPU, and every value compared reads 0 here except the gradients;
``VALUES`` (1e-6 relative, about eight ulps) leaves a library room to
split a reduction otherwise. The gradients (measured 8.1e-7 of a leaf's
largest) take ``GRADS``, 1e-5 of each leaf's largest: the port's RoIAlign
gradient flows through its own per-level scatter and the reference's
through its chunks, so their sums add in another order. Rounding the
reference's conv and dense operands to TF32 moves the features by 1.1e-3,
the RPN logits by 1.6e-5, the losses by 1.3e-5, the gradients by 6.3e-2
and the proposals by pixels: ``test_tf32_operands_fail_the_tolerances``
holds that they fail.

Also: the level rule on boxes worked out by hand; the multi-level
RoIAlign's CPU path against per-level plain RoIAlign (the port's and the
reference's), forward and backward; the training CLI's ``--arch x-fpn``
and a detector checkpoint's round trip.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.archs.fpn import Arch
from benchmark.reference import ops as ref_ops
from benchmark.reference.fpn import Detector
from tspn_tpu_torch.detection import train as dt
from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN, assign_levels
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.ops import roi_align as tra
from tspn_tpu_torch.runtime import checkpoint as tckpt

VALUES = dict(rtol=1e-6, atol=1e-6)
GRADS = 1e-5
CFG = FPNConfig(num_classes=3, depth=26, groups=4, width_per_group=4, fpn_channels=32,
                fc_dim=128, pre_nms_topk_train=300, post_nms_topk_train=100,
                pre_nms_topk_test=200, post_nms_topk_test=80, roi_batch_size=32,
                max_detections=20)
ARCH = Arch(depth=26, num_classes=3, groups=4, width=16, stem=64, res2_out=256, fpn=32,
            anchors=3, pool=7, fc=128)
HW = (96, 128)


@pytest.fixture(scope="module")
def model():
    m = FPNFasterRCNN(CFG, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # so that detections survive the score threshold
        m.cls_score.bias[:2] = 3.0
    return m


@pytest.fixture(scope="module")
def weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def batch():
    img = torch.rand(2, *HW, 3, generator=torch.Generator().manual_seed(0))
    gt = torch.tensor([[[10, 10, 50, 60], [30, 20, 90, 80], [60, 40, 120, 90]],
                       [[5, 5, 40, 40], [20, 30, 100, 90], [0, 0, 0, 0]]], dtype=torch.float32)
    return img, gt, torch.tensor([[0, 1, 2], [2, 0, 0]]), torch.tensor([[1.0, 1, 1], [1, 1, 0]])


def _reference(weights, precision="float32", train=False):
    return Detector(ARCH, CFG._asdict(), weights, precision, train=train)


def _forward(model, ref, img):
    """Features, RPN outputs, anchors and test proposals of both sides."""
    with torch.no_grad():
        fp, fr = model.features(img), ref.features(img)
        (lp, dp), (lr, dr) = model._rpn(fp), ref.rpn(fr)
        ap, ar = model.anchors(fp), ref.anchors(fr)
        pre, post = CFG.pre_nms_topk_test, CFG.post_nms_topk_test
        props = model.proposals(lp, dp, ap, HW, pre, post)
        boxes, keep = ref.proposals(lr, dr, ar, HW, pre, post)
    return {"feats": (fp, fr), "logits": (lp, lr), "deltas": (dp, dr), "anchors": (ap, ar),
            "props": (props, (boxes, keep))}


def test_features_rpn_and_proposals_equal_the_reference(model, weights, batch):
    out = _forward(model, _reference(weights), batch[0])
    fp, fr = out["feats"]
    assert [tuple(p.shape[2:]) for p in fp] == [(24, 32), (12, 16), (6, 8), (3, 4), (2, 2)]
    for a, b in zip(fp, fr):
        torch.testing.assert_close(a, b, **VALUES)
    for key in ("logits", "deltas", "anchors"):
        torch.testing.assert_close(*out[key], **VALUES)
    props, (boxes, keep) = out["props"]
    assert torch.equal(props.mask, keep) and keep.sum() > 20
    torch.testing.assert_close(props.boxes * keep[..., None], boxes * keep[..., None], **VALUES)


def test_detections_equal_the_reference(model, weights, batch):
    ours, ref = model.detect(batch[0]), _reference(weights).detect(batch[0])
    assert torch.equal(ours["mask"], ref["mask"]) and ref["mask"].sum() > 10
    assert torch.equal(ours["classes"] * ours["mask"], ref["classes"] * ref["mask"])
    m = ref["mask"][..., None]
    torch.testing.assert_close(ours["boxes"] * m, ref["boxes"] * m, **VALUES)
    torch.testing.assert_close(ours["scores"], ref["scores"], **VALUES)


def _training(model, ref, batch):
    lp, lr = model(*batch), ref.losses(*batch)
    names = [k for k, _ in model.named_parameters()]
    gp = torch.autograd.grad(sum(lp.values()), [p for _, p in model.named_parameters()])
    gr = torch.autograd.grad(sum(lr.values()), [ref.w[k] for k in names])
    return lp, lr, dict(zip(names, zip(gp, gr)))


def _grad_gap(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_training_step_losses_and_every_gradient_equal_the_reference(model, weights, batch):
    model.zero_grad(set_to_none=True)
    lp, lr, grads = _training(model, _reference(weights, train=True), batch)
    assert set(lp) == set(lr) == set(dt.LOSS_KEYS)
    for k in dt.LOSS_KEYS:
        torch.testing.assert_close(lp[k].detach(), lr[k].detach(), **VALUES)
    assert len(grads) == len(weights)
    worst = max(grads, key=lambda k: _grad_gap(*grads[k]))
    assert _grad_gap(*grads[worst]) <= GRADS, worst


def test_tf32_operands_fail_the_tolerances(model, weights, batch):
    """The control: the reference with TF32 operands is outside the
    tolerances that the float32 reference meets."""
    out = _forward(model, _reference(weights, "tf32"), batch[0])
    feat_gap = max(float(((a - b).abs() / b.abs().max()).max()) for a, b in zip(*out["feats"]))
    assert feat_gap > 100 * VALUES["rtol"]
    _lp, _lr, grads = _training(model, _reference(weights, "tf32", train=True), batch)
    assert max(_grad_gap(*g) for g in grads.values()) > 100 * GRADS


# --------------------------------------------------------------- levels
def test_level_rule_on_hand_computed_boxes():
    """floor(4 + log2(sqrt(area) / 224 + 1e-8)) clamped to 2..5, less 2."""
    sides = [(224, 224, 2), (112, 112, 1), (111, 113, 0), (448, 448, 3), (1000, 900, 3),
             (10, 10, 0), (0, 50, 0), (223, 224, 1), (56, 56, 0), (57, 57, 0), (300, 200, 2)]
    # sqrt(111 * 113) = 111.995 < 112: level 2; sqrt(223 * 224) < 224: level 3;
    # 56 = 224 / 4 gives floor(4 - 2) = 2; sqrt(60000) = 244.9: level 4
    boxes = torch.tensor([[3.0, 5.0, 3.0 + w, 5.0 + h] for w, h, _ in sides])
    want = torch.tensor([lvl for *_, lvl in sides], dtype=torch.int32)
    got = assign_levels(boxes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    for (w, h, lvl), g in zip(sides, got.tolist()):
        area = w * h
        exact = min(max(math.floor(4 + math.log2(math.sqrt(area) / 224 + 1e-8))
                        if area else 2, 2), 5) - 2
        assert g == exact == lvl


def _maps(n=2, c=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(n, 48 // s, 64 // s, c, generator=g) for s in (1, 2, 4, 8)]


def _rois(r=40, seed=2):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, 250, (r, 2))
    wh = np.exp(rng.uniform(np.log(0.5), np.log(300), (r, 2)))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[0] = [0, 0, 256, 192]      # the whole image
    boxes[1] = [250, 180, 300, 260]  # over the border
    boxes[2] = [10, 10, 10, 10]      # empty
    boxes[3] = [-40, -30, 560, 470]  # P5's, past the map
    boxes[4] = [20, 20, 320, 220]    # P4's
    return torch.from_numpy(boxes), torch.from_numpy(rng.randint(0, 2, r).astype(np.int32))


SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def test_multilevel_roi_align_equals_per_level_plain():
    maps, (boxes, img) = _maps(), _rois()
    levels = assign_levels(boxes)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    tra.reset_launches()
    out = tra.roi_align_levels(maps, boxes, img, levels, SCALES, 7, 2)
    assert out.shape == (40, 7, 7, 16) and not any(tra.LAUNCHES.values())
    for r in range(len(boxes)):
        lvl = int(levels[r])
        want = tra.roi_align_plain(maps[lvl], boxes[r: r + 1] * SCALES[lvl], img[r: r + 1], 7, 2)
        assert torch.equal(out[r: r + 1], want), r
        ref = ref_ops.roi_align(maps[lvl], boxes[r: r + 1] / (4 << lvl), img[r: r + 1], 7, 2)
        assert torch.equal(out[r: r + 1], ref), r


def test_multilevel_roi_align_gradient_equals_per_level_plain():
    maps, (boxes, img) = _maps(c=8), _rois(r=24, seed=3)
    levels = assign_levels(boxes)
    cot = torch.randn(24, 7, 7, 8, generator=torch.Generator().manual_seed(4))
    leaves = [m.clone().requires_grad_(True) for m in maps]
    got = torch.autograd.grad((tra.roi_align_levels(leaves, boxes, img, levels, SCALES) * cot)
                              .sum(), leaves)
    want = [torch.zeros_like(m) for m in maps]
    for r in range(len(boxes)):
        lvl = int(levels[r])
        f = maps[lvl].clone().requires_grad_(True)
        out = tra.roi_align_plain(f, boxes[r: r + 1] * SCALES[lvl], img[r: r + 1], 7, 2)
        want[lvl] += torch.autograd.grad((out * cot[r: r + 1]).sum(), f)[0]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(float(g.abs().sum()) > 0 for g in got)


def test_multilevel_roi_align_refuses_bad_operands():
    maps, (boxes, img) = _maps(), _rois()
    levels = assign_levels(boxes)
    with pytest.raises(ValueError):
        tra.roi_align_levels(maps + maps[:1], boxes, img, levels, SCALES + (1 / 64,))
    with pytest.raises(TypeError):
        tra.roi_align_levels(maps, boxes, img, levels.long(), SCALES)
    with pytest.raises(TypeError):
        tra.roi_align_levels([m.double() for m in maps], boxes, img, levels, SCALES)


# ---------------------------------------------------------- the normal path
def test_fpn_refuses_bfloat16():
    with pytest.raises(ValueError, match="float32"):
        FPNFasterRCNN(CFG, dtype=torch.bfloat16)
    assert isinstance(dt.build_detector(CFG), FPNFasterRCNN)
    c4 = dt.build_detector(DetectionConfig(num_classes=3, depth=26))
    assert type(c4) is FasterRCNN


def test_cli_arch_x_fpn_trains_and_its_checkpoint_round_trips(tmp_path, monkeypatch):
    from tspn_tpu_torch.tools import train_detector as tool

    rng = np.random.RandomState(0)
    records = [{"image": (rng.rand(48, 64, 3) * 255).astype(np.uint8), "image_id": i,
                "height": 48, "width": 64,
                "annotations": [{"bbox": [8.0, 6.0, 40.0, 30.0], "category_id": i % 3,
                                 "bbox_mode": "XYXY_ABS"}]} for i in range(4)]
    monkeypatch.setattr(tool, "_load_records", lambda args, split: records)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        tool.parse_args(["--data_dir", "x", "--arch", "x-fpn", "--bf16", "--device", "cpu"])
    out = str(tmp_path / "fpn.pt")
    model, history = tool.main(["--data_dir", "x", "--arch", "x-fpn", "--depth", "26",
                                "--max_iter", "1", "--ims_per_batch", "2", "--image_size", "64",
                                "--device", "cpu", "--output", out])
    assert isinstance(model, FPNFasterRCNN) and model.cfg.groups == 32
    assert len(history["losses"]) == 1 and all(math.isfinite(v)
                                               for v in history["losses"][0].values())
    with torch.device("meta"):  # no initializer to run: the checkpoint fills it
        loaded = FPNFasterRCNN(FPNConfig(num_classes=35, depth=26))
    loaded = loaded.to_empty(device="cpu")
    loaded.load_state_dict(tckpt.load_detector_checkpoint(out))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
