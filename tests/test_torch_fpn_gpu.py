"""K7's levels form and the X101-FPN detector on a card (marked gpu; each
test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_fpn_gpu.py -q``.

* The multi-level K7 forward equals ``roi_align_levels_plain`` (per-level
  ``roi_align_plain``) bit for bit in f32, at the detection cell's
  geometry (8 images of 768 x 1344: P2-P5 of 256 channels, 8,000 RoIs of
  every level), the training cell's (4 of 800 x 1344, 512 RoIs), a ragged
  count, and RoIs past the borders, empty and off-range (an image or a
  level outside its range pools zeros); one launch a call.
* Its backward agrees with autograd of the plain form within K7's
  1e-5 * T + 1e-6 per element (T the plain backward of |dOut|): its
  atomics add in another order; one launch a call.
* An FPN detect batch and an FPN training step (forward, backward, SGD)
  run under ``torch.cuda.set_sync_debug_mode("error")`` up to their
  readback, so the path makes no host sync; the detections equal those of
  the same model with the plain RoIAlign.
* ``tools/train_detector.py --arch x-fpn`` trains on the card through
  ``train_detector`` and writes a checkpoint that reloads.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.detection import train as dt
from tspn_tpu_torch.detection.fpn import FPNConfig, FPNFasterRCNN, assign_levels
from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
from tspn_tpu_torch.ops import roi_align as tra

pytestmark = pytest.mark.gpu

SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _maps(dev, n, canvas_hw, c=256, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.rand(n, canvas_hw[0] // s, canvas_hw[1] // s, c, device=dev, generator=g)
            for s in (4, 8, 16, 32)]


def _rois(dev, n, r, canvas_hw, seed=1):
    """RoIs of every level: sides from 1 to 900 pixels, some past the
    borders, one empty."""
    rng = np.random.RandomState(seed)
    h, w = canvas_hw
    side = np.exp(rng.uniform(0.0, np.log(900.0), (r, 2)))
    lo = rng.uniform(-0.1, 1.0, (r, 2)) * [w, h]
    boxes = np.concatenate([lo, lo + side], axis=1).astype(np.float32)
    boxes[0] = [0, 0, w, h]
    boxes[1] = [w - 3, h - 2, w + 40, h + 50]
    boxes[2] = [8, 8, 8, 8]
    idx = rng.randint(0, n, r).astype(np.int32)
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(idx).to(dev))


def _plain(maps, boxes, idx, levels, chunk=512):
    """The plain per-level form, ``chunk`` RoIs at a time (its gather holds
    (RoIs, 14, W, C))."""
    return torch.cat([tra.roi_align_levels_plain(maps, boxes[k: k + chunk], idx[k: k + chunk],
                                                 levels[k: k + chunk], SCALES, 7, 2)
                      for k in range(0, len(boxes), chunk)])


@pytest.mark.parametrize("n,canvas_hw,r", [(8, (768, 1344), 8000), (8, (768, 1344), 7993),
                                           (4, (800, 1344), 512)])
def test_forward_equals_plain_at_the_cells_geometry(cuda_device, n, canvas_hw, r):
    maps = _maps(cuda_device, n, canvas_hw)
    boxes, idx = _rois(cuda_device, n, r, canvas_hw)
    levels = assign_levels(boxes)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    before = tra.LAUNCHES["roi_align_levels"]
    out = tra.roi_align_levels(maps, boxes, idx, levels, SCALES, 7, 2)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["roi_align_levels"] == before + 1
    assert torch.equal(out, _plain(maps, boxes, idx, levels))


def test_off_range_image_or_level_pools_zeros(cuda_device):
    maps = _maps(cuda_device, 2, (64, 96), c=8)
    boxes = torch.tensor([[4.0, 4.0, 40.0, 30.0]] * 4, device=cuda_device)
    idx = torch.tensor([0, 2, -1, 1], dtype=torch.int32, device=cuda_device)
    levels = torch.tensor([1, 0, 3, 4], dtype=torch.int32, device=cuda_device)
    out = tra.roi_align_levels(maps, boxes, idx, levels, SCALES, 7, 2)
    assert bool((out[1:] == 0).all()) and bool((out[0] != 0).any())
    assert torch.equal(out[0], tra.roi_align_plain(maps[1], boxes[:1] / 8, idx[:1], 7, 2)[0])


@pytest.mark.parametrize("n,canvas_hw,r,c", [(4, (800, 1344), 512, 256), (2, (64, 96), 61, 6)])
def test_backward_agrees_with_plain(cuda_device, n, canvas_hw, r, c):
    maps = _maps(cuda_device, n, canvas_hw, c=c)
    boxes, idx = _rois(cuda_device, n, r, canvas_hw, seed=2)
    levels = assign_levels(boxes)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dout = torch.rand((r, 7, 7, c), device=cuda_device, generator=g) * 2 - 1
    leaves = [m.clone().requires_grad_(True) for m in maps]
    before = tra.LAUNCHES["roi_align_levels_backward"]
    tra.roi_align_levels(leaves, boxes, idx, levels, SCALES, 7, 2).backward(dout)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["roi_align_levels_backward"] == before + 1

    def plain_grad(cot):
        total = [torch.zeros_like(m) for m in maps]
        for k in range(0, r, 128):
            f = [m.clone().requires_grad_(True) for m in maps]
            out = tra.roi_align_levels_plain(f, boxes[k: k + 128], idx[k: k + 128],
                                             levels[k: k + 128], SCALES, 7, 2)
            grads = torch.autograd.grad((out * cot[k: k + 128]).sum(), f, allow_unused=True)
            total = [t if gr is None else t + gr for t, gr in zip(total, grads)]
        return total

    for leaf, ref, terms in zip(leaves, plain_grad(dout), plain_grad(dout.abs())):
        err = (leaf.grad.double() - ref.double()).abs()
        bound = 1e-5 * terms.double() + 1e-6
        assert bool((err <= bound).all()), float((err / bound).max())


# ----------------------------------------------------------- the detector
CFG = FPNConfig(num_classes=35, depth=26, pre_nms_topk_train=1000, post_nms_topk_train=500,
                pre_nms_topk_test=500, post_nms_topk_test=300)
HW = (256, 384)


def _model(dev):
    model = FPNFasterRCNN(CFG, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():  # so that detections survive the score threshold
        model.cls_score.bias[:3] = 3.0
    return model.to(memory_format=torch.channels_last)


def _batch(dev, n=2):
    rng = np.random.RandomState(4)
    img = rng.rand(n, *HW, 3).astype(np.float32) * 0.3
    boxes = np.zeros((n, 8, 4), np.float32)
    for i in range(n):
        for j in range(5):
            x0, y0 = rng.randint(0, HW[1] - 80), rng.randint(0, HW[0] - 80)
            x1, y1 = x0 + rng.randint(12, 80), y0 + rng.randint(12, 80)
            img[i, y0:y1, x0:x1] = rng.rand(3)
            boxes[i, j] = [x0, y0, x1, y1]
    mask = (boxes[..., 2] > 0).astype(np.float32)
    classes = rng.randint(0, 35, (n, 8))
    return dt.batch_to_device({"image": img, "gt_boxes": boxes, "gt_classes": classes,
                               "gt_mask": mask}, dev)


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_detect_batch_makes_no_host_sync_and_equals_plain(cuda_device):
    model = _model(cuda_device).eval()
    images = _batch(cuda_device)["image"]
    model.detect(images)  # builds the kernels and caches the anchors
    before = dict(tra.LAUNCHES)
    out = _no_sync(lambda: model.detect(images))
    assert tra.LAUNCHES["roi_align_levels"] == before["roi_align_levels"] + 1
    model.roi_pool = tra.roi_align_levels_plain
    ref = model.detect(images)
    assert int(ref["mask"].sum()) > 10
    for k in ("boxes", "scores", "classes", "mask"):
        assert torch.equal(out[k].cpu(), ref[k].cpu()), k


def test_training_step_makes_no_host_sync(cuda_device):
    model = _model(cuda_device).train()
    cfg = DetectorTrainConfig(base_lr=1e-3, warmup_iters=2)
    optimizer, scheduler = dt.build_detector_optimizer(model.parameters(), cfg)
    batch = _batch(cuda_device)
    dt.detector_train_step(model, optimizer, scheduler, batch)
    before = dict(tra.LAUNCHES)
    losses = _no_sync(lambda: dt.detector_train_step(model, optimizer, scheduler, batch))
    assert tra.LAUNCHES["roi_align_levels"] == before["roi_align_levels"] + 1
    assert tra.LAUNCHES["roi_align_levels_backward"] == (
        before["roi_align_levels_backward"] + 1)
    values = {k: float(v) for k, v in losses.items()}
    assert all(np.isfinite(v) for v in values.values()) and values["loss_rpn_obj"] > 0


def test_cli_trains_x_fpn_on_the_card_and_its_checkpoint_reloads(cuda_device, tmp_path,
                                                                  monkeypatch):
    """``tools/train_detector.py --arch x-fpn`` through ``train_detector``
    on the card (K7's levels form forward and backward each step)."""
    from tspn_tpu_torch.runtime import checkpoint as tckpt
    from tspn_tpu_torch.tools import train_detector as tool

    rng = np.random.RandomState(0)
    records = [{"image": (rng.rand(96, 128, 3) * 255).astype(np.uint8), "image_id": i,
                "height": 96, "width": 128,
                "annotations": [{"bbox": [10.0, 8.0, 70.0, 60.0], "category_id": i % 3,
                                 "bbox_mode": "XYXY_ABS"}]} for i in range(4)]
    monkeypatch.setattr(tool, "_load_records", lambda args, split: records)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "fpn.pt")
    before = tra.LAUNCHES["roi_align_levels_backward"]
    model, history = tool.main(["--data_dir", "x", "--arch", "x-fpn", "--depth", "26",
                                "--max_iter", "2", "--ims_per_batch", "2", "--image_size", "128",
                                "--output", out])
    assert isinstance(model, FPNFasterRCNN) and next(model.parameters()).is_cuda
    assert tra.LAUNCHES["roi_align_levels_backward"] == before + 2
    assert all(np.isfinite(v) for step in history["losses"] for v in step.values())
    with torch.device("meta"):
        loaded = FPNFasterRCNN(FPNConfig(num_classes=35, depth=26))
    loaded = loaded.to_empty(device="cpu")
    loaded.load_state_dict(tckpt.load_detector_checkpoint(out))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v.cpu()), k
