"""Detector training on a card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_detector_train_gpu.py -q``.

* A depth-26 detector (3 classes, 64 x 96 images, batch 2) takes three
  SGD steps with K7 (forward and backward) and, from the same init and
  batches, with the plain RoIAlign: step-1 losses within rtol 1e-4 in f32
  (K7's forward equals the plain version bit for bit; TF32 off) and 1e-2
  in bf16; in f32 every later step within rtol 1e-3, as the backward's
  atomics add in another order (in bf16 later steps are only finite: an
  ulp flip of a bf16 activation moves a small loss by more); each kernel
  step launches one K7 forward and one backward.
* ``train_detector`` on the card writes a checkpoint that reloads.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.detection import train as dt
from tspn_tpu_torch.detection.inputs import DetectorTrainConfig
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.ops import roi_align as tra
from tspn_tpu_torch.runtime import checkpoint as tckpt

pytestmark = pytest.mark.gpu

CFG = DetectionConfig(num_classes=3, depth=26, anchor_sizes=(32, 64),
                      pre_nms_topk_train=200, post_nms_topk_train=64,
                      pre_nms_topk_test=200, post_nms_topk_test=64, roi_batch_size=32,
                      max_detections=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the roi_align kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batches(n_steps=3, n=2, h=64, w=96):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n_steps):
        img = (rng.rand(n, h, w, 3) * 0.3).astype(np.float32)
        gb = np.zeros((n, 4, 4), np.float32)
        gc = np.zeros((n, 4), np.int32)
        gm = np.zeros((n, 4), np.float32)
        for i in range(n):
            for j in range(rng.randint(1, 4)):
                x0, y0 = rng.randint(0, w - 24), rng.randint(0, h - 20)
                x1, y1 = min(x0 + rng.randint(12, 40), w), min(y0 + rng.randint(10, 30), h)
                img[i, y0:y1, x0:x1] = rng.rand(3)
                gb[i, j], gc[i, j], gm[i, j] = [x0, y0, x1, y1], rng.randint(0, 3), 1.0
        out.append({"image": img, "gt_boxes": gb, "gt_classes": gc, "gt_mask": gm})
    return out


def _train(dev, dtype, roi_pool):
    model = FasterRCNN(CFG, generator=torch.Generator().manual_seed(0), dtype=dtype).to(dev)
    model.roi_pool = roi_pool
    cfg = DetectorTrainConfig(base_lr=0.02, warmup_iters=2)
    optimizer, scheduler = dt.build_detector_optimizer(model.parameters(), cfg)
    return [{k: float(v) for k, v in dt.detector_train_step(
        model, optimizer, scheduler, dt.batch_to_device(b, dev)).items()}
        for b in _batches()]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, (1e-4, 1e-3)),
                                        (torch.bfloat16, (1e-2, None))])
def test_training_steps_kernel_against_plain(cuda_device, dtype, rtol):
    plain = _train(cuda_device, dtype, tra.roi_align_plain)
    tra.reset_launches()
    kernel = _train(cuda_device, dtype, tra.roi_align)
    fwd = "roi_align" if dtype == torch.float32 else "roi_align_bf16"
    assert tra.LAUNCHES[fwd] == 3 and tra.LAUNCHES["roi_align_backward"] == 3
    for step, (k, p) in enumerate(zip(kernel, plain)):
        for name in p:
            assert np.isfinite(k[name])
            if rtol[step > 0] is not None:
                np.testing.assert_allclose(k[name], p[name], rtol=rtol[step > 0],
                                           err_msg=f"step {step + 1} {name}")


def test_train_detector_on_the_card(cuda_device, tmp_path):
    img = np.zeros((96, 96, 3), np.float32)
    img[20:60, 10:50, 0] = 1.0
    rec = {"image": img, "height": 96, "width": 96, "image_id": 0,
           "annotations": [{"bbox": [10, 20, 50, 60], "category_id": 0,
                            "bbox_mode": "XYXY_ABS"}]}
    cfg = DetectorTrainConfig(ims_per_batch=2, max_iter=3, image_size=96, max_gt_boxes=4,
                              log_every=1)
    path = str(tmp_path / "det.pt")
    model, history = dt.train_detector([rec], CFG, cfg, device=cuda_device,
                                       checkpoint_path=path)
    assert len(history["losses"]) == 3
    fresh = FasterRCNN(CFG)
    fresh.load_state_dict(tckpt.load_detector_checkpoint(path))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v.cpu()), k
