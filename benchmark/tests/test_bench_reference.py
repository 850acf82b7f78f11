"""The plain reference against the port on a small detector on the CPU:
the same weights and inputs give the same training losses, gradients and
detections; and its greedy NMS and RoIAlign against direct forms."""

import numpy as np
import pytest
import torch

from benchmark import archs
from benchmark.inputs import make_frames, make_records
from benchmark.reference import ops
from benchmark.reference.trainer import Trainer
from benchmark.sut import ProgramDetector, ProgramTrainer
from benchmark.weights import make_weights

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_training_step_as_the_port(tiny, dtype, tol):
    c = tiny("frcnn-r101-c4.train", dtype)
    arch = archs.of(c.config)
    pc = arch.port_configs(c.config)
    records = make_records(c.traffic, pc["detection"]["num_classes"], 3)
    program = ProgramTrainer(c.config, make_weights(c.config, 5, CPU), CPU)
    ref = Trainer(arch.reference(c.config, make_weights(c.config, 5, CPU),
                                 c.config["compute_dtype"], train=True), pc["train"])
    assemble, arg = program.assembler()
    batch = assemble(records[:2], arg)
    mine = arch.train_batch(records[:2], pc["train"])
    assert all(np.array_equal(batch[k], mine[k]) for k in batch)
    got = {k: float(v) for k, v in program.step(batch).items()}
    want = ref.step({k: torch.as_tensor(v).long() if k == "gt_classes" else torch.as_tensor(v)
                     for k, v in mine.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=tol, abs=1e-6), k
    for name, buf in program.first_update().items():
        ref_buf = ref.first_update[name]
        scale = max(float(ref_buf.norm()), 1e-12)
        assert float((buf - ref_buf).norm()) / scale < 20 * tol, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detections_as_the_port(tiny, dtype):
    c = tiny("frcnn-r101-c4.detect", dtype)
    frames = make_frames(c.traffic, 9, CPU)
    bs = c.traffic["batch_size"]
    got = ProgramDetector(c.config, make_weights(c.config, 4, CPU), CPU, bs).detect(frames)
    ref = archs.of(c.config).reference(c.config, make_weights(c.config, 4, CPU),
                                       c.config["compute_dtype"])
    want = ref.detect(torch.as_tensor(frames[:bs]))
    assert got["mask"][:bs].sum() > 0
    np.testing.assert_array_equal(got["mask"][:bs], want["mask"].numpy())
    np.testing.assert_array_equal(got["classes"][:bs], want["classes"].numpy())
    np.testing.assert_allclose(got["scores"][:bs], want["scores"].float().numpy(), atol=1e-6)
    np.testing.assert_allclose(got["boxes"][:bs], want["boxes"].float().numpy(), atol=1e-4)


def test_greedy_nms_keeps_what_a_direct_walk_keeps():
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 60, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand(2, 60, 2, generator=g) * 20], dim=-1)
    scores = torch.rand(2, 60, generator=g).round(decimals=1)  # ties broken by index
    valid = torch.rand(2, 60, generator=g) > 0.2
    idx, keep = ops.nms(boxes, scores, 0.5, 12, valid)
    for b in range(2):
        kept = []
        for i in sorted(range(60), key=lambda i: (-float(scores[b, i]), i)):
            if valid[b, i] and all(float(ops.iou(boxes[b, i:i + 1], boxes[b, j:j + 1])) <= 0.5
                                   for j in kept) and len(kept) < 12:
                kept.append(i)
        assert idx[b][keep[b]].tolist() == kept


def test_roi_align_against_direct_sampling():
    g = torch.Generator().manual_seed(1)
    feats = torch.rand(2, 6, 7, 3, generator=g)
    boxes = torch.tensor([[0.5, 0.5, 4.0, 5.5], [-1.0, 2.0, 6.5, 6.9]])
    img = torch.tensor([0, 1], dtype=torch.int32)
    out = ops.roi_align(feats, boxes, img, 2, 2)

    def sample(f, y, x):
        h, w = f.shape[:2]
        if y < -1 or y > h or x < -1 or x > w:
            return torch.zeros(f.shape[2])
        y, x = max(y, 0.0), max(x, 0.0)
        y0, x0 = min(int(y), h - 1), min(int(x), w - 1)
        y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
        ly = 0.0 if y0 >= h - 1 else y - y0
        lx = 0.0 if x0 >= w - 1 else x - x0
        return ((1 - ly) * (1 - lx) * f[y0, x0] + (1 - ly) * lx * f[y0, x1]
                + ly * (1 - lx) * f[y1, x0] + ly * lx * f[y1, x1])

    for r, (x0, y0, x1, y1) in enumerate(boxes.tolist()):
        bw, bh = (x1 - x0) / 2, (y1 - y0) / 2
        for i in range(2):
            for j in range(2):
                acc = sum(sample(feats[int(img[r])], y0 - 0.5 + (i + (a + 0.5) / 2) * bh,
                                 x0 - 0.5 + (j + (b + 0.5) / 2) * bw)
                          for a in range(2) for b in range(2)) / 4
                torch.testing.assert_close(out[r, i, j], acc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision,step", [("tf32", 2.0 ** -11), ("fp8", 2.0 ** -4)])
def test_control_operand_rounds_one_step_lower(precision, step):
    """The control's operands: TF32's 10-bit mantissa to nearest, or e4m3 on
    one scale a tensor (normal values within half a step of 3 bits), the
    gradient passed straight through."""
    g = torch.Generator().manual_seed(2)
    x = (torch.rand(4096, generator=g) + 0.5).requires_grad_()
    q = ops.operand(x, precision)
    rel = ((q.float() - x) / x).abs().detach()
    assert float(rel.max()) <= step and float(rel.max()) > step / 64
    q.float().sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
