"""The RoIAlign CUDA kernel (K7) on a card (marked gpu; each test skips
without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_roi_align_gpu.py -q``.

* K7 equals ``roi_align_plain`` bit for bit (its column-window walk does
  the plain version's float operations in its order): at the boundary
  boxes of tests/test_roi_align.py at (7, 2), (4, 1) and (14, 2), with C
  a multiple of 4 (float4 taps) and not (scalar taps); over a batch of
  images with a ragged RoI count; and, in f32 and bf16, at 8 channels a
  thread (bf16 C = 8: 16-byte accesses), 4 (C = 12) and 1 (C = 6), for a
  RoI as wide as the map, sub-pixel RoIs, RoIs past every edge, out 7
  with s 4 (28 samples a side, the mean's four partial sums) and s 3 (the
  mean's 1/9 a multiply).
* K7's bf16 half equals ``roi_align_plain`` on the same bf16 map (the
  map widened to f32, the output rounded once) bit for bit, at the same
  boxes and over a batch.
* K7's backward agrees with autograd of ``roi_align_plain`` within
  1e-5 * T + 1e-6 per element, T the plain backward of |dOut| (plus one
  bf16 ulp of the plain gradient for a bf16 map): the kernel's atomics add
  in another order, and in no fixed one.
* An image index outside [0, N) pools zeros and takes no gradient; the
  wrapper raises on operands the kernel does not take.
* A small detector on the card launches K7 once per detect batch and
  gives the detections of the plain RoIAlign on the same features.
"""

import pytest
import torch

from tspn_tpu_torch.ops import roi_align as tra

pytestmark = pytest.mark.gpu

BOXES = [
    [2.0, 3.0, 10.0, 12.0],
    [-3.0, -2.0, 5.0, 6.0],
    [18.0, 14.0, 30.0, 26.0],
    [0.0, 0.0, 24.0, 20.0],
    [5.0, 5.0, 5.0, 5.0],
    [-4.0, -3.0, 5.0, 6.0],
    [18.0, 14.0, 28.0, 24.0],
    [-1.5, -1.0, 0.5, 21.0],
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the roi_align kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("c", [8, 6])
@pytest.mark.parametrize("out_size,s", [(7, 2), (4, 1), (14, 2)])
def test_kernel_agrees_with_plain_at_the_borders(cuda_device, out_size, s, c):
    gen = torch.Generator().manual_seed(c)
    feats = torch.rand((1, 20, 24, c), generator=gen).to(cuda_device)
    boxes = torch.tensor(BOXES, device=cuda_device)
    idx = torch.zeros(len(BOXES), dtype=torch.int32, device=cuda_device)
    before = tra.LAUNCHES["roi_align"]
    out = tra.roi_align(feats, boxes, idx, out_size, s)
    ref = tra.roi_align_plain(feats, boxes, idx, out_size, s)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["roi_align"] == before + 1
    assert torch.equal(out, ref)


def test_kernel_agrees_over_a_batch_with_ragged_rois(cuda_device):
    gen = torch.Generator().manual_seed(1)
    feats = torch.rand((3, 40, 40, 256), generator=gen).to(cuda_device)
    r = 301
    xy = torch.rand((r, 2), generator=gen) * 48 - 4
    wh = torch.rand((r, 2), generator=gen) * 30
    boxes = torch.cat([xy, xy + wh], 1).to(cuda_device)
    idx = torch.randint(0, 3, (r,), generator=gen, dtype=torch.int32).to(cuda_device)
    out = tra.roi_align(feats, boxes, idx, 14, 2)
    ref = torch.cat([tra.roi_align_plain(feats, boxes[k:k + 64], idx[k:k + 64], 14, 2)
                     for k in range(0, r, 64)])
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_out_of_range_image_pools_zeros(cuda_device):
    feats = torch.rand((2, 8, 8, 4), device=cuda_device)
    boxes = torch.tensor([[1.0, 1.0, 5.0, 5.0]] * 3, device=cuda_device)
    idx = torch.tensor([0, 2, -1], dtype=torch.int32, device=cuda_device)
    out = tra.roi_align(feats, boxes, idx, 4, 2)
    torch.cuda.synchronize()
    assert out[0].abs().sum() > 0 and not out[1:].any()


def test_kernel_rejects_bad_operands(cuda_device):
    feats = torch.rand((2, 8, 8, 4), device=cuda_device)
    boxes = torch.tensor([[1.0, 1.0, 5.0, 5.0]], device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tra._roi_align_cuda(feats, boxes, idx.long(), 4, 2)
    with pytest.raises(TypeError):
        tra._roi_align_cuda(feats.double(), boxes, idx, 4, 2)
    with pytest.raises(ValueError):
        tra._roi_align_cuda(feats.permute(0, 2, 1, 3), boxes, idx, 4, 2)
    with pytest.raises(ValueError):
        tra._roi_align_cuda(feats, boxes.cpu(), idx, 4, 2)
    with pytest.raises(ValueError):
        tra._roi_align_cuda(feats, boxes, idx, 14, 10)
    with pytest.raises(TypeError):
        tra.roi_align(feats.half(), boxes, idx, 4, 2)


def test_small_detector_on_the_card(cuda_device):
    """Depth 26, 3 classes: one K7 launch per detect batch, and the same
    detections as the plain RoIAlign on the same backbone features."""
    from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
    from tspn_tpu_torch.pipeline import detect_video_frames

    cfg = DetectionConfig(num_classes=3, depth=26, anchor_sizes=(32, 64),
                          pre_nms_topk_test=200, post_nms_topk_test=64,
                          max_detections=16)
    model = FasterRCNN(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    frames = torch.rand((5, 96, 128, 3), generator=torch.Generator().manual_seed(2))
    tra.reset_launches()
    dets = detect_video_frames(model, frames.numpy(), device=cuda_device, batch_size=2)
    assert tra.LAUNCHES["roi_align"] == 3 and dets["mask"].any(axis=1).all()

    images = frames[:2].to(cuda_device)
    with torch.no_grad():
        feats = model.features(images)
        kernel = model.detect_from_features(feats, (96, 128))
        model.roi_pool = tra.roi_align_plain
        try:
            plain = model.detect_from_features(feats, (96, 128))
        finally:
            model.roi_pool = tra.roi_align
    assert torch.equal(kernel["mask"], plain["mask"])
    for b in range(2):
        _assert_same_but_ties({k: v[b].cpu() for k, v in kernel.items()},
                              {k: v[b].cpu() for k, v in plain.items()})


def _assert_same_but_ties(ours, ref, tie=1e-5):
    """Slot by slot, apart from slots whose reference score lies within
    ``tie`` of a neighbour's: those must hold an equally scored entry."""
    kept = torch.nonzero(ref["mask"])[:, 0].tolist()
    assert kept
    for k in kept:
        same = (int(ours["classes"][k]) == int(ref["classes"][k])
                and torch.allclose(ours["boxes"][k], ref["boxes"][k], rtol=1e-5, atol=1e-3))
        close = abs(float(ours["scores"][k] - ref["scores"][k])) <= tie
        if same and close:
            continue
        gaps = (ref["scores"][kept] - ref["scores"][k]).abs()
        assert close and float(gaps.sort().values[1]) <= tie, f"slot {k} differs"


def _batch_inputs(gen, dev, n=3, hw=40, c=256, r=301):
    feats = torch.rand((n, hw, hw, c), generator=gen).to(dev)
    xy = torch.rand((r, 2), generator=gen) * (hw + 8) - 4
    wh = torch.rand((r, 2), generator=gen) * 30
    boxes = torch.cat([xy, xy + wh], 1).to(dev)
    idx = torch.randint(0, n, (r,), generator=gen, dtype=torch.int32).to(dev)
    return feats, boxes, idx


@pytest.mark.parametrize("c", [8, 6])
@pytest.mark.parametrize("out_size,s", [(7, 2), (4, 1), (14, 2)])
def test_bf16_kernel_equals_plain_at_the_borders(cuda_device, out_size, s, c):
    gen = torch.Generator().manual_seed(c)
    feats = torch.rand((1, 20, 24, c), generator=gen).to(cuda_device).bfloat16()
    boxes = torch.tensor(BOXES, device=cuda_device)
    idx = torch.zeros(len(BOXES), dtype=torch.int32, device=cuda_device)
    before = tra.LAUNCHES["roi_align_bf16"]
    out = tra.roi_align(feats, boxes, idx, out_size, s)
    ref = tra.roi_align_plain(feats, boxes, idx, out_size, s)
    torch.cuda.synchronize()
    assert tra.LAUNCHES["roi_align_bf16"] == before + 1
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def test_bf16_kernel_equals_plain_over_a_batch(cuda_device):
    feats, boxes, idx = _batch_inputs(torch.Generator().manual_seed(3), cuda_device)
    feats = feats.bfloat16()
    out = tra.roi_align(feats, boxes, idx, 14, 2)
    ref = torch.cat([tra.roi_align_plain(feats, boxes[k:k + 64], idx[k:k + 64], 14, 2)
                     for k in range(0, len(boxes), 64)])
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _assert_backward_agrees(feats, boxes, idx, out_size, s, gen):
    dout = (torch.rand((len(boxes), out_size, out_size, feats.shape[-1]), generator=gen)
            * 2 - 1).to(feats.device, feats.dtype)
    f = feats.detach().clone().requires_grad_(True)
    before = tra.LAUNCHES["roi_align_backward"]
    tra.roi_align(f, boxes, idx, out_size, s).backward(dout)
    ref = tra.roi_align_backward_plain(dout, boxes, idx, feats.shape, feats.dtype, out_size, s)
    terms = tra.roi_align_backward_plain(dout.abs(), boxes, idx, feats.shape, torch.float32,
                                         out_size, s).double()
    torch.cuda.synchronize()
    assert tra.LAUNCHES["roi_align_backward"] == before + 1
    assert f.grad.dtype == feats.dtype and f.grad.shape == feats.shape
    bound = 1e-5 * terms + 1e-6
    if feats.dtype == torch.bfloat16:
        _, e = torch.frexp(ref.double())
        bound = bound + torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(bound), e - 8))
    err = (f.grad.double() - ref.double()).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 6])
@pytest.mark.parametrize("out_size,s", [(7, 2), (4, 1), (14, 2)])
def test_backward_agrees_with_plain_at_the_borders(cuda_device, out_size, s, c, dtype):
    gen = torch.Generator().manual_seed(c + s)
    feats = torch.rand((1, 20, 24, c), generator=gen).to(cuda_device, dtype)
    boxes = torch.tensor(BOXES, device=cuda_device)
    idx = torch.zeros(len(BOXES), dtype=torch.int32, device=cuda_device)
    _assert_backward_agrees(feats, boxes, idx, out_size, s, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_agrees_over_a_batch(cuda_device, dtype):
    gen = torch.Generator().manual_seed(4)
    feats, boxes, idx = _batch_inputs(gen, cuda_device, r=97)
    _assert_backward_agrees(feats.to(dtype), boxes, idx, 14, 2, gen)


def test_out_of_range_image_takes_no_gradient(cuda_device):
    feats = torch.rand((2, 8, 8, 4), device=cuda_device, requires_grad=True)
    boxes = torch.tensor([[1.0, 1.0, 5.0, 5.0]] * 2, device=cuda_device)
    idx = torch.tensor([2, -1], dtype=torch.int32, device=cuda_device)
    tra.roi_align(feats, boxes, idx, 4, 2).sum().backward()
    torch.cuda.synchronize()
    assert not feats.grad.any()


def test_no_gradient_runs_no_backward(cuda_device):
    feats = torch.rand((1, 8, 8, 4), device=cuda_device, requires_grad=True)
    boxes = torch.tensor([[1.0, 1.0, 5.0, 5.0]], device=cuda_device)
    before = dict(tra.LAUNCHES)
    with torch.no_grad():
        out = tra.roi_align(feats, boxes, None, 4, 2)
    assert not out.requires_grad
    assert tra.LAUNCHES["roi_align"] == before["roi_align"] + 1
    assert tra.LAUNCHES["roi_align_backward"] == before["roi_align_backward"]


# the edge boxes on a 20 x 24 map: as wide as the map, sub-pixel, and past
# each edge (left, top, right, bottom, all four)
EDGE_BOXES = [
    [0.0, 2.0, 24.0, 18.0],
    [3.3, 4.1, 3.55, 4.3],
    [10.0, 10.0, 10.2, 10.9],
    [-6.0, 3.0, 4.0, 9.0],
    [5.0, -7.0, 11.0, 2.0],
    [19.0, 5.0, 31.0, 12.0],
    [2.0, 15.0, 9.0, 27.0],
    [-5.0, -5.0, 29.0, 25.0],
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,vec", [(8, None), (12, 4), (6, 1)])
@pytest.mark.parametrize("out_size,s", [(14, 2), (7, 4), (4, 1), (5, 3)])
def test_forward_equals_plain_at_each_width(cuda_device, out_size, s, c, vec, dtype):
    gen = torch.Generator().manual_seed(c * 16 + s)
    feats = torch.rand((2, 20, 24, c), generator=gen).to(cuda_device, dtype)
    boxes = torch.tensor(BOXES + EDGE_BOXES, device=cuda_device)
    idx = (torch.arange(len(boxes), device=cuda_device) % 2).to(torch.int32)
    want = vec or (8 if dtype == torch.bfloat16 else 4)
    assert tra._vec(c, feats, widest=16 // feats.element_size()) == want
    key = "roi_align_bf16" if dtype == torch.bfloat16 else "roi_align"
    before = tra.LAUNCHES[key]
    out = tra.roi_align(feats, boxes, idx, out_size, s)
    ref = tra.roi_align_plain(feats, boxes, idx, out_size, s)
    torch.cuda.synchronize()
    assert tra.LAUNCHES[key] == before + 1
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_range_image_pools_zeros_at_16_bytes(cuda_device, dtype):
    feats = torch.rand((2, 8, 8, 16), device=cuda_device).to(dtype)
    boxes = torch.tensor([[1.0, 1.0, 5.0, 5.0]] * 3, device=cuda_device)
    idx = torch.tensor([0, 2, -1], dtype=torch.int32, device=cuda_device)
    out = tra.roi_align(feats, boxes, idx, 7, 4)
    ref = tra.roi_align_plain(feats, boxes[:1], idx[:1], 7, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[:1], ref) and not out[1:].any()
