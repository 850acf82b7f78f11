"""The RoIAlign probe kernels (T-roi, ``csrc/roi_probes.cu``) and the two
ported tools on a card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_roi_probes_gpu.py -q``.

* ``roi_sep_fused``, ``roi_selector`` and ``roi_constg`` agree with their
  plain versions within ``1e-5 * T + 1e-6`` (T the summed |term| of each
  output; every weight is non-negative, so T is the function on |F|),
  plus one bf16 ulp of the plain value (``roi_common.bf16_ulp``) for a
  bf16 output, in f32 and bf16, at the tools' 40 x 40 maps with 1024
  channels, at a small 8 x 8 x 128 map with boxes across the border, and
  at the edges of the GEMM's stacked-row tiling (R = 1, R = 3, a 29 x 33
  map, C = 384, a 128 x 128 map), and for ``roi_sep_fused`` also at C = 96
  (32 x an odd number) and W = 112 (the widest it takes); each launches
  once.
* In f32, the fused and selector kernels agree with ``roi_align_plain``
  within the same bound.
* The wrappers raise on operands the kernels do not take.
* Both ported tools run at a small size and print their JSON line.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.ops import roi_probes as rp
from tspn_tpu_torch.tools import bench_roialign_fused, bench_roialign_variants, roi_common

pytestmark = pytest.mark.gpu
KERNELS = {"roi_sep_fused": (rp.roi_sep_fused, rp.roi_sep_fused_plain),
           "roi_selector": (rp.roi_selector, rp.roi_selector_plain),
           "roi_constg": (rp.roi_constg, rp.roi_constg_plain)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RoI probe kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, r, h, w, c, dev, seed=0):
    """(b, h, w, c) f32 maps and (b, r, 4) boxes, the first three of
    image 0 across the border (as many as r holds)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, h, w, c).astype(np.float32)
    lo = rng.uniform(0, [w - 2, h - 2], (b, r, 2))
    wh = rng.uniform(1, [w / 2, h / 2], (b, r, 2))
    boxes = np.concatenate([lo, lo + wh], axis=-1).astype(np.float32)
    border = [[-1.5, -1.0, 3.0, h + 1.0], [w - 2.0, h - 2.0, w + 4.0, h + 4.0],
              [-9.0, 2.0, -2.0, 5.0]]
    boxes[0, :3] = border[:min(r, 3)]
    return torch.from_numpy(feats).to(dev), torch.from_numpy(boxes).to(dev)


# (images, RoIs, H, W, C): the tools' 40 x 40 x 1024 with a ragged RoI count,
# a small map, then the edges of the stacked-row tiling: one RoI (a single
# partial 128-row tile), three (tiles straddling RoIs), a non-square map
# whose 8 x 8 blocks overhang (H * W not a multiple of the K chunk), C = 384
# (an odd count of 128-channel tiles) and the largest map taken
SHAPES = [(2, 37, 40, 40, 1024), (2, 8, 8, 8, 128), (1, 1, 40, 40, 1024), (2, 3, 16, 16, 256),
          (2, 5, 29, 33, 256), (2, 4, 16, 16, 384), (1, 4, 128, 128, 256)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_within_bound_of_plain(cuda_device, name, shape, dtype):
    feats32, boxes = _inputs(*shape, cuda_device)
    feats = feats32.to(roi_common.DTYPES[dtype])
    kernel, plain = KERNELS[name]
    if name == "roi_sep_fused" and shape[3] > 112:  # its (14, W, 32) intermediate
        with pytest.raises(ValueError):
            kernel(feats, boxes)
        return
    before = rp.LAUNCHES[name]
    out = kernel(feats, boxes)
    ref = plain(feats, boxes)
    torch.cuda.synchronize()
    assert rp.LAUNCHES[name] == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape == (*shape[:2], 14, 14, shape[4])
    if name == "roi_constg":
        terms = rp.roi_constg_plain(feats32.abs(), boxes).abs()
    else:
        terms = roi_common.sum_terms(feats32, boxes)
    bf16_out = out.dtype == torch.bfloat16
    assert roi_common.over_bound(out, ref, terms, 1e-5, ulp=bf16_out) <= 1.0
    if dtype == "f32" and name != "roi_constg":
        oracle = roi_common.oracle(feats32, boxes)
        assert roi_common.over_bound(out, oracle, terms, 1e-5) <= 1.0


# (images, RoIs, H, W, C) that only roi_sep_fused takes: C = 96, and W = 112
# on a tall map (8 RoIs a block: 13 RoIs leave the second block part empty)
SEP_SHAPES = [(2, 13, 24, 24, 96), (1, 3, 40, 112, 256), (1, 5, 128, 112, 64)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SEP_SHAPES)
def test_sep_fused_edges_within_bound_of_plain(cuda_device, shape, dtype):
    feats32, boxes = _inputs(*shape, cuda_device)
    feats = feats32.to(roi_common.DTYPES[dtype])
    before = rp.LAUNCHES["roi_sep_fused"]
    out = rp.roi_sep_fused(feats, boxes)
    ref = rp.roi_sep_fused_plain(feats, boxes)
    torch.cuda.synchronize()
    assert rp.LAUNCHES["roi_sep_fused"] == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape == (*shape[:2], 14, 14, shape[4])
    terms = roi_common.sum_terms(feats32, boxes)
    assert roi_common.over_bound(out, ref, terms, 1e-5, ulp=dtype == "bf16") <= 1.0


def test_wrappers_reject_bad_operands(cuda_device):
    feats, boxes = _inputs(1, 8, 8, 8, 128, cuda_device)
    with pytest.raises(TypeError):
        rp.roi_selector(feats.half(), boxes)
    with pytest.raises(ValueError):
        rp.roi_selector(feats[..., :96].contiguous(), boxes)
    with pytest.raises(ValueError):
        rp.roi_sep_fused(feats[..., :48].contiguous(), boxes)
    with pytest.raises(ValueError):
        rp.roi_constg(feats, boxes.cpu())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tools_run_on_the_card(cuda_device, dtype):
    small = ["--batch", "2", "--rois", "16", "--hw", "16", "--channels", "256",
             "--dtype", dtype]
    fused = bench_roialign_fused.main(small)
    assert fused["fused_ms"] > 0 and fused["fused_bound"]["bound_ms"] > 0
    variants = bench_roialign_variants.main(small)
    assert variants["selector_ms"] > 0 and variants["constg_library_ms"] > 0
    assert variants["grid_ms"] > 0 and variants["grid_bound"]["bound_ms"] > 0
