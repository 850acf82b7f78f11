"""The fused_classify CUDA kernel on a card (marked gpu; each test skips
without one).

Imports only torch, numpy and tspn_tpu_torch, so it runs where h5py and
flax are absent: ``python -m pytest tests/test_torch_fused_classify_gpu.py -q``.

* The kernel (three-pass TF32 wgmma, csrc/fused_classify.cu) agrees with
  its plain PyTorch version within
  ``|kernel - plain| <= 1e-5 * (|N(x)| @ |W| + |b|) + 1e-6`` per element,
  at ragged row counts, at both layouts (C 35 and C 80), at R = 132, at
  R = 12 and at an R that takes three column tiles. The two sum in
  different orders (the kernel on the tensor cores, folded per unit in
  f32; the plain version through the cuBLAS f32 GEMM with TF32 off), so
  the bound is relative to the magnitude of the summed terms.
* Split and unsplit plans (``fused_plan``): P = 1, 63, 65, 129 and a
  ragged 7,923 (cut into pieces of D and folded by the second kernel) and
  the serve geometry's 15,872 rows (one block a tile), each within the
  bound with zero rows and a zero BoW block, and a split call repeats bit
  for bit.
* A call after W changed in place (a training step) follows the new W.
* The wrapper sends bf16 rows to K3's bf16 half (one launch of
  ``fused_classify_bf16``; tests/test_torch_bf16_gpu.py holds it), and
  raises on bf16 weights under f32 rows, on non-contiguous inputs and on a
  width that does not fit the layout.
* The training op's dW and db agree whether its forward is the kernel or
  the plain version, and the kernel launches once per forward.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.ops import pairwise as tpw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_classify kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(layout, p, r, device, seed=3):
    """Raw device-layout rows: a normal head, sparse non-negative BoW
    counts, one row with a zero block, and five zero padding rows."""
    rng = np.random.RandomState(seed)
    d, hp = layout.device_dim, layout.dev_head_pad
    x = np.zeros((p, d), np.float32)
    x[:, : layout.dev_head_dim] = rng.randn(p, layout.dev_head_dim)
    bow = rng.randint(0, 6, size=(p, d - hp)) * (rng.rand(p, d - hp) < 0.05)
    x[:, hp:] = bow
    for k in range(layout.num_bow_blocks):  # slot padding stays zero
        lo = hp + k * layout.dev_block + layout.bow_block_size
        x[:, lo : hp + (k + 1) * layout.dev_block] = 0
    x[0, hp : hp + layout.dev_block] = 0
    x[-5:] = 0
    w = (rng.randn(d, r) * 0.01).astype(np.float32)
    b = rng.randn(r).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, w, b)]


def _bound(x, w, b, layout):
    """1e-5 * (|N(x)| @ |W| + |b|) + 1e-6, in float64."""
    xn = tpw._normalize_device_layout(x.double(), layout).abs()
    return 1e-5 * (xn @ w.double().abs() + b.double().abs()) + 1e-6


@pytest.mark.parametrize("c,r,p", [(35, 132, 1037), (80, 132, 777), (35, 12, 300),
                                   (80, 300, 130)])
def test_fused_kernel_within_bound(cuda_device, c, r, p):
    layout = FeatureLayout.for_objects(c)
    x, w, b = _inputs(layout, p, r, cuda_device)
    before = tpw.LAUNCHES["fused_classify"]
    out = tpw.normalize_classify_fused_forward(x, w, b, layout)
    ref = tpw.normalize_classify_fused_plain(x, w, b, layout)
    torch.cuda.synchronize()
    assert tpw.LAUNCHES["fused_classify"] == before + 1
    assert out.shape == (p, r) and torch.isfinite(out).all()
    err = (out.double() - ref.double()).abs()
    assert bool((err <= _bound(x, w, b, layout)).all()), float(err.max())
    # zero padding rows score the bias alone
    assert torch.equal(out[-5:], b.expand(5, r))


def test_fused_kernel_rejects_bad_operands(cuda_device):
    layout = FeatureLayout()
    x, w, b = _inputs(layout, 64, 8, cuda_device)
    # bf16 rows are no longer refused: they launch K3's bf16 half
    before = tpw.LAUNCHES["fused_classify_bf16"]
    out = tpw.normalize_classify_fused_forward(x.bfloat16(), w, b, layout)
    assert out.dtype == torch.float32 and out.shape == (64, w.shape[1])
    assert tpw.LAUNCHES["fused_classify_bf16"] == before + 1
    with pytest.raises(TypeError):
        tpw.normalize_classify_fused_forward(x, w.bfloat16(), b, layout)
    wide = torch.zeros((64, 2 * layout.device_dim), device=cuda_device)
    wide[:, ::2] = x
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_forward(wide[:, ::2], w, b, layout)
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_forward(x, w, b, FeatureLayout.for_objects(80))
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_forward(x, w.cpu(), b, layout)


def test_nofeatgrad_grads_kernel_vs_plain(cuda_device):
    layout = FeatureLayout()
    x, w, b = _inputs(layout, 400, 132, cuda_device)
    g = torch.randn((400, 132), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    grads = []
    for plain in (False, True):
        w_ = w.clone().requires_grad_(True)
        b_ = b.clone().requires_grad_(True)
        before = tpw.LAUNCHES["fused_classify"]
        out = tpw.normalize_classify_fused_nofeatgrad(x, w_, b_, layout, plain)
        (out * g).sum().backward()
        assert tpw.LAUNCHES["fused_classify"] - before == (0 if plain else 1)
        grads.append((w_.grad, b_.grad))
    # the backward is the same plain code on the same inputs
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


# (objects C, outputs R, rows P): P 1, 63, 65, 129 and a ragged 7,923 (split
# plans) and the serve geometry's 16 x 992 rows (unsplit), VidVRD and VidOR
PLAN_CASES = [(35, 132, 1), (35, 132, 63), (35, 132, 65), (35, 12, 129), (80, 132, 129),
              (35, 132, 7923), (80, 12, 7923), (35, 132, 16 * 992)]


@pytest.mark.parametrize("c,r,p", PLAN_CASES)
def test_fused_kernel_plans_within_bound(cuda_device, c, r, p):
    layout = FeatureLayout.for_objects(c)
    x, w, b = _inputs(layout, p, r, cuda_device, seed=p)
    plan = tpw.fused_plan(p, r, layout,
                          torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert plan.split == (p < 16 * 992)
    out = tpw.normalize_classify_fused_forward(x, w, b, layout)
    again = tpw.normalize_classify_fused_forward(x, w, b, layout)
    ref = tpw.normalize_classify_fused_plain(x, w, b, layout)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err = (out.double() - ref.double()).abs()
    assert bool((err <= _bound(x, w, b, layout)).all()), float(err.max())


def test_fused_kernel_follows_weights_changed_in_place(cuda_device):
    """A training step changes W in place; the next call prepares W's TF32
    halves from the new values."""
    layout = FeatureLayout()
    x, w, b = _inputs(layout, 300, 132, cuda_device)
    first = tpw.normalize_classify_fused_forward(x, w, b, layout)
    with torch.no_grad():
        w.mul_(-2.0)
    out = tpw.normalize_classify_fused_forward(x, w, b, layout)
    ref = tpw.normalize_classify_fused_plain(x, w, b, layout)
    torch.cuda.synchronize()
    assert not torch.equal(out, first)
    err = (out.double() - ref.double()).abs()
    assert bool((err <= _bound(x, w, b, layout)).all()), float(err.max())
