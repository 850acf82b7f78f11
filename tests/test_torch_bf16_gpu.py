"""K3's bf16 half (``csrc/fused_classify_bf16.cu``) and the bf16 relation
model on a card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_bf16_gpu.py -q``.

* The kernel agrees with its plain version within ``1e-5 * T + 2**-8 * M``
  (T the summed |terms| of an output plus |b|, M its largest |term|) at
  ragged row counts, both layouts (C 35, C 80), R 132 and an R of three
  column tiles, with zero rows (which score b exactly) and zero blocks;
  at most 0.1% of the outputs need the second term (a normalized value
  near a bf16 midpoint, rounded one ulp apart after sums in two orders).
* The wrapper raises on f32 weights given as prepared bf16 weights, on
  misaligned or non-contiguous rows and on a width that does not fit the
  layout.
* A bf16 fused model: serving launches the kernel once per batch and
  selects what its plain version selects apart from near-ties; training
  steps with the kernel and with the plain version give the same losses
  within rtol 1e-3 and launch once per step; an unfused bf16 model trains
  too (its logits are bf16, its parameters stay f32).
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.data.synthetic import synthetic_segments
from tspn_tpu_torch.models.tspn import build_model
from tspn_tpu_torch.ops import pairwise as tpw
from tspn_tpu_torch.runtime.predict import predict_segments
from tspn_tpu_torch.runtime.train import train_segments

pytestmark = pytest.mark.gpu
BF16 = torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_classify_bf16 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(layout, p, r, device, seed=3):
    rng = np.random.RandomState(seed)
    d, hp = layout.device_dim, layout.dev_head_pad
    x = np.zeros((p, d), np.float32)
    x[:, : layout.dev_head_dim] = rng.randn(p, layout.dev_head_dim)
    for k in range(layout.num_bow_blocks):
        lo = hp + k * layout.dev_block
        x[:, lo : lo + layout.bow_block_size] = (
            rng.randint(1, 6, (p, layout.bow_block_size))
            * (rng.rand(p, layout.bow_block_size) < 0.05))
    x[0, hp : hp + layout.dev_block] = 0
    x[1, hp:] = 0
    x[-5:] = 0
    w = (rng.randn(d, r) * 0.01).astype(np.float32)
    b = rng.randn(r).astype(np.float32)
    x, w, b = (torch.from_numpy(a).to(device) for a in (x, w, b))
    return x.to(BF16), tpw.weights_bf16_t(w), b


def _terms(x, w_t, b, layout):
    """(T, M) in float64: the summed and the largest |term| of each output."""
    p = x.shape[0]
    hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
    bow = x[:, hp:].float().reshape(p, nb, blk)
    s = bow.abs().sum(-1, keepdim=True)
    n = (bow / torch.where(s > 0, s, torch.ones_like(s))).to(BF16).reshape(p, -1)
    xn = torch.cat([x[:, :hp], n], 1).double().abs()
    wa = w_t.double().abs().T
    m = torch.stack([(xn[:, :, None] * wa[None, :, j : j + 1]).amax(1)[:, 0]
                     for j in range(wa.shape[1])], 1)
    return xn @ wa + b.double().abs(), m


@pytest.mark.parametrize("c,r,p", [(35, 132, 1037), (80, 132, 777), (35, 300, 130)])
def test_k3_bf16_kernel_within_bound(cuda_device, c, r, p):
    layout = FeatureLayout.for_objects(c)
    x, w_t, b = _inputs(layout, p, r, cuda_device)
    before = tpw.LAUNCHES["fused_classify_bf16"]
    out = tpw.normalize_classify_fused_bf16(x, w_t, b, layout)
    ref = tpw.normalize_classify_fused_bf16_plain(x, w_t, b, layout)
    torch.cuda.synchronize()
    assert tpw.LAUNCHES["fused_classify_bf16"] == before + 1
    assert out.dtype == torch.float32 and out.shape == (p, r)
    t, m = _terms(x, w_t, b, layout)
    err = (out.double() - ref.double()).abs()
    assert bool((err <= 1e-5 * t + 2.0 ** -8 * m).all()), float((err / (1e-5 * t + 2.0 ** -8 * m)).max())
    assert float((err > 1e-5 * t).double().mean()) <= 1e-3
    assert torch.equal(out[-5:], b.expand(5, r))


def test_k3_bf16_wrapper_rejects_bad_operands(cuda_device):
    layout = FeatureLayout()
    x, w_t, b = _inputs(layout, 64, 8, cuda_device)
    with pytest.raises(TypeError):
        tpw.normalize_classify_fused_bf16(x, w_t.float(), b, layout)
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_bf16(x[:, 1:].contiguous(), w_t[:, 1:].contiguous(),
                                          b, layout)
    wide = torch.zeros((64, 2 * layout.device_dim), dtype=BF16, device=cuda_device)
    wide[:, ::2] = x
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_bf16(wide[:, ::2], w_t, b, layout)
    with pytest.raises(ValueError):
        tpw.normalize_classify_fused_bf16(x, w_t, b, FeatureLayout.for_objects(80))


def _model(fused, inference, dev, seed=0):
    model = build_model(12, fused_classifier=fused, inference=inference, dtype=BF16, seed=seed)
    with torch.no_grad():  # an informative classifier, so scores spread
        for p in model.parameters():
            p.mul_(30.0)
    return model.to(dev)


def test_bf16_fused_serve_kernel_vs_plain(cuda_device):
    ds = synthetic_segments(12, "f32dev", seed=1, max_tracklets=12, num_predicates=12)
    kw = dict(buckets=(4, 8, 12), batch_size=4, topk_per_pair=5, topk_per_seg=40,
              num_objects=35)
    model = _model(True, True, cuda_device).eval()
    tpw.reset_launches()
    out = predict_segments(model, ds, device=cuda_device, **kw)
    launched = tpw.LAUNCHES["fused_classify_bf16"]
    ref = predict_segments(model, ds, device=cuda_device, plain=True, **kw)
    assert launched > 0 and tpw.LAUNCHES["fused_classify_bf16"] == launched
    assert tpw.LAUNCHES["fused_classify"] == 0
    assert set(out) == set(ref) and out
    for key in ref:
        a = sorted(float(s) for s, _t, _i in out[key][0])
        e = sorted(float(s) for s, _t, _i in ref[key][0])
        np.testing.assert_allclose(a, e, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_training_kernel_vs_plain(cuda_device, fused):
    from types import SimpleNamespace as NS

    ds = synthetic_segments(8, "f32dev" if fused else "f32", seed=2, max_tracklets=10,
                            num_predicates=12)
    solver = NS(BASE_LR=1e-2, BIAS_LR_FACTOR=2, WEIGHT_DECAY=5e-4, WEIGHT_DECAY_BIAS=0.0,
                OPTIMIZER=NS(TYPE="adam", MOMENTUM=0.9),
                SCHEDULER=NS(TYPE="warmup_multi", MILESTONES=[4, 6], GAMMA=0.1,
                             WARMUP_FACTOR=1.0 / 3, WARMUP_ITERS=2, WARMUP_METHOD="linear"))
    runs = {}
    for plain in (True, False):
        model = build_model(12, ds.feature_width(), fused_classifier=fused, dtype=BF16,
                            seed=4).to(cuda_device)
        tpw.reset_launches()
        runs[plain] = train_segments(model, ds, solver=solver, max_iter=6, device=cuda_device,
                                     buckets=(4, 8, 10), batch_size=2, plain=plain)
        assert tpw.LAUNCHES["fused_classify_bf16"] == (6 if fused and not plain else 0)
        assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    np.testing.assert_allclose(runs[False].losses, runs[True].losses, rtol=1e-3)
    assert runs[False].losses[-1] < runs[False].losses[0]
