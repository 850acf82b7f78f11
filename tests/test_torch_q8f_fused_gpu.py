"""The q8f_fused CUDA kernel (K2) on a card (marked gpu; each test skips
without one).

Imports only torch, numpy and tspn_tpu_torch, so it runs where h5py and
flax are absent: ``python -m pytest tests/test_torch_q8f_fused_gpu.py -q``.

* The kernel equals its plain PyTorch version bit for bit at the four
  geometries of ``chip_smoke.py``: the serve geometry (16 x 992 rows,
  N 32, canonical pairs), a ragged row count, the PPN-pruned geometry
  (16 x 256 rows, random pairs) and pairs with out-of-range indices.
* The wrapper raises on operands the kernel does not take.
* PPN-pruned q8f serving selects the same top-k with the kernels as with
  the plain versions, launching q8s and q8f_fused once per batch each.
"""

import pytest
import torch

from tspn_tpu_torch.ops import pairwise as tpw

pytestmark = pytest.mark.gpu

# (segments, rows per segment, tracklets N, pairs)
CASES = {
    "serve": (16, 992, 32, "canonical"),
    "ragged": (7, 333, 19, "random"),
    "pruned": (16, 256, 32, "random"),
    "out_of_range": (16, 256, 32, "outside"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the q8f_fused kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(bsz, p, n, kind, device, r=132, seed=5):
    gen = torch.Generator().manual_seed(seed)
    d = tpw.rel_geom().device_dim
    x = torch.randint(-127, 128, (bsz, p, d), generator=gen, dtype=torch.int8)
    x[:, -5:] = 0
    s = torch.rand((bsz, p), generator=gen) / 64
    if kind == "canonical":
        sub, obj = torch.nonzero(~torch.eye(n, dtype=torch.bool), as_tuple=True)
        pairs = torch.zeros((bsz, p, 2), dtype=torch.int32)
        pairs[:, : sub.numel()] = torch.stack([sub, obj], -1).to(torch.int32)
    else:
        pairs = torch.randint(0, n, (bsz, p, 2), generator=gen, dtype=torch.int32)
        if kind == "outside":
            pairs[:, ::7, 0] = n + 3
            pairs[:, 1::5, 1] = -1
    qw_t = torch.randint(-127, 128, (r, d), generator=gen, dtype=torch.int8)
    sw = torch.rand((r,), generator=gen) / 127
    b = torch.randn((r,), generator=gen)
    a = torch.randn((bsz, n, 2 * r), generator=gen) * 4
    return [t.to(device) for t in (x, s, pairs, qw_t, sw, b, a)]


@pytest.mark.parametrize("name", list(CASES))
def test_q8f_fused_kernel_equals_plain(cuda_device, name):
    bsz, p, n, kind = CASES[name]
    args = _inputs(bsz, p, n, kind, cuda_device)
    before = tpw.LAUNCHES["q8f_fused"]
    out = tpw.q8f_fused(*args)
    ref = tpw.factored_classify_q8_fused_plain(*args)
    torch.cuda.synchronize()
    assert tpw.LAUNCHES["q8f_fused"] == before + 1
    assert out.shape == (bsz, p, 132) and torch.equal(out, ref)


def test_q8f_fused_kernel_rejects_bad_operands(cuda_device):
    x, s, pairs, qw_t, sw, b, a = _inputs(2, 40, 6, "random", cuda_device)
    with pytest.raises(TypeError):
        tpw.q8f_fused(x, s, pairs.long(), qw_t, sw, b, a)
    with pytest.raises(TypeError):
        tpw.q8f_fused(x.float(), s, pairs, qw_t, sw, b, a)
    with pytest.raises(ValueError):
        tpw.q8f_fused(x, s, pairs, qw_t, sw, b, a[:, :, 1:])
    with pytest.raises(ValueError):
        tpw.q8f_fused(x, s.cpu(), pairs, qw_t, sw, b, a)
    with pytest.raises(ValueError):
        tpw.q8f_fused(x[..., 1:], s, pairs, qw_t[:, 1:], sw, b, a)


def test_pruned_serve_kernel_matches_plain(cuda_device):
    from tspn_tpu_torch.data.loader import BucketedLoader
    from tspn_tpu_torch.data.synthetic import synthetic_segments
    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.predict import predict_segments

    dataset = synthetic_segments(9, "q8f", seed=1, max_tracklets=12)
    kw = dict(buckets=(4, 8, 12), batch_size=2, topk_per_pair=20, topk_per_seg=200,
              num_pair_proposals=30)
    model = build_model(use_ppn=True, seed=0).to(cuda_device).eval()
    batches = len(BucketedLoader(dataset, kw["buckets"], kw["batch_size"],
                                 dataset.feature_width(), 35))
    tpw.reset_launches()
    out = predict_segments(model, dataset, device=cuda_device, **kw)
    ref = predict_segments(model, dataset, device=cuda_device, plain=True, **kw)
    assert tpw.LAUNCHES == {"q8s": batches, "fused_classify": 0, "q8f_fused": batches,
                            "q8i8": 0, "q8bf": 0, "q8t": 0, "q8_probe": 0,
                            "fused_classify_bf16": 0}

    def selection(res):
        return {k: sorted((-float(s), tuple(i.tolist()), int(t[1]))
                          for s, t, i in v[0]) for k, v in res.items()}

    assert selection(out) == selection(ref)
