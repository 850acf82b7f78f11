"""The q8s CUDA kernel on a card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch, so it runs where h5py and
flax are absent: ``python -m pytest tests/test_torch_q8s_gpu.py -q``.

* The kernel equals its plain PyTorch version bit for bit at the serve
  path's three geometries, with a ragged row count and zero rows.
* K1 and K6 (csrc/q8s_sm90.cu) equal their plain versions bit for bit,
  and K6 equals K1 transposed, at the six geometries of the port (tool,
  rel, tracklet, expanded, ragged, VidOR), at segments that end on 64
  but not 128 bytes, at K6's unshifted word staging and at one row of an
  odd R, each as q8s_plan cuts it, split into pieces and unsplit.
* The wrapper raises on operands the kernel does not take.
* predict_segments selects the same top-k with the kernels as with the
  plain versions, launching q8s once per batch for q8f (its tracklet
  pass; q8f_fused scores the rel rows) and once for q8.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.ops import pairwise as tpw

pytestmark = pytest.mark.gpu

GEOMS = {
    "tracklet": (tpw.tracklet_geom(), 264),
    "rel": (tpw.rel_geom(), 132),
    "expanded": (tpw.BlockGeom(3072, 8, 1024), 132),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the q8s kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(geom, p, r, device, seed=4):
    rng = np.random.RandomState(seed)
    d = geom.device_dim
    q = rng.randint(-127, 128, size=(p, d)).astype(np.int8)
    q[-5:] = 0  # padded batch rows are all-zero
    scales = np.zeros((p, 16), np.float32)
    scales[:, : 1 + geom.num_bow_blocks] = rng.rand(p, 1 + geom.num_bow_blocks) / 50
    qw_t = rng.randint(-127, 128, size=(r, d)).astype(np.int8)
    sw = (rng.rand(r) / 127).astype(np.float32)
    b = rng.randn(r).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, scales, qw_t, sw, b)]


EXPANDED = tpw.BlockGeom(3072, 8, 1024)
# (rows P, outputs R, geometry)
SIX = {
    "tool": (96 * 992, 132, EXPANDED),
    "rel": (96 * 992 - 29, 132, tpw.rel_geom()),
    "tracklet": (3072 - 7, 264, tpw.tracklet_geom()),
    "expanded": (4096 - 13, 132, EXPANDED),
    "ragged": (96 * 992 - 77, 132, EXPANDED),
    "vidor": (333, 132, None),
    "odd64": (1037, 132, tpw.BlockGeom(192, 2, 320)),  # segments end on 64 bytes
    "word": (1036, 132, EXPANDED),  # K6's rows by unshifted word loads (P % 4 == 0)
    "tiny": (1, 7, tpw.rel_geom()),  # one row, an odd R (no 8-byte stores)
}
CHUNK = 8192  # rows per plain call: a float64 copy of 95k x 11264 is 8.6 GB


def _forced(split: bool):
    """q8s_plan with the split forced on (a middle one of the cuts the
    planner weighs, segments cut into several shares where they are long
    enough) or off (whole segments)."""
    plan = tpw.q8s_plan

    def forced(p, r, d, geom, sms, transposed=False):
        base = plan(p, r, d, geom, sms, transposed)
        chunks = [-(-(hi - lo) // tpw.Q8S_CHUNK) for lo, hi in base.segments]
        if not split:
            pieces = tuple((k, 0, c) for k, c in enumerate(chunks))
            return base._replace(pieces=pieces, split=False, grid=min(base.tiles, sms))
        cuts = list(tpw._q8s_cuts(chunks))
        pieces = cuts[len(cuts) // 2][1]
        return base._replace(pieces=pieces, split=True,
                             grid=min(base.tiles * len(pieces), sms))

    return forced


@pytest.mark.parametrize("cut", ["plan", "split", "unsplit"])
@pytest.mark.parametrize("name", list(SIX))
def test_q8s_and_q8t_equal_plain(cuda_device, monkeypatch, name, cut):
    from tspn_tpu_torch.data.layout import FeatureLayout

    p, r, geom = SIX[name]
    geom = geom or FeatureLayout.for_objects(80)
    if cut != "plan":
        monkeypatch.setattr(tpw, "q8s_plan", _forced(cut == "split"))
    gen = torch.Generator(cuda_device).manual_seed(1)
    d = geom.device_dim
    q = torch.randint(-128, 128, (p, d), generator=gen, device=cuda_device, dtype=torch.int8)
    q[-5:] = 0  # padded batch rows are all-zero
    scales = torch.rand((p, 16), generator=gen, device=cuda_device) / 64
    qw_t = torch.randint(-128, 128, (r, d), generator=gen, device=cuda_device, dtype=torch.int8)
    sw = torch.rand((r,), generator=gen, device=cuda_device) / 127
    b = torch.randn((r,), generator=gen, device=cuda_device)
    xt, scales_t = q.T.contiguous(), scales.T.contiguous()
    before = (tpw.LAUNCHES["q8s"], tpw.LAUNCHES["q8t"])
    k1 = tpw.normalize_classify_q8s(q, scales, qw_t, sw, b, geom)
    k6 = tpw.normalize_classify_q8t(xt, scales_t, qw_t, sw, b, geom)
    torch.cuda.synchronize()
    assert (tpw.LAUNCHES["q8s"], tpw.LAUNCHES["q8t"]) == (before[0] + 1, before[1] + 1)
    ref = torch.cat([tpw.normalize_classify_q8s_plain(q[a:a + CHUNK], scales[a:a + CHUNK],
                                                      qw_t, sw, b, geom)
                     for a in range(0, p, CHUNK)])
    assert k1.shape == (p, r) and torch.equal(k1, ref)
    assert k6.shape == (r, p) and torch.equal(k6, ref.T)
    del ref
    ref_t = torch.cat([tpw.normalize_classify_q8t_plain(xt[:, a:a + CHUNK],
                                                        scales_t[:, a:a + CHUNK], qw_t, sw, b,
                                                        geom)
                       for a in range(0, p, CHUNK)], dim=1)
    assert torch.equal(k6, ref_t)


@pytest.mark.parametrize("name", list(GEOMS))
def test_q8s_kernel_equals_plain(cuda_device, name):
    geom, r = GEOMS[name]
    args = _inputs(geom, 1000 + 37, r, cuda_device)
    before = tpw.LAUNCHES["q8s"]
    out = tpw.normalize_classify_q8s(*args, geom)
    ref = tpw.normalize_classify_q8s_plain(*args, geom)
    torch.cuda.synchronize()
    assert tpw.LAUNCHES["q8s"] == before + 1
    assert out.shape == (1037, r) and torch.equal(out, ref)


def test_q8s_kernel_rejects_bad_operands(cuda_device):
    geom = tpw.rel_geom()
    q, scales, qw_t, sw, b = _inputs(geom, 64, 8, cuda_device)
    with pytest.raises(TypeError):
        tpw.normalize_classify_q8s(q.float(), scales, qw_t, sw, b, geom)
    with pytest.raises(ValueError):
        tpw.normalize_classify_q8s(q, scales, qw_t, sw, b, tpw.tracklet_geom())
    with pytest.raises(ValueError):
        tpw.normalize_classify_q8s(q, scales, qw_t.cpu(), sw, b, geom)
    with pytest.raises(ValueError):
        tpw.normalize_classify_q8s(q[:, 1:], scales, qw_t, sw, b, geom)


@pytest.mark.parametrize("mode,per_batch", [("q8f", 2), ("q8", 1)])
def test_serve_kernel_matches_plain(cuda_device, mode, per_batch):
    """``per_batch`` counts the launches of every kernel per batch."""
    from tspn_tpu_torch.data.loader import BucketedLoader
    from tspn_tpu_torch.data.synthetic import synthetic_segments
    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.predict import predict_segments

    dataset = synthetic_segments(9, mode, seed=1, max_tracklets=12)
    kw = dict(buckets=(4, 8, 12), batch_size=2, topk_per_pair=20, topk_per_seg=200)
    model = build_model(seed=0).to(cuda_device).eval()
    batches = len(BucketedLoader(dataset, kw["buckets"], kw["batch_size"],
                                 dataset.feature_width(), 35))
    tpw.reset_launches()
    out = predict_segments(model, dataset, device=cuda_device, **kw)
    assert sum(tpw.LAUNCHES.values()) == per_batch * batches
    ref = predict_segments(model, dataset, device=cuda_device, plain=True, **kw)
    assert sum(tpw.LAUNCHES.values()) == per_batch * batches
    assert tpw.LAUNCHES["q8s"] == batches

    def selection(res):
        return {k: sorted((-float(s), tuple(i.tolist()), int(t[1]))
                          for s, t, i in v[0]) for k, v in res.items()}

    assert selection(out) == selection(ref)
