"""K4, K5, K6 and the int8 probe on a card (marked gpu; each test skips
without one).

Imports only torch, numpy and tspn_tpu_torch, so it runs where h5py and
flax are absent: ``python -m pytest tests/test_torch_q8_variants_gpu.py -q``.

* K4 (q8i8), K6 (q8t) and the probe equal their plain PyTorch versions
  bit for bit, K4 equals K1 fed the same block scales and K6 equals K1
  transposed, at the VidVRD and VidOR layouts with a ragged row count,
  zero rows and empty BoW blocks; each call launches its kernel once.
  The probe in all three modes also at 333 pairs (D split across blocks),
  1 pair, 4,096 pairs (x staged by TMA), 1,036 (aligned word loads) and
  at D 64 (one zero-padded chunk).
* K5 (q8bf) agrees with its plain version within
  1e-5 * (|q_h| @ |w_h| s + sum_k |q_k| @ |w_k| / L1_k + |b|) + 1e-6.
* The wrappers raise on a bad shape, dtype, alignment or mode.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.ops import pairwise as tpw

pytestmark = pytest.mark.gpu

R = 132


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4, K5, K6 and the probe have no CPU mode")
    return torch.device("cuda")


def _inputs(objects, p, device, seed=5):
    lo = FeatureLayout.for_objects(objects)
    rng = np.random.RandomState(seed)
    d, hp, blk = lo.device_dim, lo.dev_head_pad, lo.dev_block
    q = rng.randint(-128, 128, size=(p, d)).astype(np.int8)
    q[-5:] = 0
    q[::3, hp : hp + blk] = 0  # empty BoW block
    t = {k: torch.from_numpy(v).to(device) for k, v in {
        "q": q,
        "hs": (rng.rand(p) / 64).astype(np.float32),
        "qw_t": rng.randint(-127, 128, size=(R, d)).astype(np.int8),
        "sw": (rng.rand(R) / 127).astype(np.float32),
        "b": rng.randn(R).astype(np.float32),
        "w_probe": rng.randint(-128, 128, size=(160, d)).astype(np.int8),
    }.items()}
    t["w_bf16_t"] = tpw.weights_bf16_t(rng.randn(d, R).astype(np.float32) * 0.01).to(device)
    t["scales"] = tpw.q8_block_scales(t["q"], t["hs"], lo)
    t["xt"] = t["q"].T.contiguous()
    t["scales_t"] = t["scales"].T.contiguous()
    return lo, t


def _launched(key, fn):
    before = tpw.LAUNCHES[key]
    out = fn()
    torch.cuda.synchronize()
    assert tpw.LAUNCHES[key] == before + 1
    return out


@pytest.mark.parametrize("objects,p", [(35, 1037), (35, 1024), (80, 333)])
def test_q8i8_and_q8t_equal_plain_and_k1(cuda_device, objects, p):
    lo, t = _inputs(objects, p, cuda_device)
    k4 = _launched("q8i8", lambda: tpw.normalize_classify_q8i8(
        t["q"], t["hs"], t["qw_t"], t["sw"], t["b"], lo))
    k6 = _launched("q8t", lambda: tpw.normalize_classify_q8t(
        t["xt"], t["scales_t"], t["qw_t"], t["sw"], t["b"], lo))
    k1 = tpw.normalize_classify_q8s(t["q"], t["scales"], t["qw_t"], t["sw"], t["b"], lo)
    assert torch.equal(k4, tpw.normalize_classify_q8i8_plain(
        t["q"], t["hs"], t["qw_t"], t["sw"], t["b"], lo))
    assert torch.equal(k6, tpw.normalize_classify_q8t_plain(
        t["xt"], t["scales_t"], t["qw_t"], t["sw"], t["b"], lo))
    assert torch.equal(k4, k1) and torch.equal(k6, k1.T)


@pytest.mark.parametrize("objects,p", [(35, 1037), (80, 333)])
def test_q8bf_within_bound_of_plain(cuda_device, objects, p):
    lo, t = _inputs(objects, p, cuda_device)
    out = _launched("q8bf", lambda: tpw.normalize_classify_q8(
        t["q"], t["hs"], t["w_bf16_t"], t["b"], lo))
    ref = tpw.normalize_classify_q8_plain(t["q"], t["hs"], t["w_bf16_t"], t["b"], lo)
    hp, blk = lo.dev_head_pad, lo.dev_block
    qa, wa, s = t["q"].double().abs(), t["w_bf16_t"].double().abs(), t["scales"].double()
    terms = (qa[:, :hp] @ wa[:, :hp].T) * s[:, :1]
    for k in range(lo.num_bow_blocks):
        c = slice(hp + k * blk, hp + (k + 1) * blk)
        terms += (qa[:, c] @ wa[:, c].T) * s[:, k + 1 : k + 2]
    tol = 1e-5 * (terms + t["b"].double().abs()) + 1e-6
    assert out.shape == (p, R)
    assert ((out.double() - ref.double()).abs() <= tol).all()


@pytest.mark.parametrize("mode", tpw.PROBE_MODES)
@pytest.mark.parametrize("p,d", [(1037, 11264), (1024, 11264), (333, 11392), (1, 11264),
                                 (4096, 11264), (1036, 11264), (4096, 64), (333, 64)])
def test_probe_equals_plain(cuda_device, mode, p, d):
    rng = np.random.RandomState(p + d)
    x = rng.randint(-128, 128, size=(d, p)).astype(np.int8)
    x[:, -1] = -128  # the largest magnitude: 128^2 * D
    w = rng.randint(-128, 128, size=(160, d)).astype(np.int8)
    w[0] = -128
    xt, wt = torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    out = _launched("q8_probe", lambda: tpw.pair_probe(xt, wt, mode))
    assert out.dtype == torch.int32 and out.shape == (160, p)
    assert torch.equal(out, tpw.pair_probe_plain(xt, wt, mode))


def test_variants_reject_bad_operands(cuda_device):
    lo, t = _inputs(35, 64, cuda_device)
    q, hs, qw_t, sw, b = t["q"], t["hs"], t["qw_t"], t["sw"], t["b"]
    with pytest.raises(TypeError):
        tpw.normalize_classify_q8i8(q, hs.double(), qw_t, sw, b, lo)
    with pytest.raises(ValueError):  # head scales of another row count
        tpw.normalize_classify_q8i8(q, hs[:-1], qw_t, sw, b, lo)
    with pytest.raises(ValueError):  # width that is not the layout's
        tpw.normalize_classify_q8i8(q[:, :-64].contiguous(), hs, qw_t, sw, b, lo)
    with pytest.raises(TypeError):  # f32 weights where K5 takes bf16
        tpw.normalize_classify_q8(q, hs, t["w_bf16_t"].float(), b, lo)
    with pytest.raises(ValueError):  # misaligned int8 rows
        buf = torch.zeros(q.numel() + 1, dtype=torch.int8, device=q.device)
        tpw.normalize_classify_q8(buf[1:].view(q.shape), hs, t["w_bf16_t"], b, lo)
    with pytest.raises(ValueError):  # (16, P) scales given as (P, 16)
        tpw.normalize_classify_q8t(t["xt"], t["scales"], qw_t, sw, b, lo)
    with pytest.raises(ValueError):
        tpw.normalize_classify_q8t(t["xt"][:, 1:], t["scales_t"][:, 1:], qw_t, sw, b, lo)
    with pytest.raises(ValueError):
        tpw.pair_probe(t["xt"], t["w_probe"], "blocks")
    with pytest.raises(ValueError):
        tpw.pair_probe(t["xt"], t["w_probe"].cpu(), "onedot")
