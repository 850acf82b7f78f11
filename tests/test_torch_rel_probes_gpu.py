"""Kr, Kn and Ks4 (``tspn_tpu_torch/ops/rel.py``, ``csrc/rel.cu``) on a
card (marked gpu; each test skips without one).

Imports only torch, numpy and tspn_tpu_torch:
``python -m pytest tests/test_torch_rel_probes_gpu.py -q``.

* Kr equals its plain version bit for bit at a ragged row count (with
  zero rows) for every epilogue, ring depth, schedule and K split; its
  ``side`` epilogue equals K1's plain version at ``rel_geom``.
* Kn and Ks4 equal their plain versions (the exact int64 products).
* Each call launches its kernel once; the wrappers raise on a bad shape,
  dtype, alignment or knob.
"""

import numpy as np
import pytest
import torch

from tspn_tpu_torch.ops import pairwise as tpw
from tspn_tpu_torch.ops import rel

pytestmark = pytest.mark.gpu

D, R = 3072, 132


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Kr, Kn and Ks4 have no CPU mode")
    return torch.device("cuda")


def _inputs(p, device, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, size=(p, D)).astype(np.int8)
    x[-5:] = 0
    x4 = rng.randint(-8, 8, size=(p, D)).astype(np.int8)
    s = (rng.rand(p, 128) / 64).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in {
        "x": x, "x4": x4, "s128": s, "s16": np.ascontiguousarray(s[:, :16]),
        "w_t": rng.randint(-127, 128, size=(R, D)).astype(np.int8),
        "sw": (rng.rand(R) / 127).astype(np.float32),
        "b": rng.randn(R).astype(np.float32),
    }.items()}
    t["xp"] = rel.pack_int4(t["x4"])
    return t


def _launched(key, fn):
    before = rel.LAUNCHES[key]
    out = fn()
    torch.cuda.synchronize()
    assert rel.LAUNCHES[key] == before + 1
    return out


@pytest.mark.parametrize("epilogue", rel.EPILOGUES)
@pytest.mark.parametrize("p", [1037, 333])
def test_kr_equals_plain_in_every_schedule(cuda_device, p, epilogue):
    t = _inputs(p, cuda_device)
    args = (t["x"], t["w_t"], t["s16"], t["sw"], t["b"])
    ref = rel.rel_s8_plain(*args, epilogue=epilogue)
    if epilogue == "side":
        assert torch.equal(ref, tpw.normalize_classify_q8s_plain(
            t["x"], t["s16"], t["w_t"], t["sw"], t["b"], tpw.rel_geom()))
    for stages in rel.STAGES:
        for schedule in rel.SCHEDULES:
            for ks in rel.SPLITS:
                out = _launched("rel_s8", lambda: rel.rel_s8(
                    *args, epilogue=epilogue, stages=stages, schedule=schedule, ks=ks))
                assert out.shape == (p, R) and torch.equal(out, ref), (stages, schedule, ks)
    if epilogue == "side":  # a 128-wide sidecar reads the same column 0
        assert torch.equal(rel.rel_s8(t["x"], t["w_t"], t["s128"], t["sw"], t["b"],
                                      epilogue="side", schedule="persistent"), ref)


@pytest.mark.parametrize("p", [1037, 333])
def test_kn_and_ks4_equal_the_exact_products(cuda_device, p):
    t = _inputs(p, cuda_device)
    even, odd = rel.split_even_odd(t["w_t"])
    w4 = rel.wrap_int4(t["w_t"])
    want = (t["x4"].double() @ t["w_t"].double().T).long()
    want4 = (t["x4"].double() @ w4.double().T).long()
    out = _launched("rel_s4x8", lambda: rel.rel_s4x8(t["xp"], even, odd))
    assert out.dtype == torch.int32 and torch.equal(out.long(), want)
    out = _launched("rel_s4x4", lambda: rel.rel_s4x4(t["xp"], rel.pack_int4(w4)))
    assert torch.equal(out.long(), want4)
    assert torch.equal(rel.rel_s4x8(t["xp"], even, odd),
                       rel.rel_s4x8_plain(t["xp"], even, odd))


def test_rel_wrappers_reject_bad_operands(cuda_device):
    t = _inputs(64, cuda_device)
    x, w_t, s16, sw, b = t["x"], t["w_t"], t["s16"], t["sw"], t["b"]
    with pytest.raises(TypeError):  # f32 rows
        rel.rel_s8(x.float(), w_t)
    with pytest.raises(ValueError):  # weights of another width
        rel.rel_s8(x, w_t[:, :-128].contiguous())
    with pytest.raises(ValueError):  # a sidecar of another row count
        rel.rel_s8(x, w_t, s16[:-1], sw, b, epilogue="side")
    with pytest.raises(ValueError):  # misaligned int8 rows
        buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=x.device)
        rel.rel_s8(buf[1:].view(x.shape), w_t)
    with pytest.raises(ValueError):  # a row that is no multiple of 128 x ks bytes
        rel.rel_s8(x[:, :192].contiguous(), w_t[:, :192].contiguous())
    with pytest.raises(ValueError):
        rel.rel_s4x8(t["xp"], w_t, w_t)
    with pytest.raises(ValueError):  # weights on the CPU
        rel.rel_s4x4(t["xp"], rel.pack_int4(rel.wrap_int4(w_t)).cpu())
