"""Parity of the port's K4, K5, K6 and int8 probe with the JAX package.

At the JAX package's own test sizes (P 7 and 37, R 5, full width, the
VidVRD and VidOR layouts), from numpy seeds:

* The plain K4 (``normalize_classify_q8i8``) and K6
  (``normalize_classify_q8t``) against ``normalize_classify_q8i8_pallas``
  and ``normalize_classify_q8t_pallas`` in interpret mode, within rtol /
  atol 1e-6 taken relative to the magnitude of the summed terms (as in
  tests/test_torch_pairwise.py: the integer partials are exact on both
  sides, XLA's fused CPU epilogue rounds off the kernel's order).
* The plain K5 (``normalize_classify_q8``) against
  ``normalize_classify_q8_pallas`` (interpret mode) within 1e-5 of the
  summed terms (both sum bf16 products in f32, in other orders), and
  against the XLA oracle ``normalize_classify_q8`` (f32 weights) at the
  JAX package's 2e-2.
* Inside the port, bit for bit: K4 equals K1 fed ``precompute_q8_scales``
  and K6 equals K1 transposed; the torch block scales equal the numpy
  helper's; the bf16 weight rounding equals JAX's ``astype(bfloat16)``;
  the probe equals the exact numpy int64 product in all three modes.
* The probe kernel's planner (``probe_plan``): x is staged by TMA where P
  % 16 == 0, else by aligned words (shifted where P % 4 != 0); the D
  shares of a split cover D in whole 128-byte chunks; at the VidOR
  geometry (333 pairs, 3 tiles) the shares fill the card's SMs; stream
  mode runs 32-row tiles.
* On the CPU the dispatchers launch nothing; another device raises.
* The ported tool runs every leg at ``--device cpu --segments 1``, and its
  K6 output is its K1 output transposed.

The CUDA kernels are tested in tests/test_torch_q8_variants_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tspn_tpu.data import feature_store as jfs
from tspn_tpu.ops import pairwise as jpw
from tspn_tpu_torch.data import layout as tlayout
from tspn_tpu_torch.ops import pairwise as tpw
from tspn_tpu_torch.runtime import timing
from tspn_tpu_torch.tools import bench_pair_kernels as bench

R = 5
CASES = [(c, p) for c in (35, 80) for p in (7, 37)]


def _inputs(c, p, seed=0):
    """Quantized device-layout rows of sparse storage features (row 0 all
    zero, an empty BoW block in the last row, row 1 raw signed int8),
    head scales, device-layout weights and their int8 quantization."""
    jl = jfs.FeatureLayout.for_objects(c)
    tl = tlayout.FeatureLayout.for_objects(c)
    rng = np.random.RandomState(seed + c + p)
    feats = np.zeros((p, jl.dim), np.float32)
    feats[:, : jl.head] = rng.randn(p, jl.head) * 3
    nb = jl.rel_start - jl.bow_start
    feats[:, jl.bow_start : jl.rel_start] = rng.randint(0, 6, (p, nb)) * (rng.rand(p, nb) < 0.05)
    feats[:, jl.rel_start :] = rng.randn(p, jl.rel_dim) * 0.2
    feats[-1, jl.bow_start : jl.bow_start + jl.bow_block_size] = 0
    feats[0] = 0
    q, hs = jpw.to_device_layout_q8(feats, jl)
    q[1] = rng.randint(-127, 128, jl.device_dim)
    w_dev = jpw.weights_to_device_layout((rng.randn(jl.dim, R) * 0.01).astype(np.float32), jl)
    qw, sw = jpw.quantize_weights_percol(w_dev)
    b = rng.randn(R).astype(np.float32)
    return jl, tl, q, hs, w_dev, qw, sw, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _segments(lo):
    hp, blk = lo.dev_head_pad, lo.dev_block
    return [(0, hp)] + [(hp + k * blk, hp + (k + 1) * blk) for k in range(lo.num_bow_blocks)]


def _terms(q, scales, w, lo):
    """(P, R) magnitude of the summed terms: sum_k |q_k| @ |w_k| * s_k, in
    float64, with w (D, R) and s the (P, 16) row multipliers."""
    qa, wa = np.abs(q.astype(np.float64)), np.abs(w.astype(np.float64))
    return sum(qa[:, lo_:hi] @ wa[lo_:hi] * scales[:, k : k + 1]
               for k, (lo_, hi) in enumerate(_segments(lo)))


def _assert_close_to_terms(out, ref, scale, rtol, atol):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    bad = err > atol + rtol * scale
    assert not bad.any(), (err[bad].max(), int(bad.sum()))


@pytest.mark.parametrize("c,p", CASES)
def test_q8i8_plain_matches_pallas(c, p):
    jl, tl, q, hs, _w, qw, sw, b = _inputs(c, p)
    ref = np.asarray(jpw.normalize_classify_q8i8_pallas(
        jnp.asarray(q), jnp.asarray(hs), jnp.asarray(qw), jnp.asarray(sw),
        jnp.asarray(b), layout=jl))
    tpw.reset_launches()
    out = tpw.normalize_classify_q8i8(*_t(q, hs, qw.T, sw, b), tl)
    assert sum(tpw.LAUNCHES.values()) == 0  # CPU tensors take the plain version
    assert out.dtype == torch.float32 and out.shape == ref.shape == (p, R)
    scales = jpw.precompute_q8_scales(q, hs, jl)
    terms = _terms(q, scales, qw, jl) * np.abs(sw) + np.abs(b)
    _assert_close_to_terms(out.numpy(), ref, terms, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,p", CASES)
def test_q8t_plain_matches_pallas(c, p):
    jl, tl, q, hs, _w, qw, sw, b = _inputs(c, p)
    scales = jpw.precompute_q8_scales(q, hs, jl)
    ref = np.asarray(jpw.normalize_classify_q8t_pallas(
        jnp.asarray(np.ascontiguousarray(q.T)), jnp.asarray(np.ascontiguousarray(scales.T)),
        jnp.asarray(np.ascontiguousarray(qw.T)), jnp.asarray(sw), jnp.asarray(b), layout=jl))
    tpw.reset_launches()
    out = tpw.normalize_classify_q8t(*_t(q.T, scales.T, qw.T, sw, b), tl)
    assert sum(tpw.LAUNCHES.values()) == 0
    assert out.shape == ref.shape == (R, p)
    terms = _terms(q, scales, qw, jl) * np.abs(sw) + np.abs(b)
    _assert_close_to_terms(out.numpy(), ref, terms.T, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,p", CASES)
def test_q8_plain_matches_pallas_and_xla(c, p):
    jl, tl, q, hs, w_dev, _qw, _sw, b = _inputs(c, p)
    args = (jnp.asarray(q), jnp.asarray(hs), jnp.asarray(w_dev), jnp.asarray(b))
    ref = np.asarray(jpw.normalize_classify_q8_pallas(*args, layout=jl))
    xla = np.asarray(jpw.normalize_classify_q8(*args, layout=jl))
    tpw.reset_launches()
    w_bf16_t = tpw.weights_bf16_t(w_dev)
    out = tpw.normalize_classify_q8(*_t(q, hs), w_bf16_t, torch.from_numpy(b), tl)
    assert sum(tpw.LAUNCHES.values()) == 0
    assert out.shape == ref.shape == (p, R)
    scales = jpw.precompute_q8_scales(q, hs, jl)
    terms = _terms(q, scales, w_bf16_t.float().numpy().T, jl) + np.abs(b)
    _assert_close_to_terms(out.numpy(), ref, terms, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), xla, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("c,p", CASES)
def test_variants_equal_k1_bit_for_bit(c, p):
    _jl, tl, q, hs, _w, qw, sw, b = _inputs(c, p)
    scales = tpw.precompute_q8_scales(q, hs, tl)
    tq, ths = _t(q, hs)
    assert torch.equal(tpw.q8_block_scales(tq, ths, tl), torch.from_numpy(scales))
    k1 = tpw.normalize_classify_q8s_plain(*_t(q, scales, qw.T, sw, b), tl)
    k4 = tpw.normalize_classify_q8i8_plain(*_t(q, hs, qw.T, sw, b), tl)
    k6 = tpw.normalize_classify_q8t_plain(*_t(q.T, scales.T, qw.T, sw, b), tl)
    assert torch.equal(k4, k1) and torch.equal(k6, k1.T)


def test_bf16_weight_rounding_matches_jax():
    rng = np.random.RandomState(9)
    w = (rng.randn(64, 6) * 0.01).astype(np.float32)
    edges = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,  # ties to even
                      0x3F808001, 0x00008000, 0x00018000, 0x80000000,  # above a tie, subnormals, -0
                      0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x3C23D70A],  # max -> inf, infs, 0.01
                     np.uint32).view(np.float32)
    w[:12, 0] = edges
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)).view(np.int16)
    got = tpw.weights_bf16_t(w)
    assert got.dtype == torch.bfloat16 and got.shape == (6, 64) and got.is_contiguous()
    np.testing.assert_array_equal(got.T.contiguous().view(torch.int16).numpy(), want)


@pytest.mark.parametrize("mode", tpw.PROBE_MODES)
def test_probe_plain_is_exact_product(mode):
    rng = np.random.RandomState(4)
    d, p, r = 11264, 37, 40
    x = rng.randint(-128, 128, (d, p)).astype(np.int8)
    w = rng.randint(-128, 128, (r, d)).astype(np.int8)
    x[:, 0] = -128
    w[0] = -128  # the largest magnitude: 128^2 * D
    want = w.astype(np.int64) @ x.astype(np.int64)
    if mode == "stream":
        want[tpw.PROBE_STREAM_ROWS :] = 0
    tpw.reset_launches()
    out = tpw.pair_probe(*_t(x, w), mode)
    assert sum(tpw.LAUNCHES.values()) == 0
    assert out.dtype == torch.int32 and out.shape == (r, p)
    np.testing.assert_array_equal(out.numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        tpw.pair_probe(*_t(x, w), "tiles")


SMS = 132  # an H100 SXM


@pytest.mark.parametrize("p,staging", [(95232, "tma"), (4096, "tma"), (16, "tma"),
                                       (95236, "word"), (1036, "word"), (95155, "shift"),
                                       (333, "shift"), (1, "shift")])
def test_probe_plan_staging_follows_p(p, staging):
    assert tpw.probe_plan(p, 160, 11264, "onedot", SMS).staging == staging


@pytest.mark.parametrize("p,d", [(333, 11392), (1, 11264), (4096, 11264), (1037, 11264),
                                 (95232, 11264), (333, 64), (1, 64 * 3)])
def test_probe_plan_splits_cover_d_in_whole_chunks(p, d):
    plan = tpw.probe_plan(p, 160, d, "onedot", SMS)
    assert plan.chunks * tpw.PROBE_CHUNK >= d > (plan.chunks - 1) * tpw.PROBE_CHUNK
    shares = plan.shares()
    assert len(shares) == plan.split and shares[0][0] == 0 and shares[-1][1] == plan.chunks
    assert all(lo < hi for lo, hi in shares)
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert plan.grid == min(plan.tiles * plan.split, SMS) and plan.tiles * plan.split <= max(
        SMS, plan.tiles)
    if plan.tiles >= SMS:
        assert plan.split == 1


def test_probe_plan_fills_the_sms_at_vidor():
    plan = tpw.probe_plan(333, 160, 11392, "onedot", SMS)
    assert plan.tiles == 3 and plan.split > 1 and plan.tiles * plan.split >= SMS
    assert plan.grid == SMS


@pytest.mark.parametrize("mode,n,live", [("stream", 32, 32), ("onedot", 160, 160),
                                         ("blocks_noscale", 160, 160)])
def test_probe_plan_rows_by_mode(mode, n, live):
    plan = tpw.probe_plan(95232, 160, 11264, mode, SMS)
    assert (plan.n, plan.live, plan.tiles) == (n, live, 744)
    assert tpw.probe_plan(95232, 200, 11264, mode, SMS).tiles == 744 * (1 if mode == "stream"
                                                                        else 2)


@pytest.mark.parametrize("name", ["q8i8", "q8bf", "q8t", "q8_probe"])
def test_variants_reject_unknown_device(name):
    lo = tlayout.DEFAULT_LAYOUT
    meta = torch.empty((2, lo.device_dim), dtype=torch.int8, device="meta")
    call = {
        "q8i8": lambda: tpw.normalize_classify_q8i8(meta, None, None, None, None, lo),
        "q8bf": lambda: tpw.normalize_classify_q8(meta, None, None, None, lo),
        "q8t": lambda: tpw.normalize_classify_q8t(meta, None, None, None, None, lo),
        "q8_probe": lambda: tpw.pair_probe(meta, None, "onedot"),
    }[name]
    with pytest.raises(ValueError, match=f"{name}: no implementation"):
        call()


def test_tool_runs_every_leg_on_cpu(monkeypatch, capsys):
    outs = []

    def one_call(fn, device):
        assert device.type == "cpu"
        outs.append(fn())
        return 1.0

    monkeypatch.setattr(timing, "median_ms", one_call)
    tpw.reset_launches()
    result = bench.main(["--device", "cpu", "--segments", "1"])
    printed = capsys.readouterr().out
    legs = ["q8s", "probe stream", "probe onedot", "probe blocks_noscale", "q8t"]
    assert list(result["legs"]) == legs and result["pairs"] == 992
    assert all(leg in printed for leg in legs) and "Mpairs/s" in printed
    assert sum(tpw.LAUNCHES.values()) == 0
    k1, stream, onedot, blocks, k6 = outs
    assert k1.shape == (992, 132) and torch.isfinite(k1).all()
    assert torch.equal(k6, k1.T)
    assert torch.equal(onedot, blocks) and onedot.shape == (160, 992)
    assert torch.equal(stream[:32], onedot[:32]) and not stream[32:].any()
