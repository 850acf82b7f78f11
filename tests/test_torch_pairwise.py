"""Parity of the PyTorch port's pair scorers with the JAX package.

* The numpy prep helpers copied into tspn_tpu_torch are bit-exact with
  their originals, for VidVRD (C = 35) and VidOR (C = 80) widths.
* The plain q8s scorer equals normalize_classify_q8s_pallas (interpret
  mode on the CPU, int32 accumulation) at the serve path's three
  geometries, and the port's factored q8f scorer equals
  factored_classify_q8_batched, both within rtol 1e-6 / atol 1e-6 taken
  relative to the magnitude of the summed terms (``_term_scale``): the
  integer partials are exact on both sides, but XLA's fused f32
  epilogue on the CPU does not round in the kernel's order, so an
  intermediate may differ by an ulp, which shows through in full where
  the terms cancel. The port itself rounds in the kernel's order
  (``test_q8s_plain_is_exact_integer_sum``).

The CUDA kernel itself is tested in tests/test_torch_q8s_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tspn_tpu.data import feature_store as jfs
from tspn_tpu.ops import pairwise as jpw
from tspn_tpu_torch.data import layout as tlayout
from tspn_tpu_torch.ops import pairwise as tpw

WIDTHS = (35, 80)


def _layouts(c):
    return jfs.FeatureLayout.for_objects(c), tlayout.FeatureLayout.for_objects(c)


def _storage_rows(rng, lo, p):
    feats = np.zeros((p, lo.dim), np.float32)
    feats[:, : lo.head] = rng.randn(p, lo.head) * 3
    nb = lo.rel_start - lo.bow_start
    feats[:, lo.bow_start : lo.rel_start] = (
        rng.randint(0, 6, size=(p, nb)) * (rng.rand(p, nb) < 0.05)
    )
    feats[:, lo.rel_start :] = rng.randn(p, lo.rel_dim) * 0.2
    feats[-1, lo.bow_start : lo.bow_start + lo.bow_block_size] = 0  # empty block
    return feats


def _assert_same(a, b):
    """``b`` (the port's) equals ``a`` (the JAX package's) bit for bit; a
    dict of the port may omit the JAX package's TPU-padded keys."""
    if isinstance(a, dict):
        assert set(b) <= set(a)
        for k in b:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c", WIDTHS)
def test_layout_fields_equal(c):
    jl, tl = _layouts(c)
    for name in ("head", "bow_start", "rel_start", "dim", "bow_block_starts",
                 "dev_head_dim", "dev_head_pad", "device_dim"):
        assert getattr(jl, name) == getattr(tl, name), name
    assert tlayout.FeatureLayout.from_dim(jl.dim) == tl
    with pytest.raises(ValueError):
        tlayout.FeatureLayout.from_dim(jl.device_dim)


def test_vidvrd_widths():
    lo = tlayout.DEFAULT_LAYOUT
    assert (lo.dev_head_pad, lo.device_dim, lo.dim) == (3072, 11264, 11070)


PREP = (
    "permutation", "to_device_layout", "weights_to_device_layout",
    "to_device_layout_q8", "quantize_weights_percol", "precompute_q8_scales",
    "geoms", "factor_tracklet", "factor_rel", "factor_expanded",
    "split_weights_factored",
)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("helper", PREP)
def test_prep_helper_bit_exact(helper, c):
    rng = np.random.RandomState(c)
    jl, tl = _layouts(c)
    feats = _storage_rows(rng, jl, 9)
    w = (rng.randn(jl.dim, 6) * 0.01).astype(np.float32)
    if helper == "permutation":
        _assert_same(jpw._permutation(jl), tpw._permutation(tl))
    elif helper == "to_device_layout":
        _assert_same(jpw.to_device_layout(feats, jl), tpw.to_device_layout(feats, tl))
        _assert_same(jpw.to_device_layout(feats), tpw.to_device_layout(feats))
    elif helper == "weights_to_device_layout":
        _assert_same(jpw.weights_to_device_layout(w, jl),
                     tpw.weights_to_device_layout(w, tl))
    elif helper == "to_device_layout_q8":
        _assert_same(jpw.to_device_layout_q8(feats, jl),
                     tpw.to_device_layout_q8(feats, tl))
    elif helper == "quantize_weights_percol":
        w_dev = jpw.weights_to_device_layout(w, jl)
        w_dev[:, 2] = 0  # an all-zero column takes scale 1
        _assert_same(jpw.quantize_weights_percol(w_dev),
                     tpw.quantize_weights_percol(w_dev))
    elif helper == "precompute_q8_scales":
        q, s = jpw.to_device_layout_q8(feats, jl)
        _assert_same(jpw.precompute_q8_scales(q, s, jl),
                     tpw.precompute_q8_scales(q, s, tl))
    elif helper == "geoms":
        assert tuple(jpw.tracklet_geom(jl)) == tuple(tpw.tracklet_geom(tl))
        assert tuple(jpw.rel_geom(jl)) == tuple(tpw.rel_geom(tl))
        assert jpw.tracklet_geom(jl).device_dim == tpw.tracklet_geom(tl).device_dim
        assert jpw.rel_geom(jl).device_dim == tpw.rel_geom(tl).device_dim
    elif helper == "factor_tracklet":
        cls = rng.randn(5, c).astype(np.float32)
        bow = (rng.rand(5, 4000) < 0.01) * rng.randint(1, 9, size=(5, 4000))
        bow[0] = 0
        _assert_same(jpw.factor_tracklet_features_q8(cls, bow, jl),
                     tpw.factor_tracklet_features_q8(cls, bow, tl))
    elif helper == "factor_rel":
        rel = rng.randn(7, jl.rel_dim).astype(np.float32)
        rel[3] = 0
        _assert_same(jpw.factor_rel_features_q8(rel, jl),
                     tpw.factor_rel_features_q8(rel, tl))
    elif helper == "factor_expanded":
        pairs = jfs.enumerate_ordered_pairs(4)[::-1].copy()
        rows = _storage_rows(rng, jl, pairs.shape[0])
        _assert_same(jpw.factor_expanded_rows_q8(rows, pairs, 5, jl),
                     tpw.factor_expanded_rows_q8(rows, pairs, 5, tl))
    elif helper == "split_weights_factored":
        _assert_same(jpw.split_weights_factored(w, jl),
                     tpw.split_weights_factored(w, tl))


def test_normalize_classify_matches_jax():
    rng = np.random.RandomState(1)
    lo = jfs.DEFAULT_LAYOUT
    feats = _storage_rows(rng, lo, 11)
    w = (rng.randn(lo.dim, 9) * 0.01).astype(np.float32)
    b = rng.randn(9).astype(np.float32)
    ref = np.asarray(jpw.normalize_classify(jnp.asarray(feats), jnp.asarray(w),
                                            jnp.asarray(b)))
    out = tpw.normalize_classify(torch.from_numpy(feats), torch.from_numpy(w),
                                 torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


GEOMS = {
    "tracklet": (tpw.tracklet_geom(), 2 * 7),
    "rel": (tpw.rel_geom(), 7),
    "expanded": (tpw.BlockGeom(3072, 8, 1024), 7),
}


def _q8s_inputs(rng, geom, p, r):
    d = geom.device_dim
    q = rng.randint(-127, 128, size=(p, d)).astype(np.int8)
    q[-3:] = 0  # padded batch rows are all-zero
    scales = np.zeros((p, 16), np.float32)
    scales[:, : 1 + geom.num_bow_blocks] = rng.rand(p, 1 + geom.num_bow_blocks) / 50
    qw = rng.randint(-127, 128, size=(d, r)).astype(np.int8)
    sw = (rng.rand(r) / 127).astype(np.float32)
    b = rng.randn(r).astype(np.float32)
    return q, scales, qw, sw, b


def _term_scale(q, scales, qw, sw, b, geom):
    """(P, R) magnitude of the terms the q8s epilogue sums:
    sum_k |partial_k * s_k| * |sw| + |b|, in float64."""
    qd, wd = q.astype(np.float64), qw.astype(np.float64)
    hp, blk = geom.dev_head_pad, geom.dev_block
    bounds = [(0, hp)] + [
        (hp + k * blk, hp + (k + 1) * blk) for k in range(geom.num_bow_blocks)
    ]
    acc = sum(
        np.abs(qd[:, lo:hi] @ wd[lo:hi]) * scales[:, k : k + 1]
        for k, (lo, hi) in enumerate(bounds)
    )
    return acc * np.abs(sw) + np.abs(b)


def _assert_close_to_terms(out, ref, scale, rtol=1e-6, atol=1e-6):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    bad = err > atol + rtol * scale
    assert not bad.any(), (err[bad].max(), int(bad.sum()))


def _torch_args(q, scales, qw, sw, b, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (q, scales, qw.T, sw, b)]


@pytest.mark.parametrize("name", list(GEOMS))
def test_q8s_plain_matches_pallas(name):
    geom, r = GEOMS[name]
    rng = np.random.RandomState(2)
    q, scales, qw, sw, b = _q8s_inputs(rng, geom, 37, r)  # ragged: 37 rows
    ref = np.asarray(jpw.normalize_classify_q8s_pallas(
        jnp.asarray(q), jnp.asarray(scales), jnp.asarray(qw), jnp.asarray(sw),
        jnp.asarray(b), layout=geom,
    ))
    tpw.reset_launches()
    out = tpw.normalize_classify_q8s(*_torch_args(q, scales, qw, sw, b), geom)
    assert out.dtype == torch.float32 and out.shape == (37, r)
    assert tpw.LAUNCHES["q8s"] == 0  # CPU tensors take the plain version
    _assert_close_to_terms(out.numpy(), ref, _term_scale(q, scales, qw, sw, b, geom))


def test_q8s_plain_is_exact_integer_sum():
    """A 1-row case computed by hand: head partial * s0 + block partial * s1."""
    geom = tpw.BlockGeom(64, 1, 64)
    q = torch.zeros((1, 128), dtype=torch.int8)
    q[0, :64] = 127
    q[0, 64:] = -127
    qw_t = torch.full((1, 128), 127, dtype=torch.int8)
    scales = torch.zeros((1, 16))
    scales[0, 0], scales[0, 1] = 0.5, 0.25
    out = tpw.normalize_classify_q8s_plain(
        q, scales, qw_t, torch.tensor([2.0]), torch.tensor([1.0]), geom
    )
    part = 127 * 127 * 64
    assert out.item() == (part * 0.5 - part * 0.25) * 2.0 + 1.0


def test_q8s_rejects_unknown_device():
    geom = tpw.rel_geom()
    args = [torch.empty((2, geom.device_dim), dtype=torch.int8, device="meta")]
    with pytest.raises(ValueError, match="no implementation"):
        tpw.normalize_classify_q8s(*args, None, None, None, None, geom)


def _factored_batch(rng, lo, bsz, n, sizes, r):
    """Padded factored batch: segment k has sizes[k] <= n tracklets."""
    tg, rg = tpw.tracklet_geom(lo), tpw.rel_geom(lo)
    p_max = n * (n - 1)
    trk_q = np.zeros((bsz, n, tg.device_dim), np.int8)
    trk_s = np.zeros((bsz, n, 16), np.float32)
    rel_q = np.zeros((bsz, p_max, rg.device_dim), np.int8)
    rel_s = np.zeros((bsz, p_max, 16), np.float32)
    pairs = np.zeros((bsz, p_max, 2), np.int32)
    for k, m in enumerate(sizes):
        cls = rng.randn(m, lo.classeme_dim).astype(np.float32) * 2
        bow = ((rng.rand(m, 4000) < 0.05) * rng.randint(1, 9, (m, 4000))).astype(np.float32)
        pr = jfs.enumerate_ordered_pairs(m)
        rel = rng.randn(pr.shape[0], lo.rel_dim).astype(np.float32) * 0.3
        tq, ts = tpw.factor_tracklet_features_q8(cls, bow, lo)
        rq, rs = tpw.factor_rel_features_q8(rel, lo)
        trk_q[k, :m], trk_s[k, :m] = tq, ts
        rel_q[k, : len(pr)], rel_s[k, : len(pr)] = rq, rs
        pairs[k, : len(pr)] = pr
    w = (rng.randn(lo.dim, r) * 0.01).astype(np.float32)
    b = rng.randn(r).astype(np.float32)
    return trk_q, trk_s, rel_q, rel_s, pairs, w, b


def test_factored_q8f_scorer_matches_jax():
    rng = np.random.RandomState(3)
    lo = tlayout.DEFAULT_LAYOUT
    trk_q, trk_s, rel_q, rel_s, pairs, w, b = _factored_batch(
        rng, lo, 2, 4, (4, 3), 9
    )
    jwq = {k: jnp.asarray(v) for k, v in jpw.split_weights_factored(w).items()}
    ref = np.asarray(jpw.factored_classify_q8_batched(
        *(jnp.asarray(a) for a in (trk_q, trk_s, rel_q, rel_s, pairs)),
        jwq, jnp.asarray(b),
    ))
    wq = tpw.split_weights_factored(w, lo)
    twq = {
        "qw_trk_t": torch.from_numpy(np.ascontiguousarray(wq["qw_trk"].T)),
        "sw_trk": torch.from_numpy(wq["sw_trk"]),
        "qw_rel_t": torch.from_numpy(np.ascontiguousarray(wq["qw_rel"].T)),
        "sw_rel": torch.from_numpy(wq["sw_rel"]),
    }
    out = tpw.factored_classify_q8_batched(
        *(torch.from_numpy(a) for a in (trk_q, trk_s, rel_q, rel_s, pairs)),
        twq, torch.from_numpy(b), layout=lo,
    )
    assert out.shape == ref.shape == (2, 12, 9)
    tg, rg = tpw.tracklet_geom(lo), tpw.rel_geom(lo)
    a_terms = _term_scale(
        trk_q.reshape(8, -1), trk_s.reshape(8, -1), wq["qw_trk"], wq["sw_trk"],
        np.zeros(18, np.float32), tg,
    ).reshape(2, 4, 18)
    y_terms = _term_scale(
        rel_q.reshape(24, -1), rel_s.reshape(24, -1), wq["qw_rel"], wq["sw_rel"],
        b, rg,
    ).reshape(2, 12, 9)
    bidx = np.arange(2)[:, None]
    scale = (y_terms + a_terms[bidx, pairs[..., 0], :9]
             + a_terms[bidx, pairs[..., 1], 9:])
    _assert_close_to_terms(out.numpy(), ref, scale)
