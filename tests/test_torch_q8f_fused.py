"""K2's plain version (the factored rel pass with the A-table add) against
the JAX package, on the CPU.

* ``factored_classify_q8_fused`` of the port (q8s tracklet pass, then
  ``factored_classify_q8_fused_plain``) against the JAX package's
  ``factored_classify_q8_fused`` (Pallas in interpret mode), with
  non-canonical pairs and a P that is not a multiple of 32, within rtol
  1e-6 / atol 1e-6 taken relative to the magnitude of the summed terms:
  the integer partials are exact on both sides, but XLA's fused f32
  epilogue does not round in the kernel's order.
* The same against the port's two-pass ``factored_classify_q8_batched``,
  which adds the two A rows one at a time.
* A pair index outside [0, N) adds exactly 0, and the A rows it would
  name are never used.

The CUDA kernel itself is tested in tests/test_torch_q8f_fused_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.ops import pairwise as jpw
from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT
from tspn_tpu_torch.ops import pairwise as tpw

R = 9


def _batch(rng, bsz, n, p):
    """A padded factored batch of ``bsz`` segments over ``n`` tracklets
    with ``p`` rel rows each, pairs drawn at random (not subject-major),
    the last rows all-zero padding."""
    lo = DEFAULT_LAYOUT
    tg, rg = tpw.tracklet_geom(lo), tpw.rel_geom(lo)
    trk_q = np.zeros((bsz, n, tg.device_dim), np.int8)
    trk_s = np.zeros((bsz, n, 16), np.float32)
    for k in range(bsz):
        cls = rng.randn(n, lo.classeme_dim).astype(np.float32) * 2
        bow = ((rng.rand(n, 4000) < 0.05) * rng.randint(1, 9, (n, 4000))).astype(np.float32)
        trk_q[k], trk_s[k] = tpw.factor_tracklet_features_q8(cls, bow, lo)
    rel = rng.randn(bsz * p, lo.rel_dim).astype(np.float32) * 0.3
    rel_q, rel_s = tpw.factor_rel_features_q8(rel, lo)
    rel_q, rel_s = rel_q.reshape(bsz, p, -1), rel_s.reshape(bsz, p, 16)
    rel_q[:, -2:] = 0
    pairs = rng.randint(0, n, size=(bsz, p, 2)).astype(np.int32)
    w = (rng.randn(lo.dim, R) * 0.01).astype(np.float32)
    b = rng.randn(R).astype(np.float32)
    return trk_q, trk_s, rel_q, rel_s, pairs, w, b


def _torch_weights(w):
    wq = tpw.split_weights_factored(w, DEFAULT_LAYOUT)
    return wq, {
        "qw_trk_t": torch.from_numpy(np.ascontiguousarray(wq["qw_trk"].T)),
        "sw_trk": torch.from_numpy(wq["sw_trk"]),
        "qw_rel_t": torch.from_numpy(np.ascontiguousarray(wq["qw_rel"].T)),
        "sw_rel": torch.from_numpy(wq["sw_rel"]),
    }


def _terms(trk_q, trk_s, rel_q, rel_s, pairs, wq, b):
    """(B, P, R) magnitude of the summed terms: |rel partial * s| * |sw|
    + |b| + |A_sub| + |A_obj|, each A term itself a sum of magnitudes."""
    def mag(q, s, qw, sw, geom):
        qd, wd = q.astype(np.float64), qw.astype(np.float64)
        hp, blk = geom.dev_head_pad, geom.dev_block
        bounds = [(0, hp)] + [(hp + k * blk, hp + (k + 1) * blk)
                              for k in range(geom.num_bow_blocks)]
        acc = sum(np.abs(qd[:, lo:hi] @ wd[lo:hi]) * s[:, k: k + 1]
                  for k, (lo, hi) in enumerate(bounds))
        return acc * np.abs(sw)

    bsz, n, _ = trk_q.shape
    p = rel_q.shape[1]
    a = mag(trk_q.reshape(bsz * n, -1), trk_s.reshape(bsz * n, -1), wq["qw_trk"],
            wq["sw_trk"], tpw.tracklet_geom()).reshape(bsz, n, 2 * R)
    y = mag(rel_q.reshape(bsz * p, -1), rel_s.reshape(bsz * p, -1), wq["qw_rel"],
            wq["sw_rel"], tpw.rel_geom()).reshape(bsz, p, R) + np.abs(b)
    bidx = np.arange(bsz)[:, None]
    return y + a[bidx, pairs[..., 0], :R] + a[bidx, pairs[..., 1], R:]


def _assert_close_to_terms(out, ref, scale, rtol=1e-6, atol=1e-6):
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    bad = err > atol + rtol * scale
    assert not bad.any(), (err[bad].max(), int(bad.sum()))


def _port(args, twq, b, **kw):
    return tpw.factored_classify_q8_fused(
        *(torch.from_numpy(a) for a in args), twq, torch.from_numpy(b), **kw
    )


@pytest.mark.parametrize("p", [13, 45])
def test_k2_plain_matches_pallas(p):
    rng = np.random.RandomState(p)
    trk_q, trk_s, rel_q, rel_s, pairs, w, b = _batch(rng, 2, 6, p)
    jwq = {k: jnp.asarray(v) for k, v in jpw.split_weights_factored(w).items()}
    sidecar = jpw.pack_rel_sidecar(jnp.asarray(rel_s), jnp.asarray(pairs))
    ref = np.asarray(jpw.factored_classify_q8_fused(
        jnp.asarray(trk_q), jnp.asarray(trk_s), jnp.asarray(rel_q), sidecar,
        jwq, jnp.asarray(b),
    ))
    wq, twq = _torch_weights(w)
    tpw.reset_launches()
    out = _port((trk_q, trk_s, rel_q, rel_s, pairs), twq, b)
    assert tpw.LAUNCHES == {"q8s": 0, "fused_classify": 0, "q8f_fused": 0,
                            "q8i8": 0, "q8bf": 0, "q8t": 0, "q8_probe": 0,
                            "fused_classify_bf16": 0}
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, p, R)
    _assert_close_to_terms(out.numpy(), ref,
                           _terms(trk_q, trk_s, rel_q, rel_s, pairs, wq, b))
    plain = _port((trk_q, trk_s, rel_q, rel_s, pairs), twq, b, plain=True)
    assert torch.equal(plain, out)


def test_k2_plain_matches_two_pass():
    rng = np.random.RandomState(7)
    args = _batch(rng, 3, 8, 45)
    trk_q, trk_s, rel_q, rel_s, pairs, w, b = args
    wq, twq = _torch_weights(w)
    out = _port(args[:5], twq, b)
    ref = tpw.factored_classify_q8_batched(
        *(torch.from_numpy(a) for a in args[:5]), twq, torch.from_numpy(b)
    )
    assert out.shape == ref.shape == (3, 45, R)
    _assert_close_to_terms(out.numpy(), ref.numpy(),
                           _terms(trk_q, trk_s, rel_q, rel_s, pairs, wq, b))


def test_k2_out_of_range_index_adds_zero():
    rng = np.random.RandomState(11)
    bsz, n, p, r, d = 2, 5, 12, 7, tpw.rel_geom().device_dim
    x = torch.from_numpy(rng.randint(-127, 128, (bsz, p, d)).astype(np.int8))
    s = torch.from_numpy((rng.rand(bsz, p) / 50).astype(np.float32))
    qw = torch.from_numpy(rng.randint(-127, 128, (r, d)).astype(np.int8))
    sw = torch.from_numpy((rng.rand(r) / 127).astype(np.float32))
    b = torch.from_numpy(rng.randn(r).astype(np.float32))
    a = torch.from_numpy(rng.randn(bsz, n, 2 * r).astype(np.float32))
    pairs = torch.from_numpy(rng.randint(1, n, (bsz, p, 2)).astype(np.int32))
    pairs[:, 0::3, 0] = n       # just past the end
    pairs[:, 1::4, 1] = -1      # negative
    pairs[:, 2::5, 0] = 1 << 20
    a[:, 0] = float("nan")      # row 0 is named by no in-range pair
    out = tpw.q8f_fused(x, s, pairs, qw, sw, b, a)
    assert torch.isfinite(out).all()

    scales = torch.zeros((bsz * p, 16))
    scales[:, 0] = s.reshape(-1)
    y = tpw.normalize_classify_q8s_plain(
        x.reshape(bsz * p, d), scales, qw, sw, b, tpw.rel_geom()
    ).reshape(bsz, p, r)
    want = torch.empty_like(y)
    for i in range(bsz):
        for j in range(p):
            sub, obj = (int(v) for v in pairs[i, j])
            a_sub = a[i, sub, :r] if 0 <= sub < n else torch.zeros(r)
            a_obj = a[i, obj, r:] if 0 <= obj < n else torch.zeros(r)
            want[i, j] = y[i, j] + (a_sub + a_obj)
    assert torch.equal(out, want)


def test_q8f_fused_rejects_unknown_device():
    args = [torch.empty((1, 2, 3072), dtype=torch.int8, device="meta")] + [None] * 6
    with pytest.raises(ValueError, match="no implementation"):
        tpw.q8f_fused(*args)
