"""Parity of the port's fused classifier (K3's plain version and its
autograd ops) with the JAX package, on the CPU.

* ``normalize_classify_fused_plain`` (what the CUDA kernel is held to on
  the card, and what the dispatcher runs on a CPU tensor) agrees with
  ``normalize_classify_pallas``, run in interpret mode on the CPU as
  tests/test_pairwise_kernel.py runs it, and with
  ``normalize_classify_device``, for VidVRD (C 35) and VidOR (C 80)
  layouts, with a zero BoW block and zero padding rows. Tolerance:
  ``|port - jax| <= 1e-5 * (|N(x)| @ |W| + |b|) + 1e-6`` per element.
  The two sides sum in different orders, and normalize by a reciprocal
  multiply (the port, the Pallas kernel) or a division (the XLA path),
  so they agree relative to the magnitude of the summed terms, not bit
  for bit.
* The two autograd ops agree with ``jax.grad`` of
  ``normalize_classify_fused`` and ``normalize_classify_fused_nofeatgrad``
  at the tolerances of tests/test_pairwise_kernel.py (atol 2e-3 for the
  general op, rtol 2e-5 / atol 1e-6 for dW and db of the training op),
  and the training op's feature cotangent is exactly zero.
* ``weights_from_device_layout`` inverts the device permutation as the
  JAX package's q8f weight prep does, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.data import feature_store as jfs
from tspn_tpu.ops import pairwise as jpw
from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.ops import pairwise as tpw

P, R = 20, 12


def _inputs(c, seed=0):
    """Raw device-layout rows (sparse non-negative BoW counts, a normal
    head), one row with a zero block, three zero padding rows."""
    rng = np.random.RandomState(seed)
    jl = jfs.FeatureLayout.for_objects(c)
    feats = np.zeros((P, jl.dim), np.float32)
    feats[:, : jl.head] = rng.randn(P, jl.head) * 3
    nb = jl.rel_start - jl.bow_start
    feats[:, jl.bow_start : jl.rel_start] = (
        rng.randint(0, 6, size=(P, nb)) * (rng.rand(P, nb) < 0.05)
    )
    feats[:, jl.rel_start :] = rng.randn(P, jl.rel_dim) * 0.2
    feats[0, jl.bow_start : jl.bow_start + jl.bow_block_size] = 0
    feats[-3:] = 0
    x = jpw.to_device_layout(feats, jl)
    w = (rng.randn(jl.device_dim, R) * 0.01).astype(np.float32)
    b = rng.randn(R).astype(np.float32)
    return jl, FeatureLayout.for_objects(c), x, w, b


def _bound(x, w, b, layout):
    xn = tpw._normalize_device_layout(torch.from_numpy(x).double(), layout)
    return 1e-5 * (xn.abs().numpy() @ np.abs(w.astype(np.float64)) + np.abs(b)) + 1e-6


@pytest.mark.parametrize("c", [35, 80])
def test_fused_plain_matches_pallas_and_device(c):
    jl, tl, x, w, b = _inputs(c)
    out = tpw.normalize_classify_fused_forward(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), tl
    ).numpy()
    assert out.shape == (P, R) and out.dtype == np.float32
    bound = _bound(x, w, b, tl)
    pallas = np.asarray(jpw.normalize_classify_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), layout=jl
    ))
    device = np.asarray(jpw.normalize_classify_device(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), layout=jl
    ))
    for ref in (pallas, device):
        assert (np.abs(out.astype(np.float64) - ref) <= bound).all(), (
            np.abs(out - ref).max()
        )
    # the port's own division path, as the JAX XLA path
    port_device = tpw.normalize_classify_device(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), tl
    ).numpy()
    assert (np.abs(port_device.astype(np.float64) - device) <= bound).all()
    np.testing.assert_array_equal(out[-3:], np.broadcast_to(b, (3, R)))


def test_fused_forward_refuses_bf16():
    """bf16 rows are no longer refused: they take K3's bf16 half (its plain
    version on a CPU tensor), with W rounded to bf16 as the TPU kernel
    casts it to the rows' dtype, and f32 logits (tests/test_torch_bf16.py
    holds that half against the JAX kernel)."""
    _jl, tl, x, w, b = _inputs(35)
    xb = torch.from_numpy(x).bfloat16()
    out = tpw.normalize_classify_fused_forward(xb, torch.from_numpy(w),
                                               torch.from_numpy(b), tl)
    assert out.dtype == torch.float32 and out.shape == (P, R)
    ref = tpw.normalize_classify_fused_bf16_plain(xb, tpw.weights_bf16_t(w),
                                                  torch.from_numpy(b), tl)
    assert torch.equal(out, ref)
    with pytest.raises(TypeError):
        tpw.normalize_classify_fused_forward(xb.half(), torch.from_numpy(w),
                                             torch.from_numpy(b), tl)


def _jax_grads(fn, x, w, b, g, jl):
    def loss(x, w, b):
        return jnp.sum(fn(x, w, b, layout=jl) * g)

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    )]


def _port_grads(fn, x, w, b, g, tl):
    xt, wt, bt = (torch.from_numpy(a).clone().requires_grad_(True) for a in (x, w, b))
    (fn(xt, wt, bt, tl) * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (xt, wt, bt)]


@pytest.mark.parametrize("c", [35, 80])
def test_fused_general_grads_match_jax(c):
    jl, tl, x, w, b = _inputs(c, seed=1)
    g = np.random.RandomState(2).randn(P, R).astype(np.float32)
    ref = _jax_grads(jpw.normalize_classify_fused, x, w, b, g, jl)
    out = _port_grads(tpw.normalize_classify_fused, x, w, b, g, tl)
    for name, a, o in zip(("dx", "dw", "db"), ref, out):
        assert o.shape == a.shape and o.dtype == a.dtype, name
        np.testing.assert_allclose(o, a, rtol=0, atol=2e-3, err_msg=name)
    assert np.abs(out[0]).max() > 0.0


@pytest.mark.parametrize("c", [35, 80])
def test_fused_nofeatgrad_grads_match_jax(c):
    jl, tl, x, w, b = _inputs(c, seed=3)
    g = np.random.RandomState(4).randn(P, R).astype(np.float32)
    ref = _jax_grads(jpw.normalize_classify_fused_nofeatgrad, x, w, b, g, jl)
    out = _port_grads(tpw.normalize_classify_fused_nofeatgrad, x, w, b, g, tl)
    np.testing.assert_allclose(out[1], ref[1], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(out[2], ref[2], rtol=2e-5, atol=1e-6)
    assert float(np.abs(out[0]).max()) == 0.0 == float(np.abs(ref[0]).max())


@pytest.mark.parametrize("c", [35, 80])
def test_weights_from_device_layout_matches_jax(c):
    jl, tl, _x, w, _b = _inputs(c, seed=5)
    perm = jpw._permutation(jl)
    valid = perm >= 0
    ref = np.zeros((jl.dim, R), np.float32)
    ref[perm[valid]] = w[valid]
    out = tpw.weights_from_device_layout(w, tl)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tpw.weights_to_device_layout(out, tl)[valid], w[valid]
    )
