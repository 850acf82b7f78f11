"""The port's RoIAlign plain versions against the JAX package's three
formulations (roi_align_pallas in interpret mode, roi_align_xla,
roi_align_separable) and the NumPy oracle of tests/test_roi_align.py.

Tolerance rtol = atol = 1e-5 on features in [0, 1): the formulations sum
the same bilinear terms in different orders (the Pallas kernel as one
matrix product per RoI), so they agree to a few f32 ulps, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.ops import roi_align as jra
from tspn_tpu_torch.ops import roi_align as tra

from test_roi_align import _oracle_roi_align

H, W, C = 20, 24, 8
# the boundary boxes of tests/test_roi_align.py
BOXES = np.array(
    [
        [2.0, 3.0, 10.0, 12.0],
        [-3.0, -2.0, 5.0, 6.0],      # hangs off the top-left
        [18.0, 14.0, 30.0, 26.0],    # hangs off the bottom-right
        [0.0, 0.0, 24.0, 20.0],      # whole map
        [5.0, 5.0, 5.0, 5.0],        # degenerate
        [-4.0, -3.0, 5.0, 6.0],
        [W - 6.0, H - 6.0, W + 4.0, H + 4.0],
        [-1.5, -1.0, 0.5, 21.0],     # samples in [-1, 0] along both axes
    ],
    np.float32,
)
GEOMETRIES = [(7, 2), (4, 1), (14, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def feat():
    return np.random.RandomState(0).rand(H, W, C).astype(np.float32)


def _port(fn, feat, boxes, out, s, idx=None):
    f = torch.from_numpy(feat)
    if idx is None:
        return fn(f, torch.from_numpy(boxes), None, out, s).numpy()
    return fn(f, torch.from_numpy(boxes), torch.from_numpy(idx), out, s).numpy()


@pytest.mark.parametrize("out,s", GEOMETRIES)
@pytest.mark.parametrize("jax_fn", ["roi_align_pallas", "roi_align_xla",
                                    "roi_align_separable"])
def test_plain_matches_jax(feat, out, s, jax_fn):
    ref = np.asarray(getattr(jra, jax_fn)(jnp.asarray(feat), jnp.asarray(BOXES), out, s))
    ours = _port(tra.roi_align_plain, feat, BOXES, out, s)
    assert ours.shape == ref.shape == (len(BOXES), out, out, C)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("out,s", GEOMETRIES)
def test_separable_matches_jax_separable_and_oracle(feat, out, s):
    ours = _port(tra.roi_align_separable, feat, BOXES, out, s)
    ref = np.asarray(jra.roi_align_separable(jnp.asarray(feat), jnp.asarray(BOXES), out, s))
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, _oracle_roi_align(feat, BOXES, out, s), **TOL)


@pytest.mark.parametrize("out,s", GEOMETRIES)
def test_plain_matches_oracle(feat, out, s):
    ours = _port(tra.roi_align_plain, feat, BOXES, out, s)
    np.testing.assert_allclose(ours, _oracle_roi_align(feat, BOXES, out, s), **TOL)


@pytest.mark.parametrize("fn", ["roi_align_plain", "roi_align_separable", "roi_align"])
def test_batch_with_image_index(fn):
    """Two images of one batch, RoIs interleaved between them: each RoI
    pools from its own image, as JAX does image by image."""
    rng = np.random.RandomState(3)
    feats = rng.rand(2, H, W, C).astype(np.float32)
    idx = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.int32)
    ours = _port(getattr(tra, fn), feats, BOXES, 7, 2, idx)
    for b in (0, 1):
        sel = idx == b
        ref = np.asarray(jra.roi_align_xla(jnp.asarray(feats[b]),
                                           jnp.asarray(BOXES[sel]), 7, 2))
        np.testing.assert_allclose(ours[sel], ref, **TOL)


def test_dispatch_on_cpu_runs_the_plain_version(feat):
    tra.reset_launches()
    f, b = torch.from_numpy(feat), torch.from_numpy(BOXES)
    out = tra.roi_align(f, b, None, 14, 2)
    assert tra.LAUNCHES == {"roi_align": 0, "roi_align_bf16": 0, "roi_align_backward": 0,
                            "roi_align_levels": 0, "roi_align_levels_backward": 0}
    assert torch.equal(out, tra.roi_align_plain(f, b, None, 14, 2))
    assert torch.equal(out, tra.roi_align(f[None], b, torch.zeros(len(BOXES),
                                                                  dtype=torch.int32)))


def test_dispatch_refuses_what_is_not_ported(feat):
    """A bf16 map now runs: on the CPU the dispatch pools ``f.float()`` and
    rounds once, and autograd carries a gradient back in bf16. Other
    float types and a batch without an image index still raise."""
    f, b = torch.from_numpy(feat), torch.from_numpy(BOXES)
    fb = f.bfloat16().requires_grad_(True)
    out = tra.roi_align(fb, b)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tra.roi_align_plain(f.bfloat16().float(), b).bfloat16())
    out.float().sum().backward()
    assert fb.grad.dtype == torch.bfloat16 and fb.grad.abs().sum() > 0
    assert tra.LAUNCHES["roi_align_bf16"] == 0
    with pytest.raises(TypeError):
        tra.roi_align(f.half(), b)
    with pytest.raises(ValueError):  # several images need an index per box
        tra.roi_align(torch.stack([f, f]), b)


def test_constant_feature_pools_to_the_constant():
    f = torch.full((1, 16, 16, 3), 2.5)
    b = torch.tensor([[2.0, 2.0, 10.0, 12.0]])
    out = tra.roi_align(f, b, torch.zeros(1, dtype=torch.int32), 7, 2)
    assert torch.allclose(out, torch.tensor(2.5), atol=1e-5)
