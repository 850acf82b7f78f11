"""Parity of the port's RoIAlign probes (T-roi, ``ops/roi_probes.py``)
and of its two ported tools with the JAX package's
``tools/bench_roialign_{fused,variants}.py``, on the CPU.

At H = W = 8, C 128, R 8 per image (two images for the port, which pools
the batch as the JAX tools' vmap does; image by image for JAX), with
random boxes and boxes across the map's border, in f32 and bf16:

* T-roi 1, ``roi_sep_fused_plain``, against ``_make_roi_align_sep_fused()``
  itself (it sets ``interpret`` on the CPU);
* T-roi 2, ``roi_selector_plain``, against the tool's own ``roi_selector``
  closure (reached by running its ``main`` with the timer stubbed and
  ``jax.jit`` recording what it wraps; the closure sets ``interpret`` on
  the CPU), against ``roi_align_pallas`` in interpret mode (the same G and
  the same dot) and, in f32, against ``roi_align_xla``;
* T-roi 3, ``roi_constg_plain`` (closed form: the constant times the
  map's sum), against the tool's ``roi_constg`` closure.

The plain versions, which the card tests hold the kernels to, are also
held at the kernels' tiling edges: one RoI and three on 9 x 11 and 11 x 9
maps (the fused and selector forms against ``roi_align_pallas`` in
interpret mode and ``roi_align_xla``, constg against its dense G @ F in
float64).

Tolerance: ``1e-5 * T + 1e-6`` with T the summed |term| of each output
(every weight is non-negative, so T is the function on |F|), plus one
bf16 ulp of the reference (``roi_common.bf16_ulp``) for a bf16 output. The bf16 selector is held
within ``2**-6 * T + 1e-6``: against the JAX kernels because XLA builds
the f32 tables in another rounding order (a division by a constant may
become a reciprocal multiply), so an entry of G near a bf16 midpoint
rounds one ulp (2**-7) apart, and the output rounds too; against the f32
``roi_align_xla`` because the map, G and the output each round to bf16
(2**-8 relative each). The
dispatches launch nothing on the CPU, refuse other devices, and the
ported tools run every leg at ``--device cpu`` and print the JAX tools'
keys. The CUDA kernels are tested in tests/test_torch_roi_probes_gpu.py.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.ops.roi_align import roi_align_pallas, roi_align_xla
from tspn_tpu_torch.ops import roi_probes as rp
from tspn_tpu_torch.tools import bench_roialign_fused, bench_roialign_variants, roi_common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, C, R, B = 8, 128, 8, 2
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _jax_tool(name: str):
    """tools/<name>.py as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, HW, HW, C).astype(np.float32)
    bx = rng.uniform(0, HW - 2, (B, R, 2))
    wh = rng.uniform(1, HW / 2, (B, R, 2))
    boxes = np.concatenate([bx, bx + wh], axis=-1).astype(np.float32)
    # across the border: samples in [-1, 0], past size - 1, and outside
    boxes[0, :3] = [[-1.5, -1.0, 3.0, 9.0], [6.0, 6.0, 12.0, 12.0], [-9.0, 2.0, -2.0, 5.0]]
    return feats, boxes


def _terms(feats, boxes):
    return rp.roi_sep_fused_plain(torch.from_numpy(np.abs(feats)), torch.from_numpy(boxes))


def _assert_within(out, ref, terms, rel=1e-5, ulp=False):
    d = np.asarray(ref, np.float64)
    ulps = roi_common.bf16_ulp(torch.from_numpy(d)).numpy() if ulp else 0.0
    tol = rel * terms.double().numpy() + 1e-6 + ulps
    err = np.abs(out.double().numpy() - d)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.fixture(scope="module")
def variant_closures():
    """The variants tool's roi_selector and roi_constg closures at H = W = 8,
    C 128: its ``main`` runs (parity gates included) with the timer stubbed,
    and ``jax.jit`` records the functions it wraps."""
    import bench

    tool = _jax_tool("bench_roialign_variants")
    seen = {}
    real_jit = jax.jit

    def recording_jit(fn=None, **kw):
        if fn is None:
            return lambda f: recording_jit(f, **kw)
        seen[getattr(fn, "__name__", "")] = real_jit(fn, **kw)
        return seen[fn.__name__]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", recording_jit)
    mp.setattr(bench, "_time_interleaved",
               lambda legs, **_kw: {name: [1e-3] for name in legs})
    mp.setattr(sys, "argv", ["bench_roialign_variants.py", "--batch", "1", "--rois", "8",
                             "--hw", str(HW), "--channels", str(C)])
    try:
        tool.main()
    finally:
        mp.undo()
    return seen["roi_selector"], seen["roi_constg"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sep_fused_matches_jax_kernel(dtype):
    tdt, jdt = DT[dtype]
    feats, boxes = _inputs(1)
    fused = _jax_tool("bench_roialign_fused")._make_roi_align_sep_fused()
    out = rp.roi_sep_fused(torch.from_numpy(feats).to(tdt), torch.from_numpy(boxes))
    assert out.dtype == tdt and out.shape == (B, R, 14, 14, C)
    assert not any(rp.LAUNCHES.values())
    terms = _terms(feats, boxes)
    for b in range(B):
        ref = fused(jnp.asarray(feats[b]).astype(jdt), jnp.asarray(boxes[b]),
                    output_size=14, sampling_ratio=2, roi_tile=8)
        _assert_within(out[b].float(), ref.astype(jnp.float32), terms[b], ulp=dtype == "bf16")
    if dtype == "f32":  # and RoIAlign itself
        from tspn_tpu_torch.tools import roi_common

        oracle = roi_common.oracle(torch.from_numpy(feats), torch.from_numpy(boxes))
        _assert_within(out, oracle.numpy(), terms)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_selector_matches_jax(dtype, variant_closures):
    tdt, jdt = DT[dtype]
    roi_selector, _ = variant_closures
    feats, boxes = _inputs(2)
    out = rp.roi_selector(torch.from_numpy(feats).to(tdt), torch.from_numpy(boxes))
    assert out.dtype == tdt and out.shape == (B, R, 14, 14, C)
    terms = _terms(feats, boxes)
    bf16 = dtype == "bf16"
    for b in range(B):
        f, bx = jnp.asarray(feats[b]).astype(jdt), jnp.asarray(boxes[b])
        for ref in (roi_selector(f, bx), roi_align_pallas(f, bx, output_size=14,
                                                          sampling_ratio=2)):
            _assert_within(out[b].float(), ref.astype(jnp.float32), terms[b],
                           rel=2.0 ** -6 if bf16 else 1e-5)
        xla = roi_align_xla(jnp.asarray(feats[b]), bx, output_size=14, sampling_ratio=2)
        _assert_within(out[b].float(), xla, terms[b], rel=2.0 ** -6 if bf16 else 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_constg_matches_jax_and_closed_form(dtype, variant_closures):
    tdt, jdt = DT[dtype]
    _, roi_constg = variant_closures
    feats, boxes = _inputs(3)
    out = rp.roi_constg(torch.from_numpy(feats).to(tdt), torch.from_numpy(boxes))
    assert out.dtype == torch.float32 and out.shape == (B, R, 14, 14, C)
    g = rp.constg_value(torch.from_numpy(boxes), tdt).float().numpy()
    col = torch.from_numpy(feats).to(tdt).float().abs().sum(dim=(1, 2)).numpy()
    terms = torch.from_numpy(np.abs(g)[:, :, None, None, None] * col[:, None, None, None, :]
                             * np.ones((1, 1, 14, 14, 1), np.float32))
    for b in range(B):
        ref = roi_constg(jnp.asarray(feats[b]).astype(jdt), jnp.asarray(boxes[b]))
        _assert_within(out[b], ref, terms[b])
    # every output row is the same closed form
    np.testing.assert_array_equal(out[:, :, 0, 0].numpy(), out[:, :, 13, 13].numpy())


# the GEMM kernels' tiling edges at CPU size: (RoIs, H, W) with H != W; one
# RoI is a single partial tile of stacked rows, three straddle RoIs
RAGGED = [(1, 9, 11), (3, 11, 9), (3, 9, 11)]


def _ragged_inputs(r, h, w, seed):
    """One (h, w, C) map and r boxes, the first across the border."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(1, h, w, C).astype(np.float32)
    lo = rng.uniform(0, [w - 2, h - 2], (1, r, 2))
    wh = rng.uniform(1, [w / 2, h / 2], (1, r, 2))
    boxes = np.concatenate([lo, lo + wh], axis=-1).astype(np.float32)
    boxes[0, 0] = [-1.5, -1.0, 3.0, h + 1.0]
    return feats, boxes


@pytest.mark.parametrize("geom", RAGGED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_selector_plain_at_ragged_geometries(dtype, geom):
    """roi_selector_plain, the card kernels' oracle, against roi_align_pallas
    (interpret mode) and roi_align_xla on non-square maps at R = 1 and 3."""
    r, h, w = geom
    tdt, jdt = DT[dtype]
    feats, boxes = _ragged_inputs(r, h, w, seed=5)
    out = rp.roi_selector_plain(torch.from_numpy(feats).to(tdt), torch.from_numpy(boxes))
    assert out.dtype == tdt and out.shape == (1, r, 14, 14, C)
    terms = _terms(feats, boxes)[0]
    rel = 2.0 ** -6 if dtype == "bf16" else 1e-5
    bx = jnp.asarray(boxes[0])
    pallas = roi_align_pallas(jnp.asarray(feats[0]).astype(jdt), bx, output_size=14,
                              sampling_ratio=2)
    _assert_within(out[0].float(), pallas.astype(jnp.float32), terms, rel=rel)
    xla = roi_align_xla(jnp.asarray(feats[0]), bx, output_size=14, sampling_ratio=2)
    _assert_within(out[0].float(), xla, terms, rel=rel)


@pytest.mark.parametrize("geom", RAGGED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sep_fused_plain_at_ragged_geometries(dtype, geom):
    """roi_sep_fused_plain, the fused kernel's oracle, against
    roi_align_pallas (interpret mode) and roi_align_xla on non-square maps
    at R = 1 and 3 (in bf16 within 2**-6 * T: wy, wx, the map and the
    output each round to bf16)."""
    r, h, w = geom
    tdt, jdt = DT[dtype]
    feats, boxes = _ragged_inputs(r, h, w, seed=7)
    out = rp.roi_sep_fused_plain(torch.from_numpy(feats).to(tdt), torch.from_numpy(boxes))
    assert out.dtype == tdt and out.shape == (1, r, 14, 14, C)
    terms = _terms(feats, boxes)[0]
    rel = 2.0 ** -6 if dtype == "bf16" else 1e-5
    bx = jnp.asarray(boxes[0])
    pallas = roi_align_pallas(jnp.asarray(feats[0]).astype(jdt), bx, output_size=14,
                              sampling_ratio=2)
    _assert_within(out[0].float(), pallas.astype(jnp.float32), terms, rel=rel)
    xla = roi_align_xla(jnp.asarray(feats[0]), bx, output_size=14, sampling_ratio=2)
    _assert_within(out[0].float(), xla, terms, rel=rel)


@pytest.mark.parametrize("geom", RAGGED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_constg_plain_at_ragged_geometries(dtype, geom):
    """roi_constg_plain (closed form) against the dense G @ F it stands for,
    G materialized and the product taken in float64, on non-square maps at
    R = 1 and 3."""
    r, h, w = geom
    tdt, _ = DT[dtype]
    feats, boxes = _ragged_inputs(r, h, w, seed=6)
    f = torch.from_numpy(feats).to(tdt)
    out = rp.roi_constg_plain(f, torch.from_numpy(boxes))
    assert out.dtype == torch.float32 and out.shape == (1, r, 14, 14, C)
    g = rp.constg_value(torch.from_numpy(boxes), tdt).double()[0]  # (r,)
    dense_g = g[:, None, None].expand(r, 14 * 14, h * w)
    f2 = f.double().reshape(h * w, C)
    ref = (dense_g @ f2).reshape(1, r, 14, 14, C)
    terms = (dense_g.abs() @ f2.abs()).reshape(1, r, 14, 14, C)
    _assert_within(out, ref.numpy(), terms)


def test_dispatch_refuses_bad_operands():
    feats, boxes = _inputs(4)
    f, bx = torch.from_numpy(feats), torch.from_numpy(boxes)
    with pytest.raises(ValueError):
        rp.roi_selector(f.to("meta"), bx.to("meta"))
    with pytest.raises(TypeError):
        rp._gemm_cuda(f.half(), bx, False)
    with pytest.raises(ValueError):
        rp._gemm_cuda(f[..., :96].contiguous(), bx, False)
    with pytest.raises(ValueError):
        rp._sep_fused_cuda(f, bx[:1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tools_run_on_cpu(dtype, capsys):
    small = ["--device", "cpu", "--batch", "2", "--rois", "8", "--hw", str(HW),
             "--channels", str(C), "--dtype", dtype]
    fused = bench_roialign_fused.main(small)
    assert {"sep_ms", "sep_b16t_ms", "fused_ms", "parity", "fused_speedup_vs_sep",
            "fused_bound"} <= set(fused)
    assert all(v <= 1.0 for v in fused["worst_err_over_bound"].values())
    variants = bench_roialign_variants.main(small)
    for leg in ("constg", "selector", "xlasep", "xlasep2"):
        assert variants[f"{leg}_ms"] > 0 and variants[f"{leg}_bound"]["bound_ms"] > 0
    assert variants["grid_ms"] > 0 and variants["grid_bound"]["bound_ms"] > 0
    assert variants["constg_library_ms"] > 0 and variants["selector_library_ms"] > 0
    assert all(v <= 1.0 for v in variants["worst_err_over_bound"].values())
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 2
