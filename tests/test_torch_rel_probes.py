"""Parity of the port's rel-pass probe kernels (Kr, Kn, Ks4 in
``tspn_tpu_torch/ops/rel.py``) and tools with the JAX package's
``tools/bench_rel_{steps,pipeline,probe,int4}.py``.

The JAX kernels run under ``pltpu.force_tpu_interpret_mode()`` at P 64,
row tile 16 and the tools' module constants (D 3072, RP 256); the port
gets the same numpy-seeded operands, at R 256 and at R 132 against the
first 132 columns:

* int32 kernels (``raw_call``, ``mdma_call``, ``make_call("raw")``,
  ``nib_call``, ``i4_call``) equal the port's int32 plain versions
  exactly;
* f32 kernels (``make_call("f32"|"side")``, ``make_grid_call``,
  ``make_ksplit_call``, ``mdma_full_call``) agree with the port's f32
  plain versions within 1e-6 * (|acc * s * sw| + |b|) + 1e-6: the
  integer sums are exact on both sides, and interpret mode rounds the
  epilogue in XLA's fused order, an ulp away from the kernel's;
* ``make_emit_call`` does not run on the CPU: its leg (the ``side``
  epilogue over a 128-wide sidecar) is held to ``xla_rel`` instead;
* i4 x i4 equals the wrapped int64 product, as the JAX tool checks it.

Inside the port: the ``side`` plain version equals K1's
(``normalize_classify_q8s_plain`` at ``rel_geom``) bit for bit; the
packing helpers match the JAX tool's formulas; the dispatchers launch
nothing on the CPU and raise on another device or a bad knob. The JAX
``bench_rel_int4.main`` at 512 rows gives the same quantization keys as
the ported tool, and each ported tool runs every leg at ``--device cpu``.

The CUDA kernels are tested in tests/test_torch_rel_probes_gpu.py.
"""

import importlib.util
import json
import os
import sys
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tspn_tpu_torch.ops import pairwise as tpw
from tspn_tpu_torch.ops import rel
from tspn_tpu_torch.tools import (bench_rel_int4, bench_rel_pipeline, bench_rel_probe,
                                  bench_rel_steps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, TILE, D, RP = 64, 16, 3072, 256


def _jax_tool(name: str):
    """tools/<name>.py as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_STEPS, J_PIPE, J_PROBE = (_jax_tool(f"bench_rel_{n}") for n in ("steps", "pipeline", "probe"))


@lru_cache(maxsize=None)
def _operands():
    rng = np.random.RandomState(6)
    x = rng.randint(-128, 128, (P, D)).astype(np.int8)
    x[-3:] = 0
    x4 = rng.randint(-8, 8, (P, D)).astype(np.int8)
    w = rng.randint(-127, 128, (D, RP)).astype(np.int8)
    s16 = (rng.rand(P, 16) * 0.01 + 1e-4).astype(np.float32)
    s128 = np.zeros((P, 128), np.float32)
    s128[:, :16] = s16
    sw = (rng.rand(RP) * 0.01).astype(np.float32)
    b = (rng.rand(RP) * 0.1).astype(np.float32)
    return {"x": x, "x4": x4, "w": w, "s16": s16, "s128": s128, "sw": sw, "b": b}


def _jax_packed(x4):
    """The JAX probe's nibble packing (tools/bench_rel_probe.py:323-327)."""
    x = x4.astype(np.int32)
    return (((x[:, 1::2]) << 4) | (x[:, 0::2] & 0xF)).astype(np.int8)


JAX_INT32 = {
    "raw_call": lambda o: J_PROBE.raw_call(jnp.asarray(o["x"]), jnp.asarray(o["w"]), TILE),
    "mdma_call": lambda o: J_PROBE.mdma_call(jnp.asarray(o["x"]), jnp.asarray(o["w"]), TILE),
    "steps_raw": lambda o: J_STEPS.make_call("raw", TILE)(
        jnp.asarray(o["x"]), None, jnp.asarray(o["w"]), None),
    "nib_call": lambda o: J_PROBE.nib_call(
        jnp.asarray(_jax_packed(o["x4"])), jnp.asarray(o["w"][0::2]),
        jnp.asarray(o["w"][1::2]), TILE),
    "i4_call": lambda o: J_PROBE.i4_call(jnp.asarray(o["x4"], jnp.int4), jnp.asarray(o["w"]), TILE),
}


def _swb(o):
    return jnp.asarray(np.stack([o["sw"], o["b"]]))


JAX_F32 = {  # name -> (JAX call, port epilogue, sidecar key)
    "steps_f32": (lambda o: J_STEPS.make_call("f32", TILE)(
        jnp.asarray(o["x"]), None, jnp.asarray(o["w"]), _swb(o)), "f32", None),
    "steps_side16": (lambda o: J_STEPS.make_call("side", TILE, side_w=16)(
        jnp.asarray(o["x"]), jnp.asarray(o["s16"]), jnp.asarray(o["w"]), _swb(o)), "side", "s16"),
    "steps_side128": (lambda o: J_STEPS.make_call("side", TILE, side_w=128)(
        jnp.asarray(o["x"]), jnp.asarray(o["s128"]), jnp.asarray(o["w"]), _swb(o)),
        "side", "s128"),
    "grid": (lambda o: J_PIPE.make_grid_call(TILE)(*_pipe_args(o)), "side", "s16"),
    "grid_parallel": (lambda o: J_PIPE.make_grid_call(TILE, parallel=True)(*_pipe_args(o)),
                      "side", "s16"),
    "ksplit2": (lambda o: J_PIPE.make_ksplit_call(TILE, ks=2)(*_pipe_args(o)), "side", "s16"),
    "ksplit4": (lambda o: J_PIPE.make_ksplit_call(TILE, ks=4)(*_pipe_args(o)), "side", "s16"),
    "mdma_full": (lambda o: J_PROBE.mdma_full_call(
        jnp.asarray(o["x"]), jnp.asarray(o["s16"]), jnp.asarray(o["w"]),
        jnp.asarray(o["sw"][None]), jnp.asarray(o["b"][None]), TILE), "side", "s16"),
}


def _pipe_args(o):
    return [jnp.asarray(o[k]) for k in ("x", "s16", "w", "sw", "b")]


@lru_cache(maxsize=None)
def _jax_out(name: str) -> np.ndarray:
    call = JAX_INT32[name] if name in JAX_INT32 else JAX_F32[name][0]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(call(_operands()))


def _port(o, r):
    """The port's operands at R = r: K-major weights, first r columns."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in o.items()}
    t["w_t"] = torch.from_numpy(np.ascontiguousarray(o["w"][:, :r].T))
    t["sw"], t["b"] = t["sw"][:r].contiguous(), t["b"][:r].contiguous()
    return t


@pytest.mark.parametrize("r", [RP, 132])
@pytest.mark.parametrize("name", list(JAX_INT32))
def test_int32_kernels_equal_port_plain(name, r):
    o = _operands()
    t = _port(o, r)
    if name in ("nib_call", "i4_call"):
        xp = rel.pack_int4(t["x4"])
        got = rel.rel_s4x8(xp, *rel.split_even_odd(t["w_t"]))
    else:
        got = rel.rel_s8(t["x"], t["w_t"])
    assert got.dtype == torch.int32 and got.shape == (P, r)
    assert np.array_equal(got.numpy(), _jax_out(name)[:, :r])


@pytest.mark.parametrize("r", [RP, 132])
@pytest.mark.parametrize("name", list(JAX_F32))
def test_f32_kernels_match_port_plain(name, r):
    o = _operands()
    t = _port(o, r)
    _, epilogue, side = JAX_F32[name]
    s = t[side] if side else None
    got = rel.rel_s8(t["x"], t["w_t"], s, t["sw"], t["b"], epilogue=epilogue).numpy()
    acc = o["x"].astype(np.int64) @ o["w"][:, :r].astype(np.int64)
    scale = np.abs(o[side][:, :1]) if side else 1.0
    tol = 1e-6 * (np.abs(acc * scale * o["sw"][:r]) + np.abs(o["b"][:r])) + 1e-6
    assert got.shape == (P, r)
    assert (np.abs(got - _jax_out(name)[:, :r]) <= tol).all()


@pytest.mark.parametrize("side", ["s16", "s128"])
def test_side_plain_equals_k1_plain(side):
    t = _port(_operands(), 132)
    got = rel.rel_s8(t["x"], t["w_t"], t[side], t["sw"], t["b"], epilogue="side")
    k1 = tpw.normalize_classify_q8s_plain(t["x"], t["s16"], t["w_t"], t["sw"], t["b"],
                                          tpw.rel_geom())
    assert torch.equal(got, k1)


@pytest.mark.parametrize("r", [RP, 132])
def test_emit_leg_matches_xla_rel(r):
    """make_emit_call has no CPU interpret path: its leg (persistent,
    128-wide sidecar) is held to the JAX tool's XLA oracle."""
    o = _operands()
    t = _port(o, r)
    got = rel.rel_s8(t["x"], t["w_t"], t["s128"], t["sw"], t["b"], epilogue="side",
                     schedule="persistent", stages=2).numpy()
    ref = np.asarray(J_PIPE.xla_rel(*_pipe_args(o)))[:, :r]
    acc = o["x"].astype(np.int64) @ o["w"][:, :r].astype(np.int64)
    tol = 1e-6 * (np.abs(acc * o["s16"][:, :1] * o["sw"][:r]) + np.abs(o["b"][:r])) + 1e-6
    assert (np.abs(got - ref) <= tol).all()


@pytest.mark.parametrize("r", [RP, 132])
def test_i4xi4_equals_wrapped_product(r):
    o = _operands()
    t = _port(o, r)
    w4 = ((o["w"][:, :r].astype(np.int64) + 8) % 16) - 8  # bench_rel_int4.py:98-100
    ref = o["x4"].astype(np.int64) @ w4
    got = rel.rel_s4x4(rel.pack_int4(t["x4"]), rel.pack_int4(rel.wrap_int4(t["w_t"])))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)


def test_int4_helpers_match_the_jax_formulas():
    o = _operands()
    x4 = torch.from_numpy(o["x4"])
    packed = rel.pack_int4(x4)
    assert np.array_equal(packed.numpy(), _jax_packed(o["x4"]))
    lo, hi = rel.unpack_int4(packed)
    assert torch.equal(lo, x4[:, 0::2]) and torch.equal(hi, x4[:, 1::2])
    w = torch.from_numpy(o["w"].T.copy())
    assert np.array_equal(rel.wrap_int4(w).numpy(),
                          ((o["w"].T.astype(np.int64) + 8) % 16 - 8).astype(np.int8))
    even, odd = rel.split_even_odd(w)
    assert torch.equal(even, w[:, 0::2]) and torch.equal(odd, w[:, 1::2])
    with pytest.raises(ValueError):
        rel.pack_int4(torch.full((2, 4), 8, dtype=torch.int8))


@pytest.mark.parametrize("call", [
    lambda x, w: rel.rel_s8(x, w),
    lambda x, w: rel.rel_s4x8(x, w, w),
    lambda x, w: rel.rel_s4x4(x, w),
])
def test_dispatch_launches_nothing_on_cpu_and_refuses_other_devices(call):
    x = torch.zeros((4, 256), dtype=torch.int8)
    w = torch.zeros((3, 256), dtype=torch.int8)
    rel.reset_launches()
    assert call(x, w).shape == (4, 3)
    assert not any(rel.LAUNCHES.values())
    with pytest.raises(ValueError):
        call(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("knobs", [
    {"epilogue": "bf16"}, {"stages": 5}, {"schedule": "emit"}, {"ks": 3},
])
def test_rel_s8_refuses_unknown_knobs(knobs):
    x = torch.zeros((4, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        rel.rel_s8(x, x[:3], **knobs)


def test_int4_tool_quantization_keys_equal_the_jax_tools(monkeypatch, capsys):
    jax_int4 = _jax_tool("bench_rel_int4")
    monkeypatch.setattr(sys, "argv", ["bench_rel_int4.py", "--rows", "512", "--row_tile", "256",
                                      "--iters", "1", "--rounds", "1"])
    with pltpu.force_tpu_interpret_mode():
        jax_int4.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench_rel_int4.main(["--rows", "512", "--device", "cpu"])
    keys = [f"{b}_{k}" for b in ("int8", "int4") for k in ("rel_err", "top1_agree")]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert want["i8xi8_exact"] and want["i4xi8_exact"]
    assert all(got[f"{leg}_exact"] for leg in ("i8xi8", "i4xi8", "i4xi4"))


@pytest.mark.parametrize("tool,argv,legs", [
    (bench_rel_steps, ["--segments", "1"],
     ["v0_raw", "v1_f32", "v2_side16", "v3_side128", "v4_q8s"]),
    (bench_rel_pipeline, ["--segments", "1"],
     ["p0_grid2", "p2_grid3", "p3_grid4", "p4_intmm", "p5_persist", "p6_ksplit2",
      "p7_ksplit4"]),
    (bench_rel_probe, ["--segments", "1"], ["q8s", "raw", "mdma", "mdma_full", "nib", "int4"]),
    (bench_rel_int4, ["--rows", "256"], None),
], ids=["steps", "pipeline", "probe", "int4"])
def test_ported_tools_run_every_leg_on_cpu(tool, argv, legs):
    out = tool.main(argv + ["--device", "cpu"])
    if legs is None:
        assert all(out[f"{leg}_exact"] and out[f"{leg}_ms"] > 0
                   for leg in ("i8xi8", "i4xi8", "i4xi4"))
        return
    assert list(out["legs"]) == legs and out["pairs"] == 992
    assert all(v["equal"] and v["ms"] > 0 and v["bound_ms"] > 0 for v in out["legs"].values())


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (bench_rel_steps, bench_rel_pipeline, bench_rel_probe, bench_rel_int4):
        with pytest.raises(SystemExit):
            tool.main([])
