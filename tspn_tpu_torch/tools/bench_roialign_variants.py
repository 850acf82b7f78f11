"""RoIAlign kernel variants probe on one CUDA card: K7, the dense-G GEMM
with G built from the box (T-roi 2) or constant (T-roi 3), and the
separable forms.

    python -m tspn_tpu_torch.tools.bench_roialign_variants [--batch 4] [--rois 256]
        [--hw 40] [--channels 1024] [--dtype f32|bf16] [--device cuda]

Port of the JAX package's ``tools/bench_roialign_variants.py``. Legs,
each over the whole batch (RoI r of image b pools image b):

  grid      K7 (``ops/roi_align.py::roi_align``, ``csrc/roi_align.cu``: direct
            bilinear sampling), on f32 maps or, under ``--dtype bf16``, K7's
            bf16 half (f32 arithmetic, the output rounded once to bf16).
  constg    T-roi 3 (``ops/roi_probes.py::roi_constg``): G @ F with G the
            constant box_x0 * 1e-6, f32 out; the lower bound of the G form,
            not RoIAlign. ``torch.matmul`` with the constant G materialized
            is timed beside it (a yardstick the port never calls).
  selector  T-roi 2 (``roi_selector``): G (196, H*W) formed from the per-axis
            tables inside the kernel, G @ F with f32 sums over each image's
            RoIs stacked into one GEMM (CUDA cores in f32; in bf16
            ``wgmma`` bf16 -> f32 with F's slabs loaded by TMA and G formed
            in registers). The TPU kernel's one-hot selector matmuls only
            expanded the same tables and are dropped. ``torch.matmul`` of
            the selector's G, materialized once per image in the map's
            dtype, with F is timed beside it (``selector_library_ms``, a
            yardstick the port never calls).
  xlasep    the two-einsum separable form, plain torch
  xlasep2   the transpose-free separable form, plain torch

Inputs are the JAX tool's ``RandomState(0)`` draws. Before timing each
kernel leg is held to its plain version (and selector in f32 to
``roi_align_plain``, constg to its closed form), and every leg's relative
error against ``roi_align_plain`` is reported as ``parity_rel_err``; the
bounds are ``roi_common``'s. Times are ``runtime.timing.times_ms`` (CUDA
events on the card), each beside its bound.

Not kept: ``--iters`` and ``--rounds`` (the interleaved timer's knobs) and
the tag/carry chain against a remote runtime that memoizes calls.

``--device cpu`` runs the plain versions on the host clock (use small
sizes there). Prints one JSON line; ``main(argv)`` returns it as a dict;
nothing runs at import.
"""

from __future__ import annotations

import json
import sys

import torch

from tspn_tpu_torch.ops import roi_align as ra
from tspn_tpu_torch.ops import roi_probes as rp
from tspn_tpu_torch.tools import roi_common as rc
from tspn_tpu_torch.tools.rel_common import device, device_name


def main(argv=None) -> dict:
    args = rc.parser(__doc__.split("\n\n")[0]).parse_args(argv)
    dev = device(args.device, "bench_roialign_variants")
    dt = rc.DTYPES[args.dtype]
    name = device_name(dev)
    feats32, boxes = rc.inputs(args, dev)
    feats = feats32.to(dt)
    b, r, hw, c = args.batch, args.rois, args.hw, args.channels
    print(f"roialign_variants: {b} x {r} RoIs on {hw}x{hw}x{c} {args.dtype}, on {name}",
          file=sys.stderr, flush=True)
    idx = torch.arange(b, device=dev).repeat_interleave(r)

    def grid():
        out = ra.roi_align(feats, boxes.reshape(-1, 4), idx)
        return out.reshape(b, r, *out.shape[1:])

    legs = {"grid": grid,
            "constg": lambda: rp.roi_constg(feats, boxes),
            "selector": lambda: rp.roi_selector(feats, boxes),
            "xlasep": lambda: rc.xlasep(feats, boxes),
            "xlasep2": lambda: rc.xlasep2(feats, boxes)}
    outs = {k: fn() for k, fn in legs.items()}
    oracle = rc.oracle(feats32, boxes)
    terms = rc.sum_terms(feats32, boxes)
    parity = {k: rc.rel_err(o, oracle) for k, o in outs.items() if k != "constg"}
    gates = {}
    for k in ("grid", "selector", "xlasep", "xlasep2"):  # RoIAlign against the oracle
        gates[k] = rc.over_bound(outs[k], oracle, terms,
                                 1e-5 if args.dtype == "f32" else 2.0 ** -5)
    del oracle
    gates["selector_vs_plain"] = rc.over_bound(
        outs["selector"], rp.roi_selector_plain(feats, boxes), terms, 1e-5,
        ulp=args.dtype == "bf16")
    const_terms = rp.roi_constg_plain(feats32.abs(), boxes).abs()
    gates["constg_vs_closed_form"] = rc.over_bound(
        outs["constg"], rp.roi_constg_plain(feats, boxes), const_terms, 1e-5)
    bad = {k: v for k, v in gates.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"roialign_variants: worst err/bound above 1: {bad}")

    s1, s2 = rc.sep_ops(b, r, hw, hw, c)
    g_ops = rc.gemm_ops(b, r, hw, hw, c)
    ops = {"grid": {"f32": 0.0}, "constg": {rc.kind(dt): g_ops},
           "selector": {rc.kind(dt): g_ops}, "xlasep": {rc.kind(dt): s1 + s2},
           "xlasep2": {rc.kind(dt): s1 + s2}}
    res = {"metric": "roialign_variants", "dtype": args.dtype, "batch": b, "rois": r,
           "hw": hw, "channels": c, "device": name,
           "parity_rel_err": parity, "worst_err_over_bound": gates}
    for k, fn in legs.items():
        t = rc.time_leg(fn, dev, (feats, boxes), outs[k], ops[k])
        res[f"{k}_ms"], res[f"{k}_iqr_ms"] = t["ms"], t["iqr_ms"]
        res[f"{k}_bound"] = {x: t[x] for x in ("bound_ms", "bound_by", "bytes", "ops")}
    # one PyTorch call of each G form's function: its G, materialized once,
    # times the maps (out in the map's dtype)
    f2 = feats.reshape(b, hw * hw, c)
    for leg in ("constg", "selector"):
        g = rc.materialized_g(boxes, hw, hw, dt, const=leg == "constg")
        res[f"{leg}_library_ms"] = rc.time_leg(lambda: torch.matmul(g, f2), dev, (g, f2),
                                               outs[leg], ops[leg])["ms"]
        del g
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
