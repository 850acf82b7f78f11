"""Fused separable RoIAlign probe on one CUDA card: the fused kernel (T-roi
1) against the separable two-einsum forms.

    python -m tspn_tpu_torch.tools.bench_roialign_fused [--batch 4] [--rois 256]
        [--hw 40] [--channels 1024] [--dtype f32|bf16] [--device cuda]

Port of the JAX package's ``tools/bench_roialign_fused.py``. Legs, each
over the whole batch (RoI r of image b pools image b):

  sep       the shipped separable two-einsum (``roi_align_separable``), plain torch
  sep_b16t  the same with the intermediate cast to bf16, plain torch
  fused     T-roi 1 (``ops/roi_probes.py::roi_sep_fused``, ``csrc/roi_probes.cu``):
            8 RoIs a block share each load of the map; their intermediate is
            kept in shared memory 8 columns x 16 channels at a time

Inputs are the JAX tool's ``RandomState(0)`` draws (``roi_common.inputs``).
Before timing, ``fused`` is held to its plain version and, in f32, to
``roi_align_plain``; every leg's relative error against ``roi_align_plain``
(the JAX tool's ``parity``) is reported and gated as ``roi_common`` says.
Times are ``runtime.timing.times_ms`` (CUDA events on the card: median and
quartiles of 5 runs of 20 calls), each beside its bound (``timing.bound``:
bytes, or operations at the peak of their type: the fused form's stage 1
at the map's type, stage 2 in f32).

Not kept: ``--roi-tile`` (the TPU kernel's RoI tile; the card's kernel
fixes its own, reported as ``roi_tile`` and ``channel_tile``), ``--iters``
and ``--rounds`` (the interleaved timer's knobs; ``timing.times_ms`` fixes
its own), and the tag/carry chain against a remote runtime that memoizes
calls.

``--device cpu`` runs the plain versions on the host clock (use small
``--rois``/``--hw``/``--channels`` there). Prints one JSON line;
``main(argv)`` returns it as a dict; nothing runs at import.
"""

from __future__ import annotations

import json
import sys

from tspn_tpu_torch.ops import roi_probes as rp
from tspn_tpu_torch.tools import roi_common as rc
from tspn_tpu_torch.tools.rel_common import device, device_name


def main(argv=None) -> dict:
    args = rc.parser(__doc__.split("\n\n")[0]).parse_args(argv)
    dev = device(args.device, "bench_roialign_fused")
    dt = rc.DTYPES[args.dtype]
    name = device_name(dev)
    feats32, boxes = rc.inputs(args, dev)
    feats = feats32.to(dt)
    b, r, hw, c = args.batch, args.rois, args.hw, args.channels
    print(f"roialign_fused: {b} x {r} RoIs on {hw}x{hw}x{c} {args.dtype}, on {name}",
          file=sys.stderr, flush=True)

    oracle = rc.oracle(feats32, boxes)
    terms = rc.sum_terms(feats32, boxes)
    fused = lambda: rp.roi_sep_fused(feats, boxes)  # noqa: E731
    legs = {"sep": lambda: rc.sep(feats, boxes), "sep_b16t": lambda: rc.sep_b16t(feats, boxes),
            "fused": fused}
    outs = {k: fn() for k, fn in legs.items()}
    parity = {k: rc.rel_err(o, oracle) for k, o in outs.items()}
    parity["fused_vs_sep"] = rc.rel_err(outs["fused"], outs["sep"].float())
    gates = {}
    for k, o in outs.items():  # each leg against the f32 oracle
        exact = args.dtype == "f32" and k != "sep_b16t"
        gates[k] = rc.over_bound(o, oracle, terms, 1e-5 if exact else 2.0 ** -5)
    plain = rp.roi_sep_fused_plain(feats, boxes)
    gates["fused_vs_plain"] = rc.over_bound(outs["fused"], plain, terms, 1e-5,
                                            ulp=args.dtype == "bf16")
    del plain, oracle
    bad = {k: v for k, v in gates.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"roialign_fused: worst err/bound above 1: {bad}")

    s1, s2 = rc.sep_ops(b, r, hw, hw, c)
    kd = rc.kind(dt)
    ops = {"sep": {kd: s1 + s2}, "sep_b16t": rc.ops_by_kind((kd, s1), ("bf16", s2)),
           "fused": rc.ops_by_kind((kd, s1), ("f32", s2))}
    res = {"metric": "roialign_fused", "dtype": args.dtype, "batch": b, "rois": r,
           "hw": hw, "channels": c, "roi_tile": rp.SEP_ROI_TILE,
           "channel_tile": rp.SEP_CHANNEL_TILE, "device": name,
           "parity": parity, "worst_err_over_bound": gates}
    for k, fn in legs.items():
        t = rc.time_leg(fn, dev, (feats, boxes), outs[k], ops[k])
        res[f"{k}_ms"], res[f"{k}_iqr_ms"] = t["ms"], t["iqr_ms"]
        res[f"{k}_bound"] = {x: t[x] for x in ("bound_ms", "bound_by", "bytes", "ops")}
    res["fused_speedup_vs_sep"] = res["sep_ms"] / res["fused_ms"]
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
