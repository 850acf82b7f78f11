"""Stepwise probe of the rel pass on one CUDA card: the raw int8 product,
then each piece of K1's rel epilogue added in turn, then K1 itself.

    python -m tspn_tpu_torch.tools.bench_rel_steps [--segments 96] [--device cuda]

Port of the JAX package's ``tools/bench_rel_steps.py``. ``--segments``
segments of 32 x 31 ordered pairs give P rows (95,232 at the default) of
D = 3,072 int8 columns, scored into R = 132 predicates. Legs, each a
launch of Kr (``ops/rel.py::rel_s8``, row grid, 2-stage ring) unless
noted:

  v0_raw      int32 out
  v1_f32      f32 out, ``f32(acc) * sw + b``
  v2_side16   + the row scale, column 0 of a (P, 16) f32 sidecar
  v3_side128  as v2, the sidecar padded to (P, 128)
  v4_q8s      K1 (``pairwise.normalize_classify_q8s``, wgmma) at rel_geom

Each leg's first result is held ``torch.equal`` to its plain version,
then it is timed (``runtime.timing.median_ms``: CUDA events on the card)
and its bound printed (int8 operations against the int8 peak, or bytes;
of the sidecar only column 0, the row scale, is read).
Weights come from ``RandomState(0)`` exactly as the JAX tool draws them
(a (3072, 256) int8 draw whose first 132 columns are used, then the
scales); the int8 rows and the sidecar come from device generators in
the JAX tool's distributions (``rel_common.features``).

Dropped, with no Hopper counterpart:
- v5_vmem (``vmem_limit_bytes``): Hopper has no VMEM limit to raise;
- v6_slice (a 256-wide output sliced to 132) and v7_wpad (W padded to
  256 lanes): the kernels run R = 132 natively;
- the tag/carry chains and the weight perturbation: the JAX tool's
  defence against a remote runtime that memoizes repeated calls.

``--device cpu`` runs the plain versions, timed on the host clock (use
``--segments 1`` there). ``main(argv)`` returns the legs; nothing runs at
import.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tspn_tpu_torch.ops import pairwise as pw
from tspn_tpu_torch.ops import rel
from tspn_tpu_torch.tools import rel_common as rc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, default=rc.NUM_SEGMENTS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = rc.device(args.device, "bench_rel_steps")
    p = args.segments * rc.PAIRS_PER_SEGMENT
    name = rc.device_name(dev)
    print(f"pairs/dispatch: {p}  D={rc.D} R={rc.R}  on {name}", flush=True)

    rng = np.random.RandomState(0)
    w_t = rc.weights_t(rng.randint(-127, 128, (rc.D, rc.RP)).astype(np.int8), dev)
    sw = torch.as_tensor(rng.rand(1, rc.RP).astype(np.float32)[0, : rc.R] * 0.01, device=dev)
    sw_q8s = torch.as_tensor(rng.rand(rc.R).astype(np.float32) * 0.01, device=dev)
    b = torch.zeros(rc.R, device=dev)
    x, s16 = rc.features(p, dev)
    s128 = torch.zeros((p, 128), device=dev)
    s128[:, :16] = s16
    ops = 2.0 * p * rc.D * rc.R
    geom = pw.rel_geom()
    legs = rc.Legs(dev, p)

    legs.run("v0_raw", "rel_s8", lambda: rel.rel_s8(x, w_t),
             lambda: rel.rel_s8_plain(x, w_t), (x, w_t), ops)
    legs.run("v1_f32", "rel_s8", lambda: rel.rel_s8(x, w_t, None, sw, b, epilogue="f32"),
             lambda: rel.rel_s8_plain(x, w_t, None, sw, b, epilogue="f32"), (x, w_t, sw, b), ops)
    for label, s in (("v2_side16", s16), ("v3_side128", s128)):
        legs.run(label, "rel_s8", lambda s=s: rel.rel_s8(x, w_t, s, sw, b, epilogue="side"),
                 lambda s=s: rel.rel_s8_plain(x, w_t, s, sw, b, epilogue="side"),
                 (x, s[:, :1], w_t, sw, b), ops)
    legs.run("v4_q8s", "q8s", lambda: pw.normalize_classify_q8s(x, s16, w_t, sw_q8s, b, geom),
             lambda: pw.normalize_classify_q8s_plain(x, s16, w_t, sw_q8s, b, geom),
             (x, s16[:, :1], w_t, sw_q8s, b), ops)
    return {"device": name, "pairs": p, "width": rc.D, "predicates": rc.R, "legs": legs.legs}


if __name__ == "__main__":
    main(sys.argv[1:])
