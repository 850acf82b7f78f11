"""Formulation probe of the factored rel pass on one CUDA card: K1, the
raw int8 product under two schedules, the product with K1's epilogue,
and int4 features packed two to a byte.

    python -m tspn_tpu_torch.tools.bench_rel_probe [--segments 96] [--legs q8s,raw,...] [--device cuda]

Port of the JAX package's ``tools/bench_rel_probe.py``. ``--segments``
segments of 32 x 31 ordered pairs give P rows (95,232 at the default) of
D = 3,072 int8 columns, scored into R = 132 predicates. Legs:

  q8s        K1 (``pairwise.normalize_classify_q8s``, wgmma) at rel_geom
  raw        Kr (``ops/rel.py::rel_s8``) int32 out, row grid, 2 stages
  mdma       Kr int32 out, persistent blocks with a 4-stage ring running
             across row tiles (the JAX tool's manual 4-slot DMA ring)
  mdma_full  Kr with K1's rel epilogue, ``(f32(acc) * s[:, 0]) * sw +
             b``, persistent, 4 stages
  nib        Kn (``rel_s4x8``): the rows clipped to [-8, 7] and packed
             two to a byte (column 2j in the low nibble), x W_even and
             W_odd -> int32
  int4       Kn on the same packed bytes: the JAX tool's ``jnp.int4``
             rows have that byte layout, so the two legs are one kernel

Each leg's first result is held ``torch.equal`` to its plain version,
then it is timed (``runtime.timing.median_ms``: CUDA events on the card)
and printed with Mpairs/s, the GB/s of its feature stream (halved for
the int4 legs, as the JAX tool does) and its bound (int8 operations
against the int8 peak; the int4 legs by bytes alone, since the card
publishes no int4 rate; of the sidecar only column 0, the row scale, is
read). Weights come from ``RandomState(0)`` exactly as
the JAX tool draws them (the first 132 columns of its 256-wide draws);
rows and sidecar from device generators in its distributions
(``rel_common.features``). Every leg runs by default (the JAX tool's
default leaves ``mdma_full`` out).

Dropped, with no Hopper counterpart:
- ``--tiles`` (the Mosaic row tiles, one leg per tile) and the rows
  padded to a multiple of 2,048 for them: the kernel's tile is 128 x 144
  and it masks the ragged edge;
- the VMEM limits and ``--rounds``, and the tag/carry chains with the
  weight perturbation: the JAX tool's defence against a remote runtime
  that memoizes repeated calls.

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

LEGS = ("q8s", "raw", "mdma", "mdma_full", "nib", "int4")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, default=rc.NUM_SEGMENTS)
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    want = set(args.legs.split(","))
    if want - set(LEGS):
        raise SystemExit(f"bench_rel_probe: unknown legs {sorted(want - set(LEGS))}")
    dev = rc.device(args.device, "bench_rel_probe")
    p = args.segments * rc.PAIRS_PER_SEGMENT
    name = rc.device_name(dev)
    print(f"pairs/dispatch: {p}  D={rc.D} R={rc.R}  on {name}", flush=True)

    rng = np.random.RandomState(0)
    w_t = rc.weights_t(rng.randint(-127, 128, (rc.D, rc.RP)).astype(np.int8), dev)
    sw = torch.as_tensor(rng.rand(rc.RP).astype(np.float32)[: rc.R] * 0.01, device=dev)
    b = torch.zeros(rc.R, device=dev)
    x, s16 = rc.features(p, dev)
    xp = rel.pack_int4(x.clamp(-8, 7))
    w_even, w_odd = rel.split_even_odd(w_t)
    ops = 2.0 * p * rc.D * rc.R
    feat = float(p * rc.D)
    geom = pw.rel_geom()
    legs = rc.Legs(dev, p)

    if "q8s" in want:
        legs.run("q8s", "q8s", lambda: pw.normalize_classify_q8s(x, s16, w_t, sw, b, geom),
                 lambda: pw.normalize_classify_q8s_plain(x, s16, w_t, sw, b, geom),
                 (x, s16[:, :1], w_t, sw, b), ops, feature_bytes=feat)
    for label, schedule, stages in (("raw", "grid", 2), ("mdma", "persistent", 4)):
        if label in want:
            legs.run(label, "rel_s8",
                     lambda k=(schedule, stages): rel.rel_s8(x, w_t, schedule=k[0], stages=k[1]),
                     lambda: rel.rel_s8_plain(x, w_t), (x, w_t), ops, feature_bytes=feat)
    if "mdma_full" in want:
        legs.run("mdma_full", "rel_s8",
                 lambda: rel.rel_s8(x, w_t, s16, sw, b, epilogue="side", schedule="persistent",
                                    stages=4),
                 lambda: rel.rel_s8_plain(x, w_t, s16, sw, b, epilogue="side"),
                 (x, s16[:, :1], w_t, sw, b), ops, feature_bytes=feat)
    for label in ("nib", "int4"):
        if label in want:
            legs.run(label, "rel_s4x8", lambda: rel.rel_s4x8(xp, w_even, w_odd),
                     lambda: rel.rel_s4x8_plain(xp, w_even, w_odd), (xp, w_even, w_odd), 0.0,
                     feature_bytes=feat / 2)
    return {"device": name, "pairs": p, "width": rc.D, "predicates": rc.R, "legs": legs.legs}


if __name__ == "__main__":
    main(sys.argv[1:])
