"""Schedule probe of the rel pass on one CUDA card: K1's rel math
(``(f32(acc) * s[:, 0]) * sw + b``) under several block schedules and
ring depths, beside one PyTorch int8 product as the yardstick.

    python -m tspn_tpu_torch.tools.bench_rel_pipeline [--segments 96] [--legs p0,p4,...] [--device cuda]

Port of the JAX package's ``tools/bench_rel_pipeline.py``. ``--segments``
segments of 32 x 31 ordered pairs give P rows (95,232 at the default) of
D = 3,072 int8 columns with a (P, 16) f32 sidecar, scored into R = 132
predicates. Legs, each a launch of Kr (``ops/rel.py::rel_s8``, ``side``
epilogue) unless noted:

  p0_grid2    row grid (one block per 128-row tile), 2-stage ring (the
              double buffering of the JAX tool's default grid pipeline)
  p2_grid3    row grid, 3 stages (the JAX tool's ``Buffered(3)``)
  p3_grid4    row grid, 4 stages (``Buffered(4)`` with lookahead)
  p4_intmm    not a kernel of the port: ``torch._int_mm`` with W padded
              to 136 columns (its N must be a multiple of 8), then the
              epilogue in eager PyTorch; the counterpart of the JAX
              tool's plain-XLA leg, timed as the yardstick only
  p5_persist  persistent blocks (about one per SM slot) whose ring runs
              across row tiles, 2 stages, with the sidecar padded to 128
              columns as the JAX ``emit_pipeline`` leg pads it
  p6_ksplit2  K split across 2 blocks, int32 partials summed by the last
              block of each tile (bit-equal to no split), 2 stages
  p7_ksplit4  the same across 4 blocks

Parity gate (the JAX tool's, against its XLA oracle): every leg's first
result must equal the plain version (``rel_s8_plain``, float64 sums, the
kernel's fold) bit for bit, or the tool raises. Then each leg is timed
(``runtime.timing.median_ms``: CUDA events on the card) and its bound
printed (int8 operations against the int8 peak, or bytes; of the
sidecar only column 0, the row scale, is read). Weights come
from ``RandomState(0)`` exactly as the JAX tool draws them (the first 132
columns of its 256-wide draws); rows and sidecar from device generators
in its distributions (``rel_common.features``).

Dropped, with no Hopper counterpart:
- p1 (``dimension_semantics=("parallel",)``): Hopper blocks are always
  independent, so p1 is p0;
- the row tile (``--tile``): a Mosaic block shape; the kernel's tile is
  128 x 144, chosen for the card;
- ``--rounds`` and the tag/carry chains with the weight perturbation:
  the JAX tool's defence against a remote runtime that memoizes repeated
  calls; ``runtime.timing`` takes the median of its own runs.

``--device cpu`` takes the place of the JAX tool's ``--small``: it runs
the plain versions on the host and times them on the host clock (use
``--segments 2``, the JAX tool's 2,048 rows rounded to whole segments).
``main(argv)`` returns the legs; nothing runs at import.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tspn_tpu_torch.ops import rel
from tspn_tpu_torch.tools import rel_common as rc

# label -> Kr knobs (stages, schedule, ks, sidecar width); None: the library leg
KNOBS = {
    "p0_grid2": (2, "grid", 1, 16),
    "p2_grid3": (3, "grid", 1, 16),
    "p3_grid4": (4, "grid", 1, 16),
    "p4_intmm": None,
    "p5_persist": (2, "persistent", 1, 128),
    "p6_ksplit2": (2, "grid", 2, 16),
    "p7_ksplit4": (2, "grid", 4, 16),
}
LEGS = tuple(label.split("_")[0] for label in KNOBS)


def int_mm_rel(x, s, w_pad, sw, b) -> torch.Tensor:
    """The yardstick: ``torch._int_mm`` (x (P, D) @ w_pad (D, 136)), then
    the epilogue in eager PyTorch, in the kernel's order."""
    acc = torch._int_mm(x, w_pad)[:, : sw.shape[0]]
    return (acc.to(torch.float32) * s[:, 0:1]) * sw + b


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, default=rc.NUM_SEGMENTS)
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    want = set(args.legs.split(","))
    if want - set(LEGS):
        raise SystemExit(f"bench_rel_pipeline: unknown legs {sorted(want - set(LEGS))}")
    dev = rc.device(args.device, "bench_rel_pipeline")
    p = args.segments * rc.PAIRS_PER_SEGMENT
    name = rc.device_name(dev)
    print(f"pairs/dispatch: {p}  D={rc.D} R={rc.R}  on {name}", flush=True)

    rng = np.random.RandomState(0)
    w_t = rc.weights_t(rng.randint(-127, 128, (rc.D, rc.RP)).astype(np.int8), dev)
    sw = torch.as_tensor(rng.rand(rc.RP).astype(np.float32)[: rc.R] * 0.01, device=dev)
    b = torch.as_tensor(rng.rand(rc.RP).astype(np.float32)[: rc.R] * 0.1, device=dev)
    x, s16 = rc.features(p, dev)
    s128 = torch.zeros((p, 128), device=dev)
    s128[:, :16] = s16
    ops = 2.0 * p * rc.D * rc.R
    legs = rc.Legs(dev, p)

    for label, knobs in KNOBS.items():
        if label.split("_")[0] not in want:
            continue
        if knobs is None:
            w_pad = torch.zeros((rc.D, 136), dtype=torch.int8, device=dev)
            w_pad[:, : rc.R] = w_t.T
            legs.run(label, None, lambda: int_mm_rel(x, s16, w_pad, sw, b),
                     lambda: rel.rel_s8_plain(x, w_t, s16, sw, b, epilogue="side"),
                     (x, s16[:, :1], w_pad, sw, b), ops)
            continue
        stages, schedule, ks, width = knobs
        s = s16 if width == 16 else s128
        legs.run(label, "rel_s8",
                 lambda s=s, k=(stages, schedule, ks): rel.rel_s8(
                     x, w_t, s, sw, b, epilogue="side", stages=k[0], schedule=k[1], ks=k[2]),
                 lambda s=s: rel.rel_s8_plain(x, w_t, s, sw, b, epilogue="side"),
                 (x, s[:, :1], w_t, sw, b), ops)
    return {"device": name, "pairs": p, "width": rc.D, "predicates": rc.R, "legs": legs.legs}


if __name__ == "__main__":
    main(sys.argv[1:])
