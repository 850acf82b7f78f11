"""int4 probe of the factored rel pass on one CUDA card: the (P, 3072) x
(3072, 132) product for int8 x int8, int4 x int8 and int4 x int4, each
checked against the exact int64 product and timed, and the quantization
error of int4 against int8 on sparse BoW-like rows.

    python -m tspn_tpu_torch.tools.bench_rel_int4 [--rows 95232] [--device cuda]

Port of the JAX package's ``tools/bench_rel_int4.py``. Legs:

  i8xi8  Kr (``ops/rel.py::rel_s8``), int32 out
  i4xi8  Kn (``rel_s4x8``): the rows packed two to a byte (column 2j in
         the low nibble) x W_even and W_odd
  i4xi4  Ks4 (``rel_s4x4``): packed rows x weights wrapped to int4 as
         ``astype(jnp.int4)`` wraps them, ((w + 8) mod 16) - 8, and packed

Operands are drawn from ``RandomState(0)`` in the JAX tool's order: the
rows ``randint(-7, 8, (rows, 3072))`` (drawn in blocks of rows, the same
sequence), then the (3072, 256) weight draw, whose first 132 columns are
used. So the quantization block that follows, copied from the JAX tool,
draws the same numbers, and ``int8_rel_err``, ``int4_rel_err`` and the
``top1_agree`` keys equal the JAX tool's at the same ``--rows``. Each
leg's result must equal the int64 product (the wrapped one for i4xi4),
or the tool raises; then it is timed (``runtime.timing.median_ms``: CUDA
events on the card) with its bound (i8xi8 by int8 operations against
the int8 peak or bytes; the int4 legs by bytes alone, since the card
publishes no int4 rate). It prints one JSON line.

Dropped, with no Hopper counterpart: ``--row_tile`` (a Mosaic block
shape; rows need not divide it), the ``*_compiles`` keys (the kernels
build or the tool raises), ``--iters`` and ``--rounds`` (``runtime.timing``
takes the median of its own runs), and the tag/carry chain with the
weight perturbation, the JAX tool's defence against a remote runtime
that memoizes repeated calls.

``--device cpu`` runs the plain versions, timed on the host clock (use
``--rows 512`` there). ``main(argv)`` returns the JSON object; nothing
runs at import.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tspn_tpu_torch.ops import rel
from tspn_tpu_torch.tools import rel_common as rc

DRAW_ROWS = 8192  # rows per block of the feature draw


def draw_rows(rng: np.random.RandomState, p: int) -> np.ndarray:
    """``rng.randint(-7, 8, (p, D))`` as int8, drawn in blocks of rows
    (the legacy generator gives the same sequence) so that no (p, D) int64
    array is held."""
    out = np.empty((p, rc.D), np.int8)
    for a in range(0, p, DRAW_ROWS):
        n = min(DRAW_ROWS, p - a)
        out[a : a + n] = rng.randint(-7, 8, (n, rc.D))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=rc.NUM_SEGMENTS * rc.PAIRS_PER_SEGMENT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = rc.device(args.device, "bench_rel_int4")
    p = args.rows
    name = rc.device_name(dev)

    rng = np.random.RandomState(0)
    x8 = torch.as_tensor(draw_rows(rng, p), device=dev)
    w8 = rng.randint(-127, 128, (rc.D, rc.RP)).astype(np.int8)
    w_t = rc.weights_t(w8, dev)
    xp = rel.pack_int4(x8)
    w_even, w_odd = rel.split_even_odd(w_t)
    w4p = rel.pack_int4(rel.wrap_int4(w_t))
    # the exact products, summed in float64 (|sum| < 2^23)
    ref = (x8.double() @ w_t.double().T).long()
    ref4 = (x8.double() @ rel.wrap_int4(w_t).double().T).long()

    out = {"metric": "rel_pass_int4_probe", "rows": p, "device": name}
    ops = 2.0 * p * rc.D * rc.R
    legs = {
        "i8xi8": ("rel_s8", lambda: rel.rel_s8(x8, w_t), ref, (x8, w_t), ops),
        "i4xi8": ("rel_s4x8", lambda: rel.rel_s4x8(xp, w_even, w_odd), ref,
                  (xp, w_even, w_odd), 0.0),
        "i4xi4": ("rel_s4x4", lambda: rel.rel_s4x4(xp, w4p), ref4, (xp, w4p), 0.0),
    }
    bench = rc.Legs(dev, p)
    for leg, (kernel, fn, want, operands, leg_ops) in legs.items():
        entry = bench.run(leg, kernel, fn, lambda want=want: want.to(torch.int32),
                          operands, leg_ops)
        out[f"{leg}_exact"] = True
        out[f"{leg}_ms"] = entry["ms"]
        out[f"{leg}_mpairs_s"] = entry["mpairs_per_s"]
        out[f"{leg}_bound_ms"] = entry["bound_ms"]
    del ref, ref4

    # int4 quantization error on realistic sparse BoW-like rows
    bow = rng.gamma(0.3, 1.0, (2048, rc.D)).astype(np.float32)
    bow[rng.rand(2048, rc.D) > 0.15] = 0  # ~85% sparse counts
    wf = rng.randn(rc.D, 132).astype(np.float32) * 0.01
    y_true = (bow / np.maximum(bow.sum(1, keepdims=True), 1e-9)) @ wf
    for bits, lim in (("int8", 127), ("int4", 7)):
        s = np.maximum(np.abs(bow).max(1, keepdims=True), 1e-9) / lim
        q = np.clip(np.rint(bow / s), -lim, lim)
        deq = q * s
        y = (deq / np.maximum(deq.sum(1, keepdims=True), 1e-9)) @ wf
        err = np.abs(y - y_true).max() / (np.abs(y_true).max() + 1e-9)
        top_agree = float(
            (y.argmax(1) == y_true.argmax(1)).mean()
        )
        out[f"{bits}_rel_err"] = round(float(err), 4)
        out[f"{bits}_top1_agree"] = round(top_agree, 4)

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
