"""Micro-bench of the int8 pair scorers on one CUDA card: K1 (row-major
q8s), the raw int8 probe in three modes, and K6 (transposed q8t), at the
serve geometry.

    python -m tspn_tpu_torch.tools.bench_pair_kernels [--segments 96] [--device cuda]

Port of the JAX package's ``tools/bench_pair_kernels.py``. ``--segments``
segments of 32 x 31 = 992 ordered pairs give P rows (95,232 at the
default) of the VidVRD device layout (D 11,264: head pad 3072, then 8
BoW blocks of 1024), scored into R = 132 predicates. Each leg prints its
time per call (``runtime.timing.median_ms``: CUDA events on the card),
its Mpairs/s, and for the probe the GB/s of int8 rows it streams; the
legs run in the JAX tool's order: K1, the probe in ``stream`` (rows
0-31 only), ``onedot`` and ``blocks_noscale`` modes (the same kernel on
the card: the segment split has no cost there), then K6.

Weights are built exactly as the JAX tool builds them (``RandomState(0)``,
``randn(11070, 132) * 0.01``, ``weights_to_device_layout``,
``quantize_weights_percol``; the probe's (160, D) weights are ones). The
int8 rows (``randint(0, 128)`` with the layout's pad columns zeroed) and
the (P, 16) scales (9 uniform columns in [1e-4, 0.0101), 7 zero) come
from a ``torch.Generator`` on the device: they match the JAX tool in
distribution, not bit for bit. The transposed copies are made once,
outside the timing. Not ported: the tag/carry chaining and the weight
perturbation (the JAX tool's defence against a remote runtime that
memoizes repeated calls), and ``--tiles`` and the probe's column tiles
(Mosaic's ``col_tile``, which has no counterpart here).

``--device cpu`` runs the plain versions, timed on the host clock.
``main(argv)`` returns the legs' times; nothing runs at import.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT
from tspn_tpu_torch.ops import pairwise as pw
from tspn_tpu_torch.runtime import timing

NUM_PREDICATES = 132
PAIRS_PER_SEGMENT = 32 * 31
PROBE_ROWS = 160
SEED = 0


def build_inputs(segments: int, device: torch.device) -> dict:
    """The tool's operands on ``device``: weights from numpy as the JAX
    tool makes them, features and scales from a device generator."""
    lo = DEFAULT_LAYOUT
    p = segments * PAIRS_PER_SEGMENT
    rng = np.random.RandomState(SEED)
    w = (rng.randn(lo.dim, NUM_PREDICATES) * 0.01).astype(np.float32)
    qw, sw = pw.quantize_weights_percol(pw.weights_to_device_layout(w, lo))
    gen = torch.Generator(device=device).manual_seed(SEED)
    valid = torch.as_tensor(pw._permutation(lo) >= 0, dtype=torch.int8, device=device)
    x = torch.randint(0, 128, (p, lo.device_dim), generator=gen, device=device,
                      dtype=torch.int8)
    x.mul_(valid)
    scales = torch.zeros((p, 16), device=device)
    scales[:, :9] = torch.rand((p, 9), generator=gen, device=device) * 0.01 + 1e-4
    return {
        "x": x, "scales": scales,
        "xt": x.T.contiguous(), "scales_t": scales.T.contiguous(),
        "qw_t": torch.as_tensor(np.ascontiguousarray(qw.T), device=device),
        "sw": torch.as_tensor(sw, device=device),
        "b": torch.zeros(NUM_PREDICATES, device=device),
        "w_probe": torch.ones((PROBE_ROWS, lo.device_dim), dtype=torch.int8, device=device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", type=int, default=96)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_pair_kernels: no CUDA device (use --device cpu "
                         "to run the plain versions)")
    lo = DEFAULT_LAYOUT
    t = build_inputs(args.segments, dev)
    p, d = t["x"].shape
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"
    print(f"pairs/dispatch: {p}  width {d}  predicates {NUM_PREDICATES}  on {name}",
          flush=True)

    legs = {}

    def leg(label, fn, probe=False):
        ms = timing.median_ms(fn, dev)
        legs[label] = {"ms": ms, "mpairs_per_s": p / ms / 1e3}
        line = f"{label:22s} {ms:9.4f} ms  {p / ms / 1e3:9.3f} Mpairs/s"
        if probe:
            legs[label]["gb_per_s"] = p * d / ms / 1e6
            line += f"  {p * d / ms / 1e6:7.1f} GB/s"
        print(line, flush=True)

    leg("q8s", lambda: pw.normalize_classify_q8s(
        t["x"], t["scales"], t["qw_t"], t["sw"], t["b"], lo))
    for mode in pw.PROBE_MODES:
        leg(f"probe {mode}", lambda m=mode: pw.pair_probe(t["xt"], t["w_probe"], m),
            probe=True)
    leg("q8t", lambda: pw.normalize_classify_q8t(
        t["xt"], t["scales_t"], t["qw_t"], t["sw"], t["b"], lo))
    return {"device": name, "pairs": p, "width": d, "legs": legs}


if __name__ == "__main__":
    main(sys.argv[1:])
