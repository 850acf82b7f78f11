"""Run one benchmark cell once and print its result as the last line.

    python3 -m benchmark.run --workload frcnn-r101-c4.train --seed 7 \\
        --seconds 30 --trace 0

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown of device time and idle gaps. Every run checks what the
timed path produced against the plain reference and prints the numbers
compared, each beside its limit, as the last lines on standard error and
under ``compared`` in the line. Needs a CUDA device; exits nonzero and
prints no result without one, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import REPO, cell, jax_modules, load_json, run_cell

    import torch

    c = cell(load_json(REPO / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"benchmark: {args.workload} needs {c.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    t_imported = time.perf_counter()
    torch.empty(1, device="cuda")  # the context, created here so set-up's phases show it
    torch.cuda.synchronize()
    t_cuda = time.perf_counter()
    result, log = run_cell(c, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    log["phases"].update(imported=t_imported - T_START, cuda_init=t_cuda - t_imported)
    print("run: " + json.dumps(log), file=sys.stderr)
    loaded = jax_modules(list(sys.modules))
    if loaded:
        print(f"benchmark: JAX modules loaded in the run: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, row in result["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
