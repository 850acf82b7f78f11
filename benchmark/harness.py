"""One cell run once: the cell's files found by name, its driver run, its
metrics read, its result line built.

``BENCHMARK.json`` names the cell; its configuration is
``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the driver,
``benchmark/drivers/<kind>.py``), its limits
``benchmark/limits/<workload>.json``, each per-layer metric's reader
``benchmark/metrics/<name>.py``, or ``<name up to its first dot>.py``
shared by the metric's forms, and the configuration's architecture
``benchmark/archs/<arch>.py`` (its ``"arch"`` key).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from benchmark import archs, compare
from benchmark.peaks import PEAK, PEAK_OF_DTYPE
from benchmark.trace import DeviceTrace, Tracer

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the traced window's longest length: collecting and reading the trace of a
# 51 s window took 2.5 to 3 minutes of a run (5.6 million events)
TRACED_SECONDS = 20.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> SimpleNamespace:
    """Everything one cell needs, found by the names in ``bench``."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if here(m) and m["moves"] in reported]
    return SimpleNamespace(
        name=workload, chips=entry["chips"],
        config=load_json(REPO / conf["file"]),
        traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(ROOT / "limits" / f"{workload}.json")["limits"],
        end_to_end=e2e, per_layer=per_layer)


class RunContext:
    """What a driver gets: the cell's files, the run's arguments, the
    program's factory, the tracer, and the device's clock and memory."""

    def __init__(self, c, seed: int, seconds: float, device, tracer: Tracer,
                 t_start: float, make_program: Callable, precision: str):
        self.config, self.traffic = c.config, c.traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.tracer, self.t_start = tracer, t_start
        self.make_program, self.precision = make_program, precision

    clock = staticmethod(time.perf_counter)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def windows(self, timed: Callable[[float, bool], dict]) -> dict:
        """``timed(seconds, traced)`` runs one window and returns its
        counts. The window that the rates and ``mfu`` read is untraced and
        lasts the run's seconds; with tracing on a traced one of at most
        ``TRACED_SECONDS`` follows it, whose counts the device-trace
        metrics read -> {"counts": ..., "traced_counts": ... or None}."""
        counts = timed(self.seconds, False)
        traced = timed(min(self.seconds, TRACED_SECONDS), True) if self.tracer.enabled else None
        return {"counts": counts, "traced_counts": traced}

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def driver(c):
    return importlib.import_module(f"benchmark.drivers.{c.traffic['kind']}")


def run_cell(c, seed: int, seconds: float, trace: bool, device, t_start: float,
             make_program: Optional[Callable] = None, precision: Optional[str] = None) -> dict:
    """Run the cell once -> (the result line's fields, ``compared`` last;
    the run's log: set-up phases, every number and where its worst lies)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    drv = driver(c)
    tracer = Tracer(trace)
    ctx = RunContext(c, seed, seconds, device, tracer, t_start,
                     make_program or drv.make_program,
                     precision or c.config["compute_dtype"])
    out = drv.run(ctx)
    correct, rows = compare.verdict(out["numbers"], c.limits, out["failed"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    log = {"setup_s": out["setup_s"], "window_s": out["counts"]["window_s"],
           "phases": out["phases"], "check_s": out["check_s"], "numbers": out["numbers"],
           "where": out["where"]}
    if trace:
        t0 = time.perf_counter()
        dt = DeviceTrace.from_profiler(tracer.prof)
        log["trace_events"] = len(dt.dev_name) + len(dt.host_name)
        dev["busy_s"], dev["window_s"] = dt.busy_s(), dt.window_s
        values = read_metrics(c, out, dt)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in c.per_layer if values.get(m["name"]) is not None}
        result["device"] = dev
        result["breakdown"] = {"device_ops": dt.device_ops(), "idle_gaps": dt.idle_gaps()}
        log["trace_read_s"] = time.perf_counter() - t0
    else:
        measured = {**out["end_to_end"], "setup_s": out["setup_s"]}
        result["metrics"] = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                             for m in c.end_to_end}
        result["device"] = dev
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, log


def metric_reader(name: str):
    """The module that reads metric ``name``: metrics/<name>.py, else
    metrics/<name up to its first dot>.py."""
    for stem in (name, name.split(".", 1)[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name} under {ROOT / 'metrics'}")


def metric_context(c, out: dict, dt: Optional[DeviceTrace]) -> SimpleNamespace:
    """What a metric reader gets: the configuration; the trace and the
    traced window's counts with the work they stand for (``work``: the
    architecture module's counts of one image or frame and of one step,
    times the window's; ``conv_flops`` and ``k7_bytes`` among them); the
    untraced window's counts, seconds and model operations, which the rates
    are measured on (the profiler slows the host); and the peaks of the
    configuration's compute type."""
    kind = c.traffic["kind"]
    train = kind == "train"
    per = archs.of(c.config).work(c.config, out["shapes"], train)
    unit_key, step_key = ("images", "steps") if train else ("frames", "batches")
    plain = out["counts"]
    counts = out.get("traced_counts") or plain
    units, steps = counts[unit_key], counts[step_key]
    work = {**{k: v * units for k, v in per["unit"].items()},
            **{k: v * steps for k, v in per["step"].items()}}
    return SimpleNamespace(
        kind=kind, config=c.config, trace=dt, counts=counts, units=units, steps=steps,
        work=work, conv_flops=work.get("conv_flops"), k7_bytes=work.get("k7_bytes"),
        rate_units=plain[unit_key], rate_window_s=plain["window_s"],
        model_flops=per["unit"]["model_flops"] * plain[unit_key],
        peak_flops=PEAK_OF_DTYPE[c.config["compute_dtype"]], peak_bytes=PEAK["bytes"])


def read_metrics(c, out: dict, dt: Optional[DeviceTrace]) -> Dict[str, Optional[float]]:
    mctx = metric_context(c, out, dt)
    return {m["name"]: metric_reader(m["name"]).read(mctx) for m in c.per_layer}


def jax_modules(names: List[str]) -> List[str]:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    banned = {"jax", "jaxlib", "flax", "tspn_tpu"}
    return sorted({n for n in names if n.split(".", 1)[0] in banned})
