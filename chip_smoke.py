"""Smoke run of the PyTorch port on one CUDA GPU: build, check, serve.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. report the card (nvidia-smi name and power limit) and versions;
2. build the q8s kernel from tspn_tpu_torch/csrc/q8s.cu with nvcc (a
   fresh checkout always builds; a second run loads that build);
3. hold the kernel against its plain PyTorch version at the three
   geometries of the serve path (tracklet, rel, expanded), with ragged
   row counts: the results must be equal bit for bit (torch.equal);
   time both with CUDA events (median of 20 after 3 warm-ups);
4. serve q8f: 96 synthetic full-width VidVRD segments (C 35, R 132),
   buckets [8, 16, 24, 32], batch 16, top-k 20/200, weights from a seeded
   normal(0.01) init carried across with state_dict_from_jax; run
   predict_segments on the GPU with the kernel and with the plain
   versions, in turns (plain, kernel, kernel, plain) after one untimed
   run of each; the kernel must launch twice per batch and the top-k
   selections must be equal; one more kernel run under torch.profiler
   gives the device's busy share;
5. serve q8: the same over expanded int8 rows, one launch per batch.

It prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits nonzero
before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
NUM_SEGMENTS = 96
SERVE = dict(buckets=(8, 16, 24, 32), batch_size=16, topk_per_pair=20,
             topk_per_seg=200, num_objects=35)
NUM_PREDICATES = 132
FEATURE_DIM = 11070


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_check(dev) -> dict:
    """Kernel vs plain at the serve path's geometries; ragged P."""
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator().manual_seed(SEED)
    cases = [
        ("tracklet", pw.tracklet_geom(), 3072 - 7, 2 * NUM_PREDICATES),
        ("rel", pw.rel_geom(), 95232 - 29, NUM_PREDICATES),
        ("expanded", pw.BlockGeom(3072, 8, 1024), 4096 - 13, NUM_PREDICATES),
    ]
    report = {}
    for name, geom, p, r in cases:
        d = geom.device_dim
        q = torch.randint(-127, 128, (p, d), generator=gen, dtype=torch.int8)
        q[-50:] = 0  # padded batch rows are all-zero
        scales = torch.rand((p, 16), generator=gen) / 64
        qw_t = torch.randint(-127, 128, (r, d), generator=gen, dtype=torch.int8)
        sw = torch.rand((r,), generator=gen) / 127
        b = torch.randn((r,), generator=gen)
        args = [t.to(dev) for t in (q, scales, qw_t, sw, b)] + [geom]
        out = pw.normalize_classify_q8s(*args)
        ref = pw.normalize_classify_q8s_plain(*args)
        torch.cuda.synchronize()
        if out.shape != (p, r) or not torch.isfinite(out).all():
            raise AssertionError(f"q8s {name}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"q8s {name}: kernel != plain, max |err| {err}")
        ms = cuda_median_ms(lambda: pw.normalize_classify_q8s(*args))
        plain_ms = cuda_median_ms(lambda: pw.normalize_classify_q8s_plain(*args))
        report[name] = {"rows": p, "width": d, "cols": r, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms}
        log(f"q8s {name}: P={p} D={d} R={r} equal=True "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return report


def seeded_model(dev):
    """normal(0.01) classifier init from a numpy seed, carried across from
    the JAX param-tree layout as a JAX checkpoint would be."""
    import numpy as np

    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

    rng = np.random.RandomState(SEED)
    params = {"classifier": {"rel_predictor": {
        "kernel": rng.normal(0, 0.01, (FEATURE_DIM, NUM_PREDICATES)).astype(np.float32),
        "bias": np.zeros(NUM_PREDICATES, np.float32),
    }}}
    model = build_model(NUM_PREDICATES, FEATURE_DIM)
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(dev).eval()


def selection(out: dict) -> dict:
    """segment -> its top-k entries sorted by (-score, pair, pred)."""
    return {
        key: sorted(
            (-float(s), int(t[0]), int(t[1]), int(trip[1]))
            for s, trip, t in preds
        )
        for key, (preds, _iou, _tid) in out.items()
    }


def check_output(out: dict, dataset) -> None:
    """Every segment of >= 2 tracklets has min(200, 20 P) finite
    probabilities with in-range tracklet ids."""
    expected = {r.index: r for r in dataset.records if r.num_proposals > 1}
    if set(out) != set(expected):
        raise AssertionError("served segments differ from the dataset's")
    for key, (preds, _iou, _tid) in out.items():
        n = expected[key].num_proposals
        want = min(SERVE["topk_per_seg"], n * (n - 1) * SERVE["topk_per_pair"])
        if len(preds) != want:
            raise AssertionError(f"{key}: {len(preds)} predictions, want {want}")
        for score, trip, tids in preds:
            if not (0.0 <= score <= 1.0) or tids.min() < 0 or tids.max() >= n:
                raise AssertionError(f"{key}: bad entry {score} {trip} {tids}")
            if not 0 <= trip[1] < NUM_PREDICATES:
                raise AssertionError(f"{key}: bad predicate {trip}")


def profile_serve(model, dataset, dev) -> dict:
    """One kernel serve run under torch.profiler: device busy share and
    the largest device-side entries (kernels and copies; the CPU ops that
    launched them are left out so no time counts twice). A first, empty
    profile absorbs the tracer's start-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tspn_tpu_torch.runtime.predict import predict_segments

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        predict_segments(model, dataset, device=dev, **SERVE)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    rows = [
        (e.key, e.self_device_time_total / 1e3)
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _k, ms in rows)
    return {"wall_s": wall_s, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall_s * 1e3) if device_ms else None,
            "top_device_ms": rows[:6]}


def phase_serve(mode: str, model, dev, launches_per_batch: int) -> dict:
    from tspn_tpu_torch.data.loader import BucketedLoader
    from tspn_tpu_torch.data.synthetic import synthetic_segments
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.runtime.predict import predict_segments

    t0 = time.perf_counter()
    dataset = synthetic_segments(NUM_SEGMENTS, mode, seed=SEED,
                                 num_objects=SERVE["num_objects"],
                                 num_predicates=NUM_PREDICATES)
    gen_s = time.perf_counter() - t0
    loader = BucketedLoader(dataset, SERVE["buckets"], SERVE["batch_size"],
                            dataset.feature_width(), SERVE["num_objects"])
    t0 = time.perf_counter()
    padded = sum(batch["feats"].shape[0] * batch["feats"].shape[1]
                 for _b, batch, _i, _r in loader)
    loader_s = time.perf_counter() - t0
    n_batches = len(loader)
    rows = sum(r.feats.shape[0] for r in dataset.records)
    feat_bytes = sum(r.feats.nbytes for r in dataset.records)
    log(f"serve {mode}: {NUM_SEGMENTS} segments, {rows} pairs "
        f"({padded} rows scored with padding), {feat_bytes / 1e9:.3f} GB of "
        f"pair rows, {n_batches} batches; generated in {gen_s:.1f} s, "
        f"batch assembly alone {loader_s:.3f} s")

    for variant in ("plain", "kernel"):  # warm-up, untimed
        predict_segments(model, dataset, device=dev, plain=variant == "plain", **SERVE)
    runs = {"plain": [], "kernel": []}
    outs = {}
    for variant in ("plain", "kernel", "kernel", "plain"):
        before = pw.LAUNCHES["q8s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict_segments(model, dataset, device=dev,
                               plain=variant == "plain", **SERVE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = pw.LAUNCHES["q8s"] - before
        want = launches_per_batch * n_batches if variant == "kernel" else 0
        if launched != want:
            raise AssertionError(
                f"serve {mode} {variant}: {launched} q8s launches, want {want}"
            )
        check_output(out, dataset)
        runs[variant].append(len(dataset) / seconds)
        outs.setdefault(variant, selection(out))
        if selection(out) != outs[variant]:
            raise AssertionError(f"serve {mode} {variant}: runs disagree")
    if outs["kernel"] != outs["plain"]:
        diff = [k for k in outs["kernel"] if outs["kernel"][k] != outs["plain"][k]]
        raise AssertionError(f"serve {mode}: top-k differs from plain in {diff[:5]}")
    prof = profile_serve(model, dataset, dev)
    result = {"batches": n_batches, "pairs": rows, "rows_scored": padded,
              "loader_s": loader_s,
              "segments_per_s": statistics.median(runs["kernel"]),
              "plain_segments_per_s": statistics.median(runs["plain"]),
              "runs": runs, "profile": prof}
    log(f"serve {mode}: top-k equal to plain in all {len(outs['kernel'])} "
        f"segments; {launches_per_batch * n_batches} launches per run; "
        f"segments/s kernel {runs['kernel']} plain {runs['plain']}")
    log(f"serve {mode} profile: {json.dumps(prof)}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tspn_tpu_torch.ops import _cuda
    from tspn_tpu_torch.ops import pairwise as pw

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    _cuda.q8s_library()
    built = _cuda.build_seconds.get("q8s")
    log("q8s from tspn_tpu_torch/csrc/q8s.cu for sm_90a: " + (
        f"built in {built:.2f} s" if built is not None
        else f"loaded the existing build in {_cuda.BUILD_DIR}"
    ))

    checks = phase_kernel_check(dev)

    model = seeded_model(dev)
    pw.reset_launches()
    serve = {
        "q8f": phase_serve("q8f", model, dev, launches_per_batch=2),
        "q8": phase_serve("q8", model, dev, launches_per_batch=1),
    }
    launches = pw.LAUNCHES["q8s"]
    if launches == 0:
        raise AssertionError("the serve path launched no q8s kernel")

    log(smi)
    log(json.dumps({"serve": serve, "q8s_geometries": checks}))
    log(json.dumps({"kernels": [{
        "name": "q8s",
        "route": "cuda",
        "source": "tspn_tpu_torch/csrc/q8s.cu",
        "replaces": "tspn_tpu/ops/pairwise.py:481",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": checks["rel"]["ms"],
        "plain_ms": checks["rel"]["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
