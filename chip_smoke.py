"""Smoke run of the PyTorch port on one CUDA GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. report the card (nvidia-smi name and power limit) and versions;
2. build both kernels from their sources with nvcc, the two builds run
   side by side (a fresh checkout always builds; a second run loads the
   builds), and report the q8s build (tspn_tpu_torch/csrc/q8s.cu);
3. hold the q8s kernel against its plain PyTorch version at the three
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
5. serve q8: the same over expanded int8 rows, one launch per batch;
6. report the build of the fused_classify kernel
   (tspn_tpu_torch/csrc/fused_classify.cu);
7. hold the fused_classify kernel against its plain version (TF32 off)
   at the training geometry (P 7936, D 11264, R 132), at a ragged P
   (7923) and at the fused serve geometry (16 x 992 rows), each with zero
   padding rows and a zero BoW block, within
   |kernel - plain| <= 1e-5 * (|N(x)| @ |W| + |b|) + 1e-6 per element;
   time both with CUDA events;
8. serve fused f32: 48 synthetic segments (half at 32 tracklets) RAW in
   the device layout through predict_segments with the fused model in
   inference mode, kernel and plain in turns as in phase 4; the kernel
   must launch once per batch, and the top-k selections must be equal
   apart from entries whose score lies within 1e-6 of another's;
9. train fused: 24 steps over the same 48 labeled segments (batch 8,
   buckets [8, 16, 24, 32], Adam with warm-up and both milestones inside
   the 24 steps), once plain and once with the kernel from the same
   carried-across init; step 1 losses must agree to rtol 1e-4, every
   step to rtol 1e-3, the last loss must be below the first, and the
   kernel must launch once per step; a shorter kernel run under
   torch.profiler gives the device's busy share.

The kernel launches of the main path are counted from zero: q8s over
phases 4-5, fused_classify over phases 8-9. It prints the kernels' JSON
line, then as its last line {"ok": true, "device": {...}}. Without a
CUDA device it exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace as NS

import torch

SEED = 0
NUM_SEGMENTS = 96
SERVE = dict(buckets=(8, 16, 24, 32), batch_size=16, topk_per_pair=20,
             topk_per_seg=200, num_objects=35)
NUM_PREDICATES = 132
FEATURE_DIM = 11070
FUSED_SEGMENTS = 48
TRAIN_STEPS = 24
PROFILED_STEPS = 8
TRAIN = dict(buckets=(8, 16, 24, 32), batch_size=8, seed=SEED)
# configs/baseline.yaml's solver with the schedule cut to the 24 steps
SOLVER = NS(
    BASE_LR=1e-2, BIAS_LR_FACTOR=2, WEIGHT_DECAY=5e-4, WEIGHT_DECAY_BIAS=0.0,
    OPTIMIZER=NS(TYPE="adam", MOMENTUM=0.9),
    SCHEDULER=NS(TYPE="warmup_multi", MILESTONES=[12, 18], GAMMA=0.1,
                 WARMUP_FACTOR=1.0 / 3, WARMUP_ITERS=4, WARMUP_METHOD="linear"),
)
TIE_TOL = 1e-6
# fused_classify checks: (name, rows, zero padding rows); the training
# geometry is 8 segments x 992 pairs, the serve geometry 16 x 992
FUSED_CASES = (("train", 7936, 0), ("train_ragged", 7936 - 13, 40),
               ("serve", 16 * 992, 400))


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


def seeded_fused_model(dev, inference: bool):
    """The fused classifier's normal(0.01) init (device-layout kernel,
    zero bias) from a numpy seed, carried across from the JAX param-tree
    layout."""
    import numpy as np

    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT
    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

    rng = np.random.RandomState(SEED + 1)
    params = {"classifier": {
        "kernel": rng.normal(0, 0.01, (DEFAULT_LAYOUT.device_dim, NUM_PREDICATES)
                             ).astype(np.float32),
        "bias": np.zeros(NUM_PREDICATES, np.float32),
    }}
    model = build_model(NUM_PREDICATES, fused_classifier=True, inference=inference,
                        num_objects=SERVE["num_objects"])
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(dev)


def selection(out: dict) -> dict:
    """segment -> its top-k entries sorted by (-score, pair, pred)."""
    return {
        key: sorted(
            (-float(s), int(t[0]), int(t[1]), int(trip[1]))
            for s, trip, t in preds
        )
        for key, (preds, _iou, _tid) in out.items()
    }


def same_selection(kernel: dict, plain: dict) -> int:
    """Exact equality of two runs' selections -> 0 ties excluded."""
    if kernel != plain:
        diff = [k for k in kernel if kernel[k] != plain.get(k)]
        raise AssertionError(f"top-k differs from plain in {diff[:5]}")
    return 0


def same_selection_but_ties(kernel: dict, plain: dict) -> int:
    """Selections equal apart from near-ties at the cut: sorted scores
    agree within TIE_TOL, and an entry that only one run selected must
    score within TIE_TOL of the other run's last selected entry (it lost
    a tie there). -> the number of such entries."""
    if set(kernel) != set(plain):
        raise AssertionError("kernel and plain served different segments")
    swapped = 0
    for key in kernel:
        a, b = kernel[key], plain[key]
        if len(a) != len(b):
            raise AssertionError(f"{key}: {len(a)} vs {len(b)} selections")
        gap = max((abs(x[0] - y[0]) for x, y in zip(a, b)), default=0.0)
        if gap > TIE_TOL:
            raise AssertionError(f"{key}: sorted scores differ by {gap}")
        sa = {e[1:]: -e[0] for e in a}
        sb = {e[1:]: -e[0] for e in b}
        for only, mine, other in ((sa.keys() - sb.keys(), sa, sb),
                                  (sb.keys() - sa.keys(), sb, sa)):
            cut = min(other.values())
            for e in only:
                if mine[e] - cut > TIE_TOL:
                    raise AssertionError(
                        f"{key}: {e} scores {mine[e]}, above the other run's "
                        f"cut {cut} by more than {TIE_TOL}"
                    )
        swapped += len(sa.keys() ^ sb.keys())
    return swapped


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


def profile_run(fn) -> dict:
    """``fn()`` once under torch.profiler: device busy share and the
    largest device-side entries (kernels and copies; the CPU ops that
    launched them are left out so no time counts twice). A first, empty
    profile absorbs the tracer's start-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
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


def phase_serve(label: str, dataset, model, dev, kernel: str,
                launches_per_batch: int, compare=same_selection) -> dict:
    """predict_segments with the kernel and with the plain versions, in
    turns, after one untimed run of each; then one profiled kernel run."""
    from tspn_tpu_torch.data.loader import BucketedLoader
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.runtime.predict import predict_segments

    loader = BucketedLoader(dataset, SERVE["buckets"], SERVE["batch_size"],
                            dataset.feature_width(), SERVE["num_objects"])
    t0 = time.perf_counter()
    padded = sum(batch["feats"].shape[0] * batch["feats"].shape[1]
                 for _b, batch, _i, _r in loader)
    loader_s = time.perf_counter() - t0
    n_batches = len(loader)
    rows = sum(r.feats.shape[0] for r in dataset.records)
    feat_bytes = sum(r.feats.nbytes for r in dataset.records)
    log(f"serve {label}: {len(dataset)} segments, {rows} pairs "
        f"({padded} rows scored with padding), {feat_bytes / 1e9:.3f} GB of "
        f"pair rows, {n_batches} batches; batch assembly alone {loader_s:.3f} s")

    for variant in ("plain", "kernel"):  # warm-up, untimed
        predict_segments(model, dataset, device=dev, plain=variant == "plain", **SERVE)
    runs = {"plain": [], "kernel": []}
    outs = {}
    for variant in ("plain", "kernel", "kernel", "plain"):
        before = pw.LAUNCHES[kernel]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict_segments(model, dataset, device=dev,
                               plain=variant == "plain", **SERVE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = pw.LAUNCHES[kernel] - before
        want = launches_per_batch * n_batches if variant == "kernel" else 0
        if launched != want:
            raise AssertionError(
                f"serve {label} {variant}: {launched} {kernel} launches, want {want}"
            )
        check_output(out, dataset)
        runs[variant].append(len(dataset) / seconds)
        outs.setdefault(variant, selection(out))
        if selection(out) != outs[variant]:
            raise AssertionError(f"serve {label} {variant}: runs disagree")
    try:
        ties = compare(outs["kernel"], outs["plain"])
    except AssertionError as exc:
        raise AssertionError(f"serve {label}: {exc}") from None
    prof = profile_run(
        lambda: predict_segments(model, dataset, device=dev, **SERVE)
    )
    result = {"batches": n_batches, "pairs": rows, "rows_scored": padded,
              "feature_bytes": feat_bytes, "loader_s": loader_s,
              "near_ties_excluded": ties,
              "segments_per_s": statistics.median(runs["kernel"]),
              "plain_segments_per_s": statistics.median(runs["plain"]),
              "runs": runs, "profile": prof}
    log(f"serve {label}: top-k equal to plain in all {len(outs['kernel'])} "
        f"segments ({ties} near-tie entries excluded); "
        f"{launches_per_batch * n_batches} launches per run; "
        f"segments/s kernel {runs['kernel']} plain {runs['plain']}")
    log(f"serve {label} profile: {json.dumps(prof)}")
    return result


def phase_serve_q8(mode: str, model, dev, launches_per_batch: int) -> dict:
    from tspn_tpu_torch.data.synthetic import synthetic_segments

    t0 = time.perf_counter()
    dataset = synthetic_segments(NUM_SEGMENTS, mode, seed=SEED,
                                 num_objects=SERVE["num_objects"],
                                 num_predicates=NUM_PREDICATES)
    log(f"serve {mode}: generated in {time.perf_counter() - t0:.1f} s")
    return phase_serve(mode, dataset, model, dev, "q8s", launches_per_batch)


def raw_device_rows(p: int, zero_rows: int, gen, dev):
    """(p, 11264) f32 device-layout rows as the fused path reads them: a
    normal head, sparse BoW counts in each block's 1000 columns (slot
    padding zero), block 0 of row 0 all zero, and ``zero_rows`` zero
    padding rows at the end."""
    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT as lo

    x = torch.zeros((p, lo.device_dim), device=dev)
    x[:, : lo.dev_head_dim] = torch.randn((p, lo.dev_head_dim), generator=gen, device=dev)
    for k in range(lo.num_bow_blocks):
        s = lo.dev_head_pad + k * lo.dev_block
        counts = torch.randint(1, 6, (p, lo.bow_block_size), generator=gen, device=dev)
        hit = torch.rand((p, lo.bow_block_size), generator=gen, device=dev) < 0.02
        x[:, s : s + lo.bow_block_size] = (counts * hit).float()
    x[0, lo.dev_head_pad : lo.dev_head_pad + lo.dev_block] = 0
    if zero_rows:
        x[-zero_rows:] = 0
    return x


def phase_fused_check(dev) -> dict:
    """fused_classify vs its plain version within the part-4 bound."""
    from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT as lo
    from tspn_tpu_torch.ops import pairwise as pw

    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = torch.randn((lo.device_dim, NUM_PREDICATES), generator=gen, device=dev) * 0.01
    b = torch.randn((NUM_PREDICATES,), generator=gen, device=dev)
    report = {}
    for name, p, zero_rows in FUSED_CASES:
        x = raw_device_rows(p, zero_rows, gen, dev)
        out = pw.normalize_classify_fused_forward(x, w, b, lo)
        ref = pw.normalize_classify_fused_plain(x, w, b, lo)
        torch.cuda.synchronize()
        if out.shape != (p, NUM_PREDICATES) or not torch.isfinite(out).all():
            raise AssertionError(f"fused_classify {name}: bad output {tuple(out.shape)}")
        xn = pw._normalize_device_layout(x.double(), lo).abs()
        bound = 1e-5 * (xn @ w.double().abs() + b.double().abs()) + 1e-6
        del xn
        err = (out.double() - ref.double()).abs()
        worst = float((err / bound).max())
        max_err = float(err.max())
        if worst > 1.0:
            raise AssertionError(
                f"fused_classify {name}: |kernel - plain| exceeds the bound "
                f"(max err {max_err}, worst err/bound {worst})"
            )
        ms = cuda_median_ms(lambda: pw.normalize_classify_fused_forward(x, w, b, lo))
        plain_ms = cuda_median_ms(lambda: pw.normalize_classify_fused_plain(x, w, b, lo))
        flop = 2.0 * p * lo.device_dim * NUM_PREDICATES
        report[name] = {"rows": p, "width": lo.device_dim, "cols": NUM_PREDICATES,
                        "max_abs_err": max_err, "worst_err_over_bound": worst,
                        "ms": ms, "plain_ms": plain_ms,
                        "kernel_tflops": flop / ms / 1e9,
                        "plain_tflops": flop / plain_ms / 1e9}
        log(f"fused_classify {name}: P={p} D={lo.device_dim} R={NUM_PREDICATES} "
            f"max|err| {max_err:.3e} (worst err/bound {worst:.3f}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        del x, out, ref, err, bound
    return report


def phase_train(dataset, dev) -> dict:
    """Fused training, plain then kernel from the same init; then a
    shorter profiled kernel run."""
    from tspn_tpu_torch.ops import pairwise as pw
    from tspn_tpu_torch.runtime.train import train_segments

    def run(plain: bool, steps: int):
        model = seeded_fused_model(dev, inference=False)
        before = pw.LAUNCHES["fused_classify"]
        result = train_segments(model, dataset, solver=SOLVER, max_iter=steps,
                                device=dev, plain=plain, **TRAIN)
        launched = pw.LAUNCHES["fused_classify"] - before
        want = 0 if plain else steps
        if launched != want or result.step != steps:
            raise AssertionError(
                f"train {'plain' if plain else 'kernel'}: {launched} launches "
                f"over {result.step} steps, want {want} over {steps}"
            )
        return result

    results = {"plain": run(True, TRAIN_STEPS), "kernel": run(False, TRAIN_STEPS)}
    lp, lk = results["plain"].losses, results["kernel"].losses
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    if rel[0] > 1e-4 or max(rel) > 1e-3:
        raise AssertionError(f"train: kernel losses {lk} vs plain {lp}")
    if not (lk[-1] < lk[0] and lp[-1] < lp[0]):
        raise AssertionError(f"train: the loss did not fall: {lk}")
    prof = profile_run(lambda: run(False, PROFILED_STEPS))
    report = {"steps": TRAIN_STEPS, "batch": TRAIN["batch_size"],
              "losses_kernel": lk, "losses_plain": lp,
              "max_rel_loss_diff": max(rel), "profile_steps": PROFILED_STEPS,
              "profile": prof}
    for name, r in results.items():
        report[f"{name}_steps_per_s"] = r.step / r.seconds
        report[f"{name}_segments_per_s"] = r.step * TRAIN["batch_size"] / r.seconds
    log(f"train fused: {TRAIN_STEPS} steps, loss {lk[0]:.5f} -> {lk[-1]:.5f} "
        f"(plain {lp[0]:.5f} -> {lp[-1]:.5f}, max rel diff {max(rel):.2e}); "
        f"steps/s kernel {report['kernel_steps_per_s']:.3f} "
        f"plain {report['plain_steps_per_s']:.3f}")
    log(f"train fused profile ({PROFILED_STEPS} steps): {json.dumps(prof)}")
    return report


def build_kernels() -> None:
    """Both kernels' nvcc builds, started together."""
    from tspn_tpu_torch.ops import _cuda

    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(_cuda.q8s_library),
                   pool.submit(_cuda.fused_classify_library)]
        for f in futures:
            f.result()


def report_build(name: str) -> None:
    from tspn_tpu_torch.ops import _cuda

    built = _cuda.build_seconds.get(name)
    log(f"{name} from tspn_tpu_torch/csrc/{name}.cu for sm_90a: " + (
        f"built in {built:.2f} s" if built is not None
        else f"loaded the existing build in {_cuda.BUILD_DIR}"
    ))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tspn_tpu_torch.data.synthetic import synthetic_segments
    from tspn_tpu_torch.ops import pairwise as pw

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    build_kernels()
    report_build("q8s")

    checks = phase_kernel_check(dev)

    model = seeded_model(dev)
    pw.reset_launches()
    serve = {
        "q8f": phase_serve_q8("q8f", model, dev, launches_per_batch=2),
        "q8": phase_serve_q8("q8", model, dev, launches_per_batch=1),
    }
    q8s_launches = pw.LAUNCHES["q8s"]
    if q8s_launches == 0:
        raise AssertionError("the serve path launched no q8s kernel")
    del model

    report_build("fused_classify")
    fused_checks = phase_fused_check(dev)

    t0 = time.perf_counter()
    fused_data = synthetic_segments(FUSED_SEGMENTS, "f32dev", seed=SEED,
                                    num_objects=SERVE["num_objects"],
                                    num_predicates=NUM_PREDICATES)
    log(f"fused: {FUSED_SEGMENTS} labeled segments generated in "
        f"{time.perf_counter() - t0:.1f} s")
    pw.reset_launches()
    serve["fused_f32"] = phase_serve(
        "fused_f32", fused_data, seeded_fused_model(dev, inference=True).eval(), dev,
        "fused_classify", 1, compare=same_selection_but_ties,
    )
    train = phase_train(fused_data, dev)
    fused_launches = pw.LAUNCHES["fused_classify"]
    want = serve["fused_f32"]["batches"] * 4 + TRAIN_STEPS + PROFILED_STEPS
    log(f"fused_classify launches on the main path: {fused_launches} = "
        f"{serve['fused_f32']['batches']} batches x 4 kernel serve runs "
        f"(warm-up, two timed, profiled) + {TRAIN_STEPS} + {PROFILED_STEPS} "
        f"kernel training steps (timed, profiled)")
    if fused_launches != want:
        raise AssertionError(f"fused_classify launches {fused_launches}, want {want}")

    log(smi)
    log(json.dumps({"serve": serve, "train_fused": train,
                    "q8s_geometries": checks, "fused_geometries": fused_checks}))
    log(json.dumps({"kernels": [{
        "name": "q8s",
        "route": "cuda",
        "source": "tspn_tpu_torch/csrc/q8s.cu",
        "replaces": "tspn_tpu/ops/pairwise.py:481",
        "launches": q8s_launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": checks["rel"]["ms"],
        "plain_ms": checks["rel"]["plain_ms"],
    }, {
        "name": "fused_classify",
        "route": "cuda",
        "source": "tspn_tpu_torch/csrc/fused_classify.cu",
        "replaces": "tspn_tpu/ops/pairwise.py:1288",
        "launches": fused_launches,
        "max_abs_err": max(c["max_abs_err"] for c in fused_checks.values()),
        "ms": fused_checks["train"]["ms"],
        "plain_ms": fused_checks["train"]["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
