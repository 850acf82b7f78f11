"""Detection traffic: frames from the traffic's content seed, ordered by the
run's seed, one clip of them through ``detect_video_frames`` after another
in the window.

Set-up makes the frames and the detector and warms the window's shapes with
one batch. After the window, with the program freed, the reference
detects a sample of batches (drawn from the seed) and every call's answer
for those frames is compared with it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import archs, compare
from benchmark.inputs import make_frames, seed_rng
from benchmark.weights import make_weights


def make_program(config, weights, device, traffic):
    from benchmark.sut import ProgramDetector

    return ProgramDetector(config, weights, device, traffic["batch_size"])


def shapes(config, traffic) -> dict:
    """The shapes the window runs, which the work is counted at."""
    det = archs.of(config).port_configs(config)["detection"]
    return {"canvas_hw": tuple(traffic["canvas_hw"]), "images_per_step": traffic["batch_size"],
            "rois_per_image": det["post_nms_topk_test"]}


def run(ctx) -> dict:
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    arch = archs.of(config)
    det = arch.port_configs(config)["detection"]
    bs = traffic["batch_size"]
    phases = {"start": ctx.clock() - ctx.t_start}
    # the weights and frames are the same in every run; the run's seed
    # orders the clip's frames and draws the batches checked
    content = traffic["content_seed"]
    frames = make_frames(traffic, content, device)
    frames = frames[seed_rng(ctx.seed, 5).permutation(frames.shape[0])]
    phases["inputs"] = ctx.clock() - ctx.t_start
    t = frames.shape[0]
    program = ctx.make_program(config, make_weights(config, content, device), device, traffic)
    ctx.sync()
    phases["model"] = ctx.clock() - ctx.t_start
    program.detect(frames[:bs])
    ctx.sync()
    setup_s = ctx.clock() - ctx.t_start

    calls = []

    def timed(seconds: float, traced: bool) -> dict:
        first = len(calls)
        with ctx.tracer.window(traced):
            t0 = ctx.clock()
            while ctx.clock() - t0 < seconds:
                with ctx.tracer.span("bench.detect_call"):
                    calls.append(program.detect(frames))
            t1 = ctx.clock()
        n = len(calls) - first
        return {"frames": n * t, "batches": n * (-(-t // bs)), "window_s": t1 - t0}

    windows = ctx.windows(timed)
    peak = ctx.memory_peak()
    del program
    ctx.free()

    t_check = ctx.clock()
    failed = sum(_bad(call, t) for call in calls)
    sample = seed_rng(ctx.seed, 4).choice(t // bs, size=traffic["sample_batches"], replace=False)
    ref = arch.reference(config, make_weights(config, content, device), ctx.precision)
    refs = {}
    for b in sorted(int(v) for v in sample):
        out = ref.detect(torch.as_tensor(frames[b * bs: (b + 1) * bs], device=device))
        refs[b] = {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                   for k, v in out.items()}
    numbers, where = compare.detect_numbers(calls, refs, bs, det["max_detections"],
                                     det["score_threshold"])
    counts = windows["counts"]
    return {"end_to_end": {"detect_frames_per_s": counts["frames"] / counts["window_s"]},
            "setup_s": setup_s, "phases": phases, "check_s": ctx.clock() - t_check,
            "attempted": len(calls) * t, "failed": failed,
            "numbers": numbers, "where": where, "memory_peak_bytes": peak, **windows,
            "shapes": shapes(config, traffic)}


def _bad(call, t: int) -> int:
    """Frames of one call's answer that are missing or not finite."""
    if any(len(v) != t for v in call.values()):
        return t
    boxes = np.asarray(call["boxes"], np.float64).reshape(t, -1)
    scores = np.asarray(call["scores"], np.float64).reshape(t, -1)
    return int((~(np.isfinite(boxes).all(axis=1) & np.isfinite(scores).all(axis=1))).sum())
