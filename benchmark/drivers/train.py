"""Training traffic: records from the traffic's content seed; one epoch of
batches in an order drawn from the run's seed, assembled by the program's
``make_batch`` in set-up; ``detector_train_step`` on them in turn through
the window, losses read back every ``readback_every`` steps. The rate
leaves out the batches' assembly, which set-up does (PERF.md, section 4).

Set-up builds the one training object (model, SGD, schedule), drives its
first ``check_steps`` steps through the window's own call on the epoch's
first batches (their images all differ) and keeps what the check needs:
each step's losses, each leaf's first update direction (SGD's momentum
buffer after step 1) and its change over those steps. The same object
then runs the window. After the window, with the program freed, the
reference follows those steps from the same weights and records.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark import archs, compare
from benchmark.inputs import epoch_batches, make_records
from benchmark.reference.trainer import Trainer
from benchmark.weights import make_weights


def read_back(entries: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Device losses of several steps -> floats, in one transfer."""
    if not entries:
        return []
    keys = list(entries[0])
    rows = torch.stack([torch.stack([e[k].float() for k in keys]) for e in entries]).tolist()
    return [dict(zip(keys, row)) for row in rows]


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {"image": torch.as_tensor(batch["image"], device=device),
            "gt_boxes": torch.as_tensor(batch["gt_boxes"], device=device),
            "gt_classes": torch.as_tensor(batch["gt_classes"], device=device).long(),
            "gt_mask": torch.as_tensor(batch["gt_mask"], device=device)}


def make_program(config, weights, device, traffic):
    from benchmark.sut import ProgramTrainer

    return ProgramTrainer(config, weights, device)


def shapes(config, traffic) -> dict:
    """The shapes the window runs, which the work is counted at: a batch's
    canvas, padded from the largest train size."""
    pc = archs.of(config).port_configs(config)
    t = pc["train"]
    pad = t["pad_multiple"]
    return {"canvas_hw": (-(-t["min_size"] // pad) * pad, -(-t["max_size"] // pad) * pad),
            "images_per_step": t["ims_per_batch"],
            "rois_per_image": pc["detection"]["roi_batch_size"]}


def run(ctx) -> dict:
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    arch = archs.of(config)
    pc = arch.port_configs(config)
    per = pc["train"]["ims_per_batch"]
    phases = {"start": ctx.clock() - ctx.t_start}
    # the weights and images are the same in every run; the run's seed
    # orders the batches, so every seed times the same work
    content = traffic["content_seed"]
    records = make_records(traffic, pc["detection"]["num_classes"], content)
    phases["inputs"] = ctx.clock() - ctx.t_start
    program = ctx.make_program(config, make_weights(config, content, device), device, traffic)
    # one epoch's batches, assembled by the program's make_batch here in
    # set-up: assembly on a thread beside the steps made the window's rate
    # swing with the interpreter lock (PERF.md, section 4)
    assemble, arg = program.assembler()
    order = epoch_batches(len(records), per, ctx.seed)
    if len(order) < traffic["check_steps"]:
        raise ValueError("an epoch must hold the checked steps' batches")
    batches = [assemble([records[i] for i in idx], arg) for idx in order]
    ctx.sync()
    phases["model"] = ctx.clock() - ctx.t_start
    start = {k: v.detach().clone() for k, v in program.params().items()}
    check = []
    for i in range(traffic["check_steps"]):
        check.append(program.step(batches[i]))
        if i == 0:
            prog_first = compare.leaf_norms(program.first_update())
            phases["first_step"] = ctx.clock() - ctx.t_start
    prog_change = compare.leaf_norms(
        {k: p.detach() - start[k] for k, p in program.params().items()})
    del start
    prog_losses = read_back(check)
    ctx.sync()
    setup_s = ctx.clock() - ctx.t_start

    done, failed = 0, 0  # steps of the windows so far; steps whose losses were not finite

    def timed(seconds: float, traced: bool) -> dict:
        nonlocal done, failed
        steps, pending = 0, []
        with ctx.tracer.window(traced):
            t0 = ctx.clock()
            while ctx.clock() - t0 < seconds:
                with ctx.tracer.span("bench.step"):
                    pending.append(program.step(
                        batches[(traffic["check_steps"] + done + steps) % len(batches)]))
                steps += 1
                if steps % traffic["readback_every"] == 0:
                    with ctx.tracer.span("bench.readback"):
                        failed += _bad(read_back(pending))
                    pending.clear()
            with ctx.tracer.span("bench.readback"):
                failed += _bad(read_back(pending))
            t1 = ctx.clock()
        done += steps
        return {"steps": steps, "images": steps * per, "window_s": t1 - t0}

    windows = ctx.windows(timed)
    peak = ctx.memory_peak()
    del program
    ctx.free()

    t_check = ctx.clock()
    ref = Trainer(arch.reference(config, make_weights(config, content, device), ctx.precision,
                                 train=True), pc["train"])
    ref_losses = [ref.step(to_device(arch.train_batch([records[i] for i in idx], pc["train"]),
                                     device)) for idx in order[:traffic["check_steps"]]]
    numbers, where = compare.train_numbers(
        prog_losses, ref_losses, prog_first, compare.leaf_norms(ref.first_update),
        prog_change, compare.leaf_norms(ref.change()), compare.leaf_norms(ref.first_grad))
    counts = windows["counts"]
    return {"end_to_end": {"train_images_per_s": counts["images"] / counts["window_s"]},
            "setup_s": setup_s, "phases": phases, "check_s": ctx.clock() - t_check,
            "attempted": done, "failed": failed, "numbers": numbers, "where": where,
            "memory_peak_bytes": peak, **windows, "shapes": shapes(config, traffic)}


def _bad(losses: List[Dict[str, float]]) -> int:
    return sum(not all(math.isfinite(v) for v in step.values()) for step in losses)
