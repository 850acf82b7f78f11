"""Readings that a cell's limits are set from, and the control that has to
fail them.

The control is the plain reference put in the program's place and
computed one precision below the configuration's: TF32 operands for a
float32 configuration with TF32 off, scaled fp8 operands for a bfloat16
one. The faults are the timed path broken underneath the harness: a
training step that leaves the state unchanged, half of each batch left out
(the mean taken over the rest), one leaf's update left out (an answer
altered where it is produced); for detection half of each batch's frames
answered with nothing, and each batch's first frame's answer altered (its
boxes moved by 8 pixels).

    python3 -m benchmark.control --workload frcnn-r101-c4.train \\
        --seeds 101 102 ... --control-seeds 201 202 203 --faults

runs the cell once per seed, in one process and with the shortest window
that still times one step or one clip, and prints one JSON line a run:
every number, where its worst lies, and whether the run came out correct.
``--witness-seeds`` puts the reference at the configuration's own
precision, its convolutions in NCHW, in the program's place: what the
comparison reads for a sound program that rounds otherwise.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark import archs
from benchmark.reference.trainer import Trainer

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


class ControlTrainer:
    """The reference trainer at ``precision`` with the program's face."""

    def __init__(self, config, weights, device, traffic, precision: str, channels_last: bool):
        self.arch = archs.of(config)
        self.device, self.train = device, self.arch.port_configs(config)["train"]
        self.ref = Trainer(self.arch.reference(config, weights, precision, train=True,
                                               channels_last=channels_last), self.train)
        self.names = list(weights)

    def assembler(self):
        return self.arch.train_batch, self.train

    def step(self, batch) -> Dict[str, torch.Tensor]:
        from benchmark.drivers.train import to_device

        out = self.ref.step(to_device(batch, self.device))
        return {k: torch.tensor(v) for k, v in out.items()}

    def params(self):
        return {k: self.ref.model.w[k] for k in self.names}

    def first_update(self):
        return self.ref.first_update


class ControlDetector:
    """The reference detector at ``precision``, batch by batch as
    ``detect_video_frames`` runs, with numpy answers."""

    def __init__(self, config, weights, device, traffic, precision: str, channels_last: bool):
        self.device, self.bs = device, traffic["batch_size"]
        self.ref = archs.of(config).reference(config, weights, precision,
                                              channels_last=channels_last)

    def detect(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        outs = []
        for k in range(0, frames.shape[0], self.bs):
            out = self.ref.detect(torch.as_tensor(frames[k: k + self.bs], device=self.device))
            outs.append({n: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                         for n, v in out.items()})
        return {n: np.concatenate([o[n] for o in outs]) for n in outs[0]}


def control_factory(kind: str, precision: str, channels_last: bool = True):
    cls = ControlTrainer if kind == "train" else ControlDetector
    return lambda config, weights, device, traffic: cls(config, weights, device, traffic,
                                                        precision, channels_last)


# ------------------------------------------------------------------ faults
def _trainer_fault(fault: str):
    from benchmark.sut import ProgramTrainer

    class Faulty(ProgramTrainer):
        def step(self, batch):
            if fault == "half_batch":
                half = batch["image"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            if fault == "unchanged":
                return self.losses(batch)
            if fault == "altered":
                leaf = self.params()["cls_score.weight"]
                before = leaf.detach().clone()
                out = super().step(batch)
                with torch.no_grad():
                    leaf.copy_(before)
                return out
            return super().step(batch)

    return lambda config, weights, device, traffic: Faulty(config, weights, device)


def _detector_fault(fault: str):
    from benchmark.sut import ProgramDetector

    class Faulty(ProgramDetector):
        def detect(self, frames):
            out = {k: v.copy() for k, v in super().detect(frames).items()}
            for k in range(0, frames.shape[0], self.batch_size):
                if fault == "half_batch":
                    stop = k + self.batch_size
                    out["mask"][k + self.batch_size // 2: stop] = False
                    out["scores"][k + self.batch_size // 2: stop] = 0.0
                elif fault == "altered":
                    out["boxes"][k] += 8.0
            return out

    return lambda config, weights, device, traffic: Faulty(config, weights, device,
                                                           traffic["batch_size"])


FAULTS = {"train": ("unchanged", "half_batch", "altered"), "detect": ("half_batch", "altered")}


def fault_factory(kind: str, fault: str):
    return _trainer_fault(fault) if kind == "train" else _detector_fault(fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the program, the control "
                                 "and the faults for one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                    help="seeds on which the reference at the configuration's own "
                         "precision, its convolutions in NCHW, takes the program's place")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=0.001)
    args = ap.parse_args(argv)

    from benchmark.harness import REPO, cell, load_json, run_cell

    c = cell(load_json(REPO / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    kind = c.traffic["kind"]
    lower = LOWER[c.config["compute_dtype"]]
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control_" + lower, s, control_factory(kind, lower)) for s in args.control_seeds]
    own = c.config["compute_dtype"]
    runs += [("reference_nchw_" + own, s, control_factory(kind, own, channels_last=False))
             for s in args.witness_seeds]
    if args.faults:
        runs += [("fault_" + f, s, fault_factory(kind, f))
                 for f in FAULTS[kind] if f != "unchanged" for s in args.control_seeds]
    dev = torch.device("cuda", 0)
    for variant, seed, factory in runs:
        t0 = time.perf_counter()
        r, log = run_cell(c, seed, args.seconds, False, dev, t0, make_program=factory)
        print(json.dumps({"workload": c.name, "variant": variant, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "numbers": log["numbers"], "where": log["where"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
