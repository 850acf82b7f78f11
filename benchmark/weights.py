"""Seeded detector weights, made by the benchmark on the device.

One normal draw for every parameter that is drawn, folded into (-2, 2)
standard deviations and scaled per leaf, then split by name: a few large
calls, on the card, in float32 (the type the parameters are served in:
the bf16 configuration computes in bf16 over float32 parameters). Both the
program and the plain reference get these tensors, so the reference takes
no weight that the program made. The same seed and device give the same
weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import archs

# the cls_score bias of the first classes is raised, so that a seeded
# detector keeps detections as a trained one would (a seeded init scores
# every class near 1 / (C + 1), under the 0.05 threshold)
RAISED_CLASSES, RAISED_BIAS = 3, 3.0


def _std(p) -> float:
    if p.init[0] == "lecun":
        return math.sqrt(1.0 / math.prod(p.shape[1:]))
    return p.init[1]


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor (contiguous, NCHW for conv weights): every
    parameter of the configuration's architecture, in its draw order."""
    specs = archs.of(config).param_specs(config)
    drawn = [p for p in specs if p.init[0] in ("lecun", "normal")]
    counts = [math.prod(p.shape) for p in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(counts), generator=gen, device=device).fmod_(2.0)
    std = torch.tensor([_std(p) for p in drawn], device=device)
    flat.mul_(torch.repeat_interleave(std, torch.tensor(counts, device=device)))
    weights = {p.name: t.view(p.shape) for p, t in zip(drawn, flat.split(counts))}
    for p in specs:
        if p.init[0] == "ones":
            weights[p.name] = torch.ones(p.shape, device=device)
        elif p.init[0] == "zeros":
            weights[p.name] = torch.zeros(p.shape, device=device)
    weights["cls_score.bias"][:RAISED_CLASSES] = RAISED_BIAS
    return {p.name: weights[p.name] for p in specs}
