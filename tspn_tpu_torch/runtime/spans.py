"""Named host spans on the profiler's own clock.

``span(name)`` opens a range of the running ``torch.profiler`` at
FUNCTION scope, so it lands in the profiler's buffer beside the ATen ops,
on the clock of the device trace, and is not mirrored onto the device as a
user annotation. With no profiler running it returns one shared no-op
context: tracing is on exactly while a profiler is active.

The spans, and what reads them (PERF.md, section 3):

- ``tspn.nms``: one call of ``ops.nms.nms`` (on the card one sort and one
  kernel launch, on the CPU the whole blocked loop);
- ``tspn.nms.sync``: the blocked loop's host wait for ``running.any()``,
  once a block and once more to end a call (the CPU path only: the card's
  kernel makes no host sync);
- ``tspn.backbone``, ``tspn.rpn``, ``tspn.roi_head``, ``tspn.postprocess``:
  the detector's stages (``detection/rcnn.py``);
- ``tspn.fpn``, ``tspn.rpn.levels``, ``tspn.roi_levels``: the X101-FPN
  detector's levels (``detection/fpn.py``): the neck (after
  ``tspn.backbone``), the per-level top-k, decode, clip and level-offset
  NMS (inside ``tspn.rpn``), and the level assignment with the
  multi-level RoIAlign launch (inside ``tspn.roi_head``); the benchmark's
  ``levels_idle_share`` reads their union;
- ``tspn.h2d``, ``tspn.d2h``: the batch's copy to the card and the
  detections' readback;
- ``tspn.backward``, ``tspn.optimizer``: a training step's backward pass
  and its SGD and schedule step;
- ``tspn.input_wait``: ``train_detector``'s wait for the next batch.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_profiling = torch.autograd._profiler_enabled
OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else ``OFF``."""
    return _RecordFunctionFast(name) if _profiling() else OFF
