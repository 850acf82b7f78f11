"""Front-end pipeline (counterpart of tspn_tpu/pipeline.py): frames ->
detections. Only the detector stage is ported so far; the tracker, the
re-ID encoder and the feature extraction come later.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tspn_tpu_torch.runtime.spans import span


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A detection tensor on the host; bfloat16 widened exactly to float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def detect_video_frames(
    model, frames: np.ndarray, *, device, batch_size: int = 8
) -> Dict[str, np.ndarray]:
    """Run the detector (a FasterRCNN on ``device``, f32 or bf16) over (T,
    H, W, 3) float32 frames in batches of ``batch_size``, the last batch
    padded with zero frames and sliced; -> stacked fixed-size detections
    (T, Dmax, ...) as numpy arrays (a bf16 model's scores as the float32
    numbers they are: numpy has no bfloat16). Under a profiler each batch's
    copy to the device is a ``tspn.h2d`` span and its readback, which
    waits for the batch, a ``tspn.d2h`` span."""
    outs = []
    t = frames.shape[0]
    for start in range(0, t, batch_size):
        chunk = frames[start : start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros_like(chunk[:1]).repeat(pad, 0)])
        with span("tspn.h2d"):
            images = torch.as_tensor(np.asarray(chunk, np.float32), device=device)
        out = model.detect(images)
        with span("tspn.d2h"):
            outs.append({k: to_numpy(v[: batch_size - pad]) for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
