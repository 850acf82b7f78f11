"""The system under test: the port's detector, built from the benchmark's
weights and driven through the port's own entry points. The model's class
and config class are the ones the configuration's architecture module
names (its ``PROGRAM``).

Training goes through ``detection.inputs.make_batch`` (the batches'
assembly, in set-up), ``detection.train.batch_to_device`` and
``detection.train.detector_train_step`` with the optimizer and schedule of
``detection.train.build_detector_optimizer``; detection through
``pipeline.detect_video_frames``. Each is looked up on its module at call
time. The port is imported here and nowhere else in the benchmark.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from benchmark import archs


def _model(config: dict, weights: Dict[str, torch.Tensor], device):
    arch = archs.of(config)
    module, model_class, config_class = arch.PROGRAM
    program = importlib.import_module(module)
    dtype = torch.bfloat16 if config["compute_dtype"] == "bfloat16" else torch.float32
    det_cfg = getattr(program, config_class)(**arch.port_configs(config)["detection"])
    with torch.device("meta"):
        model = getattr(program, model_class)(det_cfg, dtype=dtype)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


class ProgramTrainer:
    """The port's model, SGD and schedule, one object from set-up on."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], device):
        from tspn_tpu_torch.detection import train as dt
        from tspn_tpu_torch.detection.inputs import DetectorTrainConfig

        self.device = device
        self.train_cfg = DetectorTrainConfig(**archs.of(config).port_configs(config)["train"])
        self.model = _model(config, weights, device).train()
        self.optimizer, self.scheduler = dt.build_detector_optimizer(
            self.model.parameters(), self.train_cfg)
        self.names: List[str] = list(weights)

    def assembler(self):
        """(function, argument) that set-up assembles batches with."""
        from tspn_tpu_torch.detection import inputs

        return inputs.make_batch, self.train_cfg

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One update -> its losses on the device (not read back)."""
        from tspn_tpu_torch.detection import train as dt

        return dt.detector_train_step(self.model, self.optimizer, self.scheduler,
                                      dt.batch_to_device(batch, self.device))

    def losses(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A batch's losses with no update (control's fault of a step that
        leaves the state unchanged)."""
        from tspn_tpu_torch.detection import train as dt

        dev = dt.batch_to_device(batch, self.device)
        with torch.no_grad():
            losses = self.model(dev["image"], dev["gt_boxes"], dev["gt_classes"], dev["gt_mask"])
        out = dict(losses)
        out["loss"] = sum(losses[k] for k in dt.LOSS_KEYS)
        return out

    def params(self) -> Dict[str, torch.Tensor]:
        named = dict(self.model.named_parameters())
        return {k: named[k] for k in self.names}

    def first_update(self) -> Dict[str, torch.Tensor]:
        """After one step: each leaf's update direction as SGD holds it
        (its momentum buffer, g + wd * p); a leaf SGD did not update holds
        none and reads as zeros."""
        out = {}
        for name, p in self.params().items():
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            out[name] = torch.zeros_like(p) if buf is None else buf
        return out


class ProgramDetector:
    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], device,
                 batch_size: int):
        self.device, self.batch_size = device, batch_size
        self.model = _model(config, weights, device).eval()

    def detect(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        from tspn_tpu_torch import pipeline

        return pipeline.detect_video_frames(self.model, frames, device=self.device,
                                            batch_size=self.batch_size)
