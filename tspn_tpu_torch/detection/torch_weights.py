"""Load torchvision-style ResNet weights into the port's C4 backbone and
res5 head (counterpart of tspn_tpu/detection/torch_weights.py).

A torchvision ResNet ``state_dict`` (``conv1/bn1/layer{1..4}.{i}.conv{j}/
bn{j}/downsample`` naming) maps onto ``ResNetC4Backbone`` + ``Res5Head``
by name; the conv weights stay OIHW, and each BatchNorm folds into the
frozen per-channel affine:

    scale = gamma / sqrt(running_var + eps)
    bias  = beta - running_mean * scale
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tspn_tpu_torch.detection.resnet import RESNET_DEPTHS

BN_EPS = 1e-5


def fold_bn(gamma, beta, mean, var, eps: float = BN_EPS):
    scale = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    bias = np.asarray(beta) - np.asarray(mean) * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def convert_torch_resnet(state_dict: dict, depth: int = 101) -> Dict[str, torch.Tensor]:
    """-> the FasterRCNN state-dict entries of ``backbone.*`` and ``res5.*``
    (load with ``model.load_state_dict(..., strict=False)``, or through
    ``load_into_faster_rcnn``)."""
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    out: Dict[str, np.ndarray] = {}

    def conv(dst: str, src: str):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].astype(np.float32)

    def affine(dst: str, src: str):
        out[f"{dst}.scale"], out[f"{dst}.bias"] = fold_bn(
            sd[f"{src}.weight"], sd[f"{src}.bias"],
            sd[f"{src}.running_mean"], sd[f"{src}.running_var"],
        )

    def block(dst: str, src: str):
        for j in (1, 2, 3):
            conv(f"{dst}.conv{j}", f"{src}.conv{j}")
            affine(f"{dst}.norm{j}", f"{src}.bn{j}")
        if f"{src}.downsample.0.weight" in sd:
            conv(f"{dst}.shortcut", f"{src}.downsample.0")
            affine(f"{dst}.shortcut_norm", f"{src}.downsample.1")

    conv("backbone.stem_conv", "conv1")
    affine("backbone.stem_norm", "bn1")
    depths = RESNET_DEPTHS[depth]
    for stage, num_blocks in zip((2, 3, 4), depths[:3]):
        for i in range(num_blocks):
            block(f"backbone.res{stage}.block{i}", f"layer{stage - 1}.{i}")
    for i in range(depths[3]):
        block(f"res5.res5.block{i}", f"layer4.{i}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_into_faster_rcnn(model: torch.nn.Module, state_dict: dict, depth: int = 101):
    """Replace the model's backbone and res5 weights with a converted
    torchvision ResNet; the RPN and the box predictors stay."""
    converted = convert_torch_resnet(state_dict, depth)
    missing = set(converted) - set(model.state_dict())
    if missing:
        raise KeyError(f"no such detector weights: {sorted(missing)[:5]}")
    model.load_state_dict(converted, strict=False)
    return model
