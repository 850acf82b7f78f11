"""Segment-level relation model (counterpart of tspn_tpu/models/tspn.py).

The classifier is Linear(FEATURE_DIM -> PREDICATE_NUM) with normal(0.01)
weight init and zero bias, in one of two forms:

* unfused: ``nn.Linear`` over pair features whose BoW blocks the host
  has already L1-normalized;
* fused (``MODEL.FUSED_CLASSIFIER``): parameters ``kernel``
  (device_dim, R) and ``bias`` over RAW device-layout rows, with the
  normalization done in the fused_classify kernel. An inference model
  runs the kernel's forward alone; a training model runs
  ``normalize_classify_fused_nofeatgrad``, whose backward gives dW and
  db only. CONTRACT: the feature cotangent is a structural zero, so a
  learned module inserted upstream of the classifier would train with
  zero gradient; use ``normalize_classify_fused`` then.

With ``use_ppn`` the model also holds the PPN pair head
(models/ppn.py) and returns its ``pair_logits`` (B, N, N) from the
per-tracklet classeme logits.

``dtype`` is the compute dtype (the JAX package's ``MODEL.DTYPE``):
parameters stay f32, and in bf16 each layer casts where flax does. The
unfused classifier is ``nn.Dense(dtype=bf16)``: input, kernel and bias
cast to bf16, a bf16 product, a bf16 output. The fused classifier casts
the rows and, through autograd (so dW comes back rounded to bf16), the
kernel to bf16; the bias stays f32 and the logits are f32 (K3's bf16
half).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tspn_tpu_torch.config import compute_dtype
from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.models.ppn import PPNHead, dense
from tspn_tpu_torch.ops import pairwise as pw


class RelationPredictor(nn.Module):
    """Per-pair predicate scorer; returns logits. ``forward(feats,
    plain=True)`` runs the fused kernel's plain version on any device."""

    def __init__(
        self, num_predicates: int, feature_dim: int, fused: bool = False,
        inference: bool = False, num_objects: int = 35, device=None,
        generator: Optional[torch.Generator] = None, dtype=torch.float32,
    ):
        super().__init__()
        self.fused = fused
        self.inference = inference
        self.dtype = dtype
        if not fused:
            self.rel_predictor = nn.Linear(feature_dim, num_predicates, device=device)
            with torch.no_grad():
                self.rel_predictor.weight.normal_(0.0, 0.01, generator=generator)
                self.rel_predictor.bias.zero_()
            return
        self.layout = FeatureLayout.for_objects(num_objects)
        self.kernel = nn.Parameter(
            torch.empty((self.layout.device_dim, num_predicates), device=device)
        )
        self.bias = nn.Parameter(torch.zeros(num_predicates, device=device))
        with torch.no_grad():
            self.kernel.normal_(0.0, 0.01, generator=generator)

    def forward(self, feats: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if not self.fused:
            return dense(self.rel_predictor, feats, self.dtype)
        flat = feats.reshape(-1, self.layout.device_dim).to(self.dtype)
        if self.inference:
            out = pw.normalize_classify_fused_forward(
                flat, self.kernel, self.bias, self.layout, plain
            )
        else:
            out = pw.normalize_classify_fused_nofeatgrad(
                flat, self.kernel.to(self.dtype), self.bias, self.layout, plain
            )
        return out.reshape(*feats.shape[:-1], out.shape[-1])


class TSPNModel(nn.Module):
    """Forward over a segment batch: feats (B, P, D) -> {"rel_logits"
    (B, P, num_predicates)}, plus, with ``use_ppn``, cls_logits (B, N, C)
    -> "pair_logits" (B, N, N)."""

    def __init__(
        self, num_predicates: int = 132, feature_dim: int = 11070,
        use_ppn: bool = False, fused_classifier: bool = False,
        inference: bool = False, num_objects: int = 35, ppn_hidden: int = 64,
        ppn_out: int = 35, device=None, generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16 only")
        self.compute_dtype = dtype
        self.classifier = RelationPredictor(
            num_predicates, feature_dim, fused=fused_classifier,
            inference=inference, num_objects=num_objects, device=device,
            generator=generator, dtype=dtype,
        )
        self.use_ppn = use_ppn
        if use_ppn:
            self.ppn_head = PPNHead(num_objects, ppn_hidden, ppn_out,
                                    device=device, generator=generator, dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                plain: bool = False) -> Dict[str, torch.Tensor]:
        out = {"rel_logits": self.classifier(batch["feats"], plain=plain)}
        if self.use_ppn:
            out["pair_logits"] = self.ppn_head(batch["cls_logits"])
        return out


def build_model(
    num_predicates: int = 132, feature_dim: int = 11070, use_ppn: bool = False,
    fused_classifier: bool = False, inference: bool = False,
    num_objects: int = 35, ppn_hidden: int = 64, ppn_out: int = 35,
    device=None, seed: Optional[int] = None, dtype=torch.float32,
) -> TSPNModel:
    """TSPNModel from explicit widths; ``seed`` makes the init
    reproducible. The fused classifier's width is the device layout of
    ``num_objects`` classeme categories (``feature_dim`` is then unused);
    the PPN head reads ``num_objects``-wide classeme logits. ``dtype`` is
    the compute dtype (parameters stay f32)."""
    gen = None
    if seed is not None:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    return TSPNModel(
        num_predicates=num_predicates, feature_dim=feature_dim, use_ppn=use_ppn,
        fused_classifier=fused_classifier, inference=inference,
        num_objects=num_objects, ppn_hidden=ppn_hidden, ppn_out=ppn_out,
        device=device, generator=gen, dtype=dtype,
    )


def build_model_from_config(cfg, inference: bool = False,
                            seed: Optional[int] = None) -> TSPNModel:
    """TSPNModel from a config tree (the JAX package's ``build_model(cfg)``):
    PREDICT widths, MODEL.FUSED_CLASSIFIER, MODEL.DTYPE, RELPN.USE_PPN and
    the PPN widths RELPN.PPN.HIDDEN_CHANNELS / OUT_CHANNELS; the compute
    dtype is ``config.compute_dtype``."""
    return build_model(
        num_predicates=cfg.PREDICT.PREDICATE_NUM,
        feature_dim=cfg.PREDICT.FEATURE_DIM,
        use_ppn=bool(cfg.RELPN.USE_PPN),
        fused_classifier=bool(cfg.MODEL.get("FUSED_CLASSIFIER", False)),
        inference=inference, num_objects=cfg.PREDICT.OBJECT_NUM,
        ppn_hidden=cfg.RELPN.PPN.HIDDEN_CHANNELS,
        ppn_out=cfg.RELPN.PPN.OUT_CHANNELS, seed=seed, dtype=compute_dtype(cfg),
    )
