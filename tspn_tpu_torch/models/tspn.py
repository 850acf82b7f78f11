"""Segment-level relation model (counterpart of tspn_tpu/models/tspn.py).

The classifier is Linear(FEATURE_DIM -> PREDICATE_NUM) over pair
features whose BoW blocks the host has already L1-normalized, with
normal(0.01) weight init and zero bias. Only the unfused classifier with
PPN off is ported; the PPN head and the fused classifier raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

_PPN_TODO = "the PPN head is not ported yet (ROADMAP queue 1, item 3)"
_FUSED_TODO = (
    "the fused classifier is not ported yet (ROADMAP queue 2, K3 "
    "normalize_classify_pallas)"
)


class RelationPredictor(nn.Module):
    """Per-pair predicate scorer; returns logits."""

    def __init__(
        self, num_predicates: int, feature_dim: int, fused: bool = False,
        device=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if fused:
            raise NotImplementedError(_FUSED_TODO)
        self.rel_predictor = nn.Linear(feature_dim, num_predicates, device=device)
        with torch.no_grad():
            self.rel_predictor.weight.normal_(0.0, 0.01, generator=generator)
            self.rel_predictor.bias.zero_()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.rel_predictor(feats)


class TSPNModel(nn.Module):
    """Forward over a segment batch: feats (B, P, D) -> {"rel_logits"
    (B, P, num_predicates)}."""

    def __init__(
        self, num_predicates: int = 132, feature_dim: int = 11070,
        use_ppn: bool = False, fused_classifier: bool = False, device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if use_ppn:
            raise NotImplementedError(_PPN_TODO)
        self.classifier = RelationPredictor(
            num_predicates, feature_dim, fused=fused_classifier,
            device=device, generator=generator,
        )

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"rel_logits": self.classifier(batch["feats"])}


def build_model(
    num_predicates: int = 132, feature_dim: int = 11070, use_ppn: bool = False,
    fused_classifier: bool = False, device=None, seed: Optional[int] = None,
) -> TSPNModel:
    """TSPNModel from explicit widths; ``seed`` makes the init reproducible."""
    gen = None
    if seed is not None:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    return TSPNModel(
        num_predicates=num_predicates, feature_dim=feature_dim, use_ppn=use_ppn,
        fused_classifier=fused_classifier, device=device, generator=gen,
    )
