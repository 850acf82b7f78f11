"""Greedy 2-D box NMS with a fixed output shape (counterpart of
tspn_tpu/ops/nms.py), batched over images.

- ``nms_sequential``: one output slot per step (argmax, then one
  suppression row); the oracle, one image at a time.
- ``nms``: the JAX package's blocked greedy. Each step takes the top
  ``block`` still-active candidates in score order (ties by index, as
  ``lax.top_k``: a stable descending sort), resolves the chunk with a
  triangular pass (a candidate is kept iff no higher-scoring KEPT chunk
  member overlaps it), writes the kept ones into their output slots and
  suppresses the field against them. The kept sequence equals the
  sequential one element for element. Over a batch (B, N) the loop runs
  until every image is done, with one host sync per step for all images
  (an image that is done keeps its state, as under ``vmap``). Under a
  profiler a call is one ``tspn.nms`` span and each sync a
  ``tspn.nms.sync`` span (``runtime/spans.py``).

Both return (indices, keep): padded slots index 0 with keep False.
"""

from __future__ import annotations

import torch

from tspn_tpu_torch.runtime.spans import span


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a (..., N, 4) x b (..., M, 4) ->
    (..., N, M), no +1 convention."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0.0) * (a[..., 3] - a[..., 1]).clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_sequential(
    boxes: torch.Tensor,            # (N, 4) xyxy
    scores: torch.Tensor,           # (N,)
    iou_threshold: float,
    top_k: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS, one kept box per step (the oracle for ``nms``).
    Returns (indices (top_k,), keep (top_k,))."""
    n = boxes.shape[0]
    top_k = min(top_k, n)
    dev = boxes.device
    active = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
              else valid.to(torch.bool).clone())
    out_idx = torch.zeros(top_k, dtype=torch.int64, device=dev)
    out_keep = torch.zeros(top_k, dtype=torch.bool, device=dev)
    ninf = torch.tensor(float("-inf"), device=dev, dtype=scores.dtype)
    arange = torch.arange(n, device=dev)
    for s in range(top_k):
        masked = torch.where(active, scores, ninf)
        i = int(torch.argmax(masked))
        ok = bool(torch.isfinite(masked[i]))
        out_idx[s] = i if ok else 0
        out_keep[s] = ok
        overlap = box_iou(boxes[i : i + 1], boxes)[0] > iou_threshold
        active = active & ~(overlap & ok) & (arange != i)
    return out_idx, out_keep


def nms(
    boxes: torch.Tensor,            # (N, 4) or (B, N, 4) xyxy
    scores: torch.Tensor,           # (N,) or (B, N)
    iou_threshold: float,
    top_k: int,
    valid: torch.Tensor | None = None,
    block: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked exact greedy NMS (see the module docstring), one image or
    a batch of images -> (indices (..., top_k) int64, keep (..., top_k)
    bool)."""
    with span("tspn.nms"):
        if boxes.dim() == 2:
            idx, keep = _nms_blocked(boxes[None], scores[None], iou_threshold, top_k,
                                     None if valid is None else valid[None], block)
            return idx[0], keep[0]
        return _nms_blocked(boxes, scores, iou_threshold, top_k, valid, block)


def _nms_blocked(boxes, scores, iou_threshold, top_k, valid, block):
    """``nms`` over a batch (B, N)."""
    bsz, n = scores.shape
    dev = boxes.device
    top_k = min(top_k, n)
    b = min(block, top_k, n)
    active = (torch.ones((bsz, n), dtype=torch.bool, device=dev) if valid is None
              else valid.to(torch.bool).clone())
    # one spare slot per image takes the writes that JAX drops
    out_idx = torch.zeros((bsz, top_k + 1), dtype=torch.int64, device=dev)
    out_keep = torch.zeros((bsz, top_k + 1), dtype=torch.bool, device=dev)
    count = torch.zeros(bsz, dtype=torch.int64, device=dev)
    ninf = torch.tensor(float("-inf"), device=dev, dtype=scores.dtype)
    if b == 0:
        return out_idx[:, :top_k], out_keep[:, :top_k]
    while True:
        running = (count < top_k) & active.any(dim=1)
        with span("tspn.nms.sync"):
            go = bool(running.any())
        if not go:
            break
        masked = torch.where(active, scores, ninf)
        top_s, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :b], top_i[:, :b]
        cand_ok = torch.isfinite(top_s) & running[:, None]
        cand_boxes = torch.gather(boxes, 1, top_i[..., None].expand(bsz, b, 4))
        over_cc = box_iou(cand_boxes, cand_boxes) > iou_threshold  # (B, b, b)

        # triangular pass: kept iff no higher-scoring KEPT member overlaps
        keep_cols = [cand_ok[:, 0]]
        for i in range(1, b):
            kept_before = torch.stack(keep_cols, dim=1)
            sup = (kept_before & over_cc[:, i, :i]).any(dim=1)
            keep_cols.append(cand_ok[:, i] & ~sup)
        keep_c = torch.stack(keep_cols, dim=1)  # (B, b)

        # kept candidates into their output slots, in kept order
        k32 = keep_c.to(torch.int64)
        pos = count[:, None] + torch.cumsum(k32, dim=1) - k32
        pos = torch.where(keep_c & (pos < top_k), pos, top_k)
        out_idx.scatter_(1, pos, top_i)
        out_keep.scatter_(1, pos, keep_c)
        count = count + (keep_c & (pos < top_k)).sum(dim=1)

        # field suppression by the chunk's kept boxes
        over_all = box_iou(boxes, cand_boxes) > iou_threshold  # (B, N, b)
        sup_any = (keep_c[:, None, :] & over_all).any(dim=2)
        active = active & ~sup_any
        still = torch.gather(active, 1, top_i) & ~running[:, None]
        active.scatter_(1, top_i, still)
    return out_idx[:, :top_k], out_keep[:, :top_k]


def nms_tlwh(boxes_tlwh, scores, iou_threshold, top_k, valid=None):
    """NMS over top-left-width-height boxes (the tracking app's format)."""
    xyxy = torch.cat([boxes_tlwh[..., :2], boxes_tlwh[..., :2] + boxes_tlwh[..., 2:]],
                     dim=-1)
    return nms(xyxy, scores, iou_threshold, top_k, valid=valid)
