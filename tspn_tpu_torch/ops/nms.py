"""Greedy 2-D box NMS with a fixed output shape (counterpart of
tspn_tpu/ops/nms.py), batched over images.

- ``nms_sequential``: one output slot per step (argmax, then one
  suppression row); the oracle, one image at a time.
- ``_nms_blocked``: the JAX package's blocked greedy, the CPU path. Each
  step takes the top ``block`` still-active candidates in score order
  (ties by index, as ``lax.top_k``: a stable descending sort), resolves
  the chunk with a triangular pass (a candidate is kept iff no
  higher-scoring KEPT chunk member overlaps it), writes the kept ones into
  their output slots and suppresses the field against them. The kept
  sequence equals the sequential one element for element. Over a batch
  (B, N) the loop runs until every image is done, with one host sync per
  step for all images (an image that is done keeps its state, as under
  ``vmap``); under a profiler each sync is a ``tspn.nms.sync`` span
  (``runtime/spans.py``).
- ``_nms_cuda``: the same kept sequence on the card, with no host sync:
  one stable descending sort of the masked scores for the whole call, then
  one launch of ``csrc/nms.cu``, which walks each image's sorted
  candidates and writes the output (its kept boxes in a buffer of
  ``(B, top_k)`` boxes and areas).
- ``nms``: the dispatch by the tensors' device, one ``tspn.nms`` span a
  call under a profiler.

A candidate whose masked score is not finite (``valid`` False, -inf, +inf
or NaN) is never kept and takes no slot; ``_nms_blocked`` and the kernel
agree on that, while ``nms_sequential`` spends a slot (keep False) on a
+inf or NaN score. All return (indices, keep): padded slots index 0 with
keep False.
"""

from __future__ import annotations

import ctypes

import torch

from tspn_tpu_torch.runtime.spans import span

# kernel launches made by the dispatch on CUDA tensors
LAUNCHES = {"nms": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS (see the module docstring), one image or a batch
    of images -> (indices (..., top_k) int64, keep (..., top_k) bool): the
    kernel on a CUDA tensor, the blocked loop (16 candidates a step) on a
    CPU tensor."""
    with span("tspn.nms"):
        if boxes.device.type == "cuda":
            run = _nms_cuda
        elif boxes.device.type == "cpu":
            run = _nms_blocked
        else:
            raise ValueError(f"nms: no implementation for device {boxes.device}")
        if boxes.dim() == 2:
            idx, keep = run(boxes[None], scores[None], iou_threshold, top_k,
                            None if valid is None else valid[None])
            return idx[0], keep[0]
        return run(boxes, scores, iou_threshold, top_k, valid)


def _nms_blocked(boxes, scores, iou_threshold, top_k, valid, block=16):
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


def _nms_cuda(boxes, scores, iou_threshold, top_k, valid):
    """``nms`` over a batch (B, N) on the card: one sort, one kernel."""
    from tspn_tpu_torch.ops import _cuda

    bsz, n = scores.shape
    if boxes.shape != (bsz, n, 4) or (valid is not None and valid.shape != (bsz, n)):
        raise ValueError(f"nms: bad shapes boxes {tuple(boxes.shape)} scores "
                         f"{tuple(scores.shape)}")
    if any(t.device != boxes.device for t in (scores, valid) if t is not None):
        raise ValueError("nms: all operands must be on one device")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms: boxes in {boxes.dtype}; the kernel takes float32")
    top_k = min(top_k, n)
    dev = boxes.device
    out_idx = torch.empty((bsz, top_k), dtype=torch.int64, device=dev)
    out_keep = torch.empty((bsz, top_k), dtype=torch.bool, device=dev)
    if bsz == 0 or top_k == 0:
        return out_idx, out_keep
    masked = (scores if valid is None
              else torch.where(valid.to(torch.bool), scores, float("-inf")))
    top_s, order = torch.sort(masked, dim=1, descending=True, stable=True)
    finite = torch.isfinite(top_s)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    # the kernel's kept list: boxes and their areas
    kept_box = torch.empty((bsz, top_k, 4), dtype=torch.float32, device=dev)
    kept_area = torch.empty((bsz, top_k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda.nms_library().tspn_nms_launch(
            boxes.data_ptr(), order.data_ptr(), finite.data_ptr(), out_idx.data_ptr(),
            out_keep.data_ptr(), kept_box.data_ptr(), kept_area.data_ptr(), bsz, n, top_k,
            iou_threshold, ctypes.c_void_p(stream),
        )
    _cuda.check(err, "tspn_nms_launch")
    LAUNCHES["nms"] += 1
    return out_idx, out_keep


def nms_tlwh(boxes_tlwh, scores, iou_threshold, top_k, valid=None):
    """NMS over top-left-width-height boxes (the tracking app's format)."""
    xyxy = torch.cat([boxes_tlwh[..., :2], boxes_tlwh[..., :2] + boxes_tlwh[..., 2:]],
                     dim=-1)
    return nms(xyxy, scores, iou_threshold, top_k, valid=valid)
