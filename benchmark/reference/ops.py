"""Plain operations of the reference detector: precision, box coding,
anchors, IoU, greedy NMS, RoIAlign and the input resize.

Plain PyTorch and NumPy only; nothing of the program is imported. The
arithmetic follows the published definitions in the order a straight
implementation takes (detectron2's box coding with its dw/dh clamp,
torchvision's ``roi_align`` with ``aligned=True``, greedy NMS in score
order with ties to the lower index).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# the precisions a reference runs in: the two a configuration states, and
# the step below each that the control computes in (TF32 for float32 with
# TF32 off; scaled fp8 for bfloat16)
COMPUTE_DTYPE = {"float32": torch.float32, "tf32": torch.float32,
                 "bfloat16": torch.bfloat16, "fp8": torch.bfloat16}
FP8_MAX = 448.0  # largest finite float8_e4m3fn

# detectron2's clamp on dw/dh: log(1000 / 16)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A conv or dense operand as the multiply takes it: float32; rounded
    to TF32's 10-bit mantissa (to nearest, as the tensor cores take it);
    bfloat16; or bfloat16 through float8 e4m3 with one scale per tensor.
    A rounded operand passes its gradient straight through."""
    if precision == "float32":
        return x.float()
    if precision == "bfloat16":
        return x.to(torch.bfloat16)
    if precision == "tf32":
        x = x.float()
        with torch.no_grad():
            q = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    elif precision == "fp8":
        x = x.to(torch.bfloat16)
        with torch.no_grad():
            xf = x.float()
            scale = xf.abs().amax().clamp(min=1e-30) / FP8_MAX
            q = ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)
    else:
        raise ValueError(f"unknown precision {precision}")
    return x + (q - x).detach()


# ------------------------------------------------------------------ boxes
def encode(gt: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """xyxy targets against xyxy references -> (dx, dy, dw, dh), unit weights."""
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    dx = (gx - rx) / rw.clamp(min=1e-6)
    dy = (gy - ry) / rh.clamp(min=1e-6)
    dw = torch.log(gw.clamp(min=1e-6) / rw.clamp(min=1e-6))
    dh = torch.log(gh.clamp(min=1e-6) / rh.clamp(min=1e-6))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode(deltas: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The inverse of ``encode``, dw and dh clamped at log(1000 / 16)."""
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    dw = deltas[..., 2].clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    dh = deltas[..., 3].clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    cx = deltas[..., 0] * rw + rx
    cy = deltas[..., 1] * rh + ry
    w = torch.exp(dw) * rw
    h = torch.exp(dh) * rh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0.0, width), boxes[..., 1].clamp(0.0, height),
                        boxes[..., 2].clamp(0.0, width), boxes[..., 3].clamp(0.0, height)],
                       dim=-1)


def anchors(feat_hw: Tuple[int, int], stride: int, sizes, ratios, device) -> torch.Tensor:
    """(H * W * A, 4) xyxy anchors, row-major over (y, x, anchor), centred
    on ((x + 0.5) * stride, (y + 0.5) * stride); each anchor's area is
    size squared and its height over width the ratio."""
    cell = []
    for size in sizes:
        for ratio in ratios:
            w = math.sqrt(float(size) ** 2 / ratio)
            h = w * ratio
            cell.append([-w / 2, -h / 2, w / 2, h / 2])
    cell = np.asarray(cell, np.float32)
    cy, cx = np.meshgrid((np.arange(feat_hw[0]) + 0.5) * stride,
                         (np.arange(feat_hw[1]) + 0.5) * stride, indexing="ij")
    centres = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return torch.as_tensor((centres + cell[None]).reshape(-1, 4), dtype=torch.float32,
                           device=device)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (..., N, 4) x (..., M, 4) -> (..., N, M);
    0 where the union is empty."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0.0) * (a[..., 3] - a[..., 1]).clamp(min=0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes: torch.Tensor, scores: torch.Tensor, threshold: float, top_k: int,
        valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per image over (B, N, 4) boxes: visit the valid boxes in
    descending score (ties to the lower index), keep one unless a kept box
    overlaps it by more than ``threshold``, stop at ``top_k`` kept ->
    (indices (B, top_k) int64, keep (B, top_k) bool), empty slots index 0.
    The overlaps are computed once on the device; the walk runs on the
    host."""
    bsz, n = scores.shape
    top_k = min(top_k, n)
    out_idx = np.zeros((bsz, top_k), np.int64)
    out_keep = np.zeros((bsz, top_k), bool)
    for b in range(bsz):
        order = torch.sort(scores[b], descending=True, stable=True).indices
        order = order[valid[b][order]]
        over = (iou(boxes[b][order], boxes[b][order]) > threshold).cpu().numpy()
        order = order.cpu().numpy()
        suppressed = np.zeros(len(order), bool)
        kept = 0
        for i in range(len(order)):
            if kept == top_k:
                break
            if suppressed[i]:
                continue
            out_idx[b, kept], out_keep[b, kept] = order[i], True
            kept += 1
            suppressed |= over[i]
    dev = boxes.device
    return torch.as_tensor(out_idx, device=dev), torch.as_tensor(out_keep, device=dev)


# --------------------------------------------------------------- RoIAlign
def _sample_axis(lo, extent, out: int, s: int):
    """Sample centres (R, out * s) along one axis: bin i, sample k at
    lo + (i + (k + 0.5) / s) * extent / out."""
    dev = lo.device
    s_t, out_t = torch.full((1,), float(s), device=dev), torch.full((1,), float(out), device=dev)
    grid = (torch.arange(out * s, device=dev, dtype=torch.float32) + 0.5) / s_t
    return lo[:, None] + grid[None, :] * (extent[:, None] / out_t)


def _interp_axis(coord: torch.Tensor, size: int):
    """torchvision's bilinear_interpolate along one axis: a sample outside
    [-1, size] adds zero; below 0 it clamps to 0; at or past size - 1 it
    takes the last index at full weight -> (i0, i1, w0, w1)."""
    inside = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    low = torch.floor(c)
    top = low >= size - 1
    i0 = low.clamp(max=size - 1).long()
    i1 = (low + 1).clamp(max=size - 1).long()
    frac = torch.where(top, torch.zeros_like(c), c - low)
    zero = torch.zeros_like(c)
    return i0, i1, torch.where(inside, 1.0 - frac, zero), torch.where(inside, frac, zero)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, batch_idx: torch.Tensor,
              out: int, s: int, chunk: int = 256) -> torch.Tensor:
    """RoIAlign (aligned: boxes shifted by half a cell) of (N, H, W, C)
    maps at (R, 4) xyxy boxes in map coordinates -> (R, out, out, C), the
    mean of s x s bilinear samples a bin, ``chunk`` RoIs at a time. A
    bfloat16 map is pooled in float32 and rounded once; autograd carries
    the gradient to the map."""
    if features.dtype == torch.bfloat16:
        return roi_align(features.float(), boxes, batch_idx, out, s, chunk).to(torch.bfloat16)
    pieces = []
    for k in range(0, boxes.shape[0], chunk):
        pieces.append(_roi_align_rows(features, boxes[k: k + chunk],
                                      batch_idx[k: k + chunk], out, s))
    return torch.cat(pieces) if len(pieces) > 1 else pieces[0]


def _roi_align_rows(features, boxes, batch_idx, out: int, s: int):
    _n, h, w, c = features.shape
    r = boxes.shape[0]
    n = out * s
    x0, y0 = boxes[:, 0] - 0.5, boxes[:, 1] - 0.5
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6)
    yi0, yi1, wy0, wy1 = _interp_axis(_sample_axis(y0, bh, out, s), h)
    xi0, xi1, wx0, wx1 = _interp_axis(_sample_axis(x0, bw, out, s), w)
    img = batch_idx.long()[:, None]
    rows = features[img, yi0] * wy0[..., None, None] + features[img, yi1] * wy1[..., None, None]
    left = torch.gather(rows, 2, xi0[:, None, :, None].expand(r, n, n, c))
    right = torch.gather(rows, 2, xi1[:, None, :, None].expand(r, n, n, c))
    samples = left * wx0[:, None, :, None] + right * wx1[:, None, :, None]
    return samples.reshape(r, out, s, out, s, c).mean(dim=(2, 4))


# ------------------------------------------------------------------ input
def shortest_edge_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    """ResizeShortestEdge: the short side to min_size unless the long side
    would then pass max_size."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale


def resize_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """float32 HWC image -> (nh, nw) by bilinear interpolation at half-pixel
    centres, edges replicated; weights in float64, the result float32."""
    h, w = image.shape[:2]
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    rows = image[y0] * (1.0 - wy) + image[y1] * wy
    return (rows[:, x0] * (1.0 - wx) + rows[:, x1] * wx).astype(np.float32)
