"""The RoIAlign probes of tools/bench_roialign_{fused,variants}.py (T-roi).

Three functions of channels-last maps ``features`` (B, H, W, C), f32 or
bf16, and boxes (B, R, 4) f32 xyxy in feature coordinates, RoI r of
image b pooling ``features[b]`` (the JAX tools vmap each over the batch),
with RoIAlign's out 14 and sampling ratio s. ``ty``, ``tx`` are the
pooled axis tables of ``ops/roi_align.py::_pooled_tables`` (the summed
bilinear weight of the s samples of each output bin on each feature
index, torchvision's border rules), ``bf`` rounds to the map's dtype:

* ``roi_sep_fused`` (T-roi 1, ``_make_roi_align_sep_fused``): wy =
  bf(ty / s^2), wx = bf(tx); tmp = wy @ F over H, then out[i, j] =
  sum_w wx[j, w] tmp[i, w], f32 sums -> (B, R, 14, 14, C) in the map's
  dtype;
* ``roi_selector`` (T-roi 2, ``roi_selector``): the dense G[(i,j),(y,x)] =
  bf(ty[i, y] tx[j, x] / s^2), out = G @ F with f32 sums, in the map's
  dtype;
* ``roi_constg`` (T-roi 3, ``roi_constg``): G @ F with G the constant
  bf(box_x0 * 1e-6) of each RoI, out f32. Not RoIAlign: the lower bound of
  the G form.

Each has a plain PyTorch version (``*_plain``: the CPU path and the
kernel's oracle) and a dispatch that launches ``csrc/roi_probes.cu`` on a
CUDA tensor (or raises) and runs the plain version on a CPU tensor. The
plain versions pool image by image; on a card the tools hold each kernel
to its plain version and to ``roi_align_plain``.
"""

from __future__ import annotations

from functools import partial

import torch

from tspn_tpu_torch.ops import roi_align as ra
from tspn_tpu_torch.ops.pairwise import _dispatch, _launch

# launches made by the dispatches on CUDA tensors
LAUNCHES = {"roi_sep_fused": 0, "roi_selector": 0, "roi_constg": 0}
OUT, RATIO = 14, 2  # the C4 head's RoIAlign (the tools' out and s)
SEP_ROI_TILE, SEP_CHANNEL_TILE = 8, 16  # a block of csrc/roi_probes.cu's fused kernel


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def axis_tables(boxes: torch.Tensor, h: int, w: int, output_size: int = OUT,
                sampling_ratio: int = RATIO):
    """(N, 4) boxes -> (ty (N, out, H), tx (N, out, W)) f32 pooled axis
    tables, no 1/s^2 folded in."""
    x0, y0, bw, bh = ra._box_axes(boxes.float())
    return (ra._pooled_tables(y0, bh, h, output_size, sampling_ratio),
            ra._pooled_tables(x0, bw, w, output_size, sampling_ratio))


def _per_image(features, boxes, fn):
    """Stack ``fn(features[b], ty_b, tx_b, boxes[b])`` over the images."""
    _b, h, w, _c = features.shape
    outs = []
    for b in range(features.shape[0]):
        ty, tx = axis_tables(boxes[b], h, w)
        outs.append(fn(features[b], ty, tx, boxes[b]))
    return torch.stack(outs)


def roi_sep_fused_plain(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Plain T-roi 1 -> (B, R, 14, 14, C) in the map's dtype."""
    dt = features.dtype
    inv_s2 = 1.0 / (RATIO * RATIO)

    def one(f, ty, tx, _bx):
        wy = (ty * inv_s2).to(dt).float()
        wx = tx.to(dt).float()
        tmp = torch.einsum("rih,hwc->riwc", wy, f.float())
        return torch.einsum("rjw,riwc->rijc", wx, tmp).to(dt)

    return _per_image(features, boxes, one)


def selector_g(ty: torch.Tensor, tx: torch.Tensor, dtype) -> torch.Tensor:
    """The selector's G, (R, out^2, H*W) in ``dtype``: (ty[i, y] tx[j, x])
    / s^2, rounded once."""
    r, out, h = ty.shape
    g = (ty[:, :, None, :, None] * tx[:, None, :, None, :]) * (1.0 / (RATIO * RATIO))
    return g.to(dtype).reshape(r, out * out, h * tx.shape[-1])


def roi_selector_plain(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Plain T-roi 2 -> (B, R, 14, 14, C) in the map's dtype."""
    dt = features.dtype

    def one(f, ty, tx, _bx):
        g = selector_g(ty, tx, dt).float()
        out = g @ f.reshape(-1, f.shape[-1]).float()
        return out.reshape(g.shape[0], OUT, OUT, -1).to(dt)

    return _per_image(features, boxes, one)


def constg_value(boxes: torch.Tensor, dtype) -> torch.Tensor:
    """(B, R) constant of each RoI's G: box x0 * 1e-6, rounded to ``dtype``."""
    return (boxes[..., 0].float() * 1e-6).to(dtype)


def roi_constg_plain(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Plain T-roi 3 in closed form -> (B, R, 14, 14, C) f32: every output
    row is the constant times the map's f32 sum over (y, x)."""
    g = constg_value(boxes, features.dtype).float()
    col = features.float().sum(dim=(1, 2))  # (B, C)
    out = g[:, :, None] * col[:, None, :]
    return out[:, :, None, None, :].expand(*g.shape, OUT, OUT, col.shape[-1]).contiguous()


def _check(name, features, boxes, c_mult):
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: features must be float32 or bfloat16")
    if boxes.dtype != torch.float32:
        raise TypeError(f"{name}: boxes must be float32")
    if boxes.device != features.device:
        raise ValueError(f"{name}: all operands must be on one device")
    if not (features.is_contiguous() and boxes.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous (features channels-last)")
    b, h, w, c = features.shape
    if boxes.shape != (b, boxes.shape[1], 4):
        raise ValueError(f"{name}: boxes {tuple(boxes.shape)} for {b} images")
    if c % c_mult or h > 128 or w > 128 or features.data_ptr() % 16:
        raise ValueError(f"{name}: needs C % {c_mult} == 0, H and W <= 128 and a "
                         f"16-byte aligned map, got {tuple(features.shape)}")


def _sep_fused_cuda(features, boxes):
    _check("roi_sep_fused", features, boxes, 32)
    b, h, w, c = features.shape
    if w > 112:
        raise ValueError(f"roi_sep_fused: takes W <= 112, got {w}")
    r = boxes.shape[1]
    out = torch.empty((b, r, OUT, OUT, c), dtype=features.dtype, device=features.device)
    if r:
        _launch("roi_sep_fused", "roi_sep_fused_library", "tspn_roi_sep_fused_launch",
                features.device, (features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
                                  b, r, h, w, c, OUT, RATIO,
                                  int(features.dtype == torch.bfloat16)), LAUNCHES)
    return out


def _gemm_cuda(features, boxes, const_g: bool):
    key = "roi_constg" if const_g else "roi_selector"
    _check(key, features, boxes, 128)
    b, h, w, c = features.shape
    r = boxes.shape[1]
    dt = torch.float32 if const_g else features.dtype
    out = torch.empty((b, r, OUT, OUT, c), dtype=dt, device=features.device)
    if r:
        _launch(key, "roi_gemm_library", "tspn_roi_gemm_launch", features.device,
                (features.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, r, h, w, c,
                 OUT, RATIO, int(features.dtype == torch.bfloat16), int(const_g)), LAUNCHES)
    return out


def roi_sep_fused(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """T-roi 1: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _dispatch("roi_sep_fused", features, _sep_fused_cuda, roi_sep_fused_plain,
                     features, boxes)


def roi_selector(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """T-roi 2: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _dispatch("roi_selector", features, partial(_gemm_cuda, const_g=False),
                     roi_selector_plain, features, boxes)


def roi_constg(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """T-roi 3: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _dispatch("roi_constg", features, partial(_gemm_cuda, const_g=True),
                     roi_constg_plain, features, boxes)
