"""RoIAlign over a batch of channels-last feature maps (counterpart of
tspn_tpu/ops/roi_align.py).

torchvision / detectron2 ``roi_align`` with ``aligned=True`` and a static
sampling ratio s, including the border rules of torchvision's
``bilinear_interpolate``: a sample strictly outside [-1, size] adds zero,
a sample in [-1, 0] clamps to index 0 at full weight, and one at or past
size-1 collapses to the last index. Features are (N, H, W, C), boxes
(R, 4) xyxy in feature coordinates (image boxes over the stride), and
``batch_idx`` (R,) says which image each box pools from; the output is
(R, out, out, C).

- ``roi_align_plain``: the gather form of ``roi_align_xla`` (rows, then
  columns, then the s x s mean). The kernel's oracle, and the CPU path.
- ``roi_align_separable``: the two-einsum form of ``roi_align_separable``
  (per-axis pooled weight tables), plain too.
- ``roi_align``: the dispatch, for float32 or bfloat16 maps. On a CUDA
  tensor it launches ``csrc/roi_align.cu`` (K7, direct bilinear sampling,
  all images' RoIs in one launch) or raises; when the features require a
  gradient it goes through ``RoIAlignFunction``, whose backward is K7's
  backward kernel (the gradient of the features only: boxes get none, as
  JAX stops their gradient). On a CPU tensor it runs ``roi_align_plain``,
  which autograd differentiates.

A bfloat16 map is widened exactly to float32, pooled in float32 and
rounded once to bfloat16 (RNE), in the kernel and in the plain version
alike; the backward sums into a float32 buffer and rounds it to bfloat16
once.

The levels form pools each RoI from the map of its own level of a
feature pyramid (float32 maps (N, H_l, W_l, C), up to four; boxes in image
coordinates; ``levels`` (R,) int32 computed on the device; each level's
scale 1 / its stride, a power of two):

- ``roi_align_levels_plain``: per-level ``roi_align_plain`` on the RoIs of
  each level (a boolean selection, so a host sync on a card): the CPU path
  and the kernel's oracle.
- ``roi_align_levels``: the dispatch. On a CUDA tensor one launch of K7's
  levels kernel for all levels' RoIs, no host sync, and one launch of its
  backward when a map requires a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

# K7 launches made by the dispatch on CUDA tensors: the forward on f32 and
# on bf16 maps, and the backward (either type)
LAUNCHES = {"roi_align": 0, "roi_align_bf16": 0, "roi_align_backward": 0,
            "roi_align_levels": 0, "roi_align_levels_backward": 0}
MAX_LEVELS = 4
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _as_batch(features: torch.Tensor, boxes: torch.Tensor, batch_idx):
    """(H, W, C) features with no image index -> one image of a batch."""
    if features.dim() == 3:
        if batch_idx is not None:
            raise ValueError("roi_align: batch_idx needs (N, H, W, C) features")
        features = features[None]
    if batch_idx is None:
        if features.shape[0] != 1:
            raise ValueError("roi_align: batch_idx is required for N > 1 images")
        batch_idx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    return features, batch_idx


def _sample_coords(lo, extent, output_size: int, sampling_ratio: int):
    """Sample centres (R, out * s) along one axis: for output bin i,
    samples at lo + (i + (k + .5)/s) * extent/out. The divisors are
    tensors: PyTorch's CUDA path divides by a Python number as a multiply
    by its reciprocal, an ulp off the true quotient, which the sample
    index then scales by up to out * s."""
    n = output_size * sampling_ratio
    s, out = (torch.full((1,), float(v), device=lo.device)
              for v in (sampling_ratio, output_size))
    grid = (torch.arange(n, device=lo.device, dtype=torch.float32) + 0.5) / s
    return lo[:, None] + grid[None, :] * (extent[:, None] / out)


def _bilinear_1d(coord: torch.Tensor, size: int):
    """torchvision bilinear_interpolate along one axis -> (i0, i1, w0, w1)."""
    inside = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    low = torch.floor(c)
    at_top = low >= size - 1
    i0 = low.clamp(max=size - 1).long()
    i1 = (low + 1).clamp(max=size - 1).long()
    frac = torch.where(at_top, torch.zeros_like(c), c - low)
    zero = torch.zeros_like(c)
    return (i0, i1, torch.where(inside, 1.0 - frac, zero),
            torch.where(inside, frac, zero))


def _box_axes(boxes: torch.Tensor):
    x0 = boxes[:, 0] - 0.5
    y0 = boxes[:, 1] - 0.5
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6)
    return x0, y0, bw, bh


def roi_align_plain(
    features: torch.Tensor,      # (N, H, W, C), or (H, W, C) with no batch_idx
    boxes: torch.Tensor,         # (R, 4) xyxy in feature coordinates
    batch_idx: torch.Tensor | None = None,  # (R,) int, image of each box
    output_size: int = 14,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Gather form -> (R, out, out, C); it materializes an (R, out*s, W, C)
    intermediate, so a caller on the card pools large RoI sets in chunks.
    A bf16 map is pooled as ``features.float()`` and the result rounded to
    bf16."""
    if features.dtype == torch.bfloat16:
        return roi_align_plain(features.float(), boxes, batch_idx, output_size,
                               sampling_ratio).to(torch.bfloat16)
    features, batch_idx = _as_batch(features, boxes, batch_idx)
    _n, h, w, c = features.shape
    r = boxes.shape[0]
    s = sampling_ratio
    n = output_size * s
    x0, y0, bw, bh = _box_axes(boxes)
    yi0, yi1, wy0, wy1 = _bilinear_1d(_sample_coords(y0, bh, output_size, s), h)
    xi0, xi1, wx0, wx1 = _bilinear_1d(_sample_coords(x0, bw, output_size, s), w)

    img = batch_idx.long()[:, None]
    rows = (features[img, yi0] * wy0[..., None, None]
            + features[img, yi1] * wy1[..., None, None])  # (R, n, W, C)
    cols0 = torch.gather(rows, 2, xi0[:, None, :, None].expand(r, n, n, c))
    cols1 = torch.gather(rows, 2, xi1[:, None, :, None].expand(r, n, n, c))
    samples = cols0 * wx0[:, None, :, None] + cols1 * wx1[:, None, :, None]
    samples = samples.reshape(r, output_size, s, output_size, s, c)
    return samples.mean(dim=(2, 4))


def _pooled_tables(lo, extent, size: int, output_size: int, s: int):
    """(R, out, size): the summed bilinear weight of each feature index
    over the s samples of each output bin (the separable factor)."""
    coord = _sample_coords(lo, extent, output_size, s)  # (R, out * s)
    i0, i1, w0, w1 = _bilinear_1d(coord, size)
    r = lo.shape[0]
    table = torch.zeros((r, output_size * s, size), dtype=coord.dtype, device=coord.device)
    table.scatter_add_(2, i0[..., None], w0[..., None])
    table.scatter_add_(2, i1[..., None], w1[..., None])
    return table.reshape(r, output_size, s, size).sum(dim=2)


def roi_align_separable(
    features: torch.Tensor,
    boxes: torch.Tensor,
    batch_idx: torch.Tensor | None = None,
    output_size: int = 14,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Two-einsum form -> (R, out, out, C): per-axis pooled weight tables,
    then one contraction over H and one over W, image by image."""
    features, batch_idx = _as_batch(features, boxes, batch_idx)
    _n, h, w, c = features.shape
    s = sampling_ratio
    x0, y0, bw, bh = _box_axes(boxes)
    wy = _pooled_tables(y0, bh, h, output_size, s).to(features.dtype)
    wx = _pooled_tables(x0, bw, w, output_size, s).to(features.dtype)
    out = torch.zeros((boxes.shape[0], output_size, output_size, c),
                      dtype=features.dtype, device=features.device)
    for b in torch.unique(batch_idx).tolist():
        sel = torch.nonzero(batch_idx == b)[:, 0]
        tmp = torch.einsum("rih,hwc->riwc", wy[sel], features[b])
        out[sel] = torch.einsum("rjw,riwc->rijc", wx[sel], tmp)
    return out * (1.0 / (s * s))


def _check_cuda_operands(features, boxes, batch_idx, output_size, sampling_ratio):
    r = boxes.shape[0]
    if any(t.device != features.device for t in (boxes, batch_idx)):
        raise ValueError("roi_align: all operands must be on one device")
    if features.dtype not in DTYPES or boxes.dtype != torch.float32:
        raise TypeError("roi_align: features must be float32 or bfloat16, boxes float32")
    if batch_idx.dtype != torch.int32:
        raise TypeError("roi_align: batch_idx must be int32")
    if not all(t.is_contiguous() for t in (features, boxes, batch_idx)):
        raise ValueError("roi_align: operands must be contiguous (features channels-last)")
    if boxes.shape != (r, 4) or batch_idx.shape != (r,):
        raise ValueError(f"roi_align: bad shapes boxes {tuple(boxes.shape)} "
                         f"batch_idx {tuple(batch_idx.shape)}")
    if not (1 <= sampling_ratio <= 16 and output_size * sampling_ratio <= 128):
        raise ValueError(f"roi_align: out {output_size} x s {sampling_ratio} "
                         "exceeds the kernel's 128 samples per axis")


def _vec(c: int, *tensors, widest: int = 4) -> int:
    """Channels a thread: the widest of ``widest``, 4 and 1 that divides C
    and whose vector access every tensor's base allows (K7's forward takes
    16 bytes: 8 channels of a bf16 map, 4 of an f32 one; its backward 4 or
    1)."""
    for vec in (widest, 4):
        if c % vec == 0 and all(t.data_ptr() % (vec * t.element_size()) == 0 for t in tensors):
            return vec
    return 1


def _roi_align_cuda(features, boxes, batch_idx, output_size, sampling_ratio):
    from tspn_tpu_torch.ops import _cuda

    _check_cuda_operands(features, boxes, batch_idx, output_size, sampling_ratio)
    n, h, w, c = features.shape
    r = boxes.shape[0]
    out = torch.empty((r, output_size, output_size, c), dtype=features.dtype,
                      device=features.device)
    if r == 0 or c == 0:
        return out
    bf16 = features.dtype == torch.bfloat16
    if bf16:
        lib, entry, key = _cuda.roi_align_bf16_library(), "tspn_roi_align_bf16_launch", \
            "roi_align_bf16"
    else:
        lib, entry, key = _cuda.roi_align_library(), "tspn_roi_align_launch", "roi_align"
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = getattr(lib, entry)(
            features.data_ptr(), boxes.data_ptr(), batch_idx.data_ptr(), out.data_ptr(),
            r, n, h, w, c, output_size, sampling_ratio,
            _vec(c, features, out, widest=16 // features.element_size()),
            ctypes.c_void_p(stream),
        )
    _cuda.check(err, entry)
    LAUNCHES[key] += 1
    return out


def roi_align_backward_plain(grad_out, boxes, batch_idx, features_shape, features_dtype,
                             output_size: int = 14, sampling_ratio: int = 2,
                             chunk: int | None = None):
    """The vjp of ``roi_align_plain``: dL/dfeatures (N, H, W, C) from dL/dout
    (R, out, out, C), autograd in f32 over ``chunk`` RoIs at a time (all
    at once when None), summed in f32 and rounded once to a bf16 map's
    type. RoIAlign is linear in the features, so no feature values are
    needed."""
    r = boxes.shape[0]
    zeros = torch.zeros(features_shape, dtype=torch.float32, device=grad_out.device)
    total = torch.zeros_like(zeros)
    step = chunk or max(r, 1)
    for k in range(0, r, step):
        f = zeros.clone().requires_grad_(True)
        with torch.enable_grad():
            out = roi_align_plain(f, boxes[k : k + step], batch_idx[k : k + step],
                                  output_size, sampling_ratio)
            total += torch.autograd.grad(out, f, grad_out[k : k + step].float())[0]
    return total.to(features_dtype)


def roi_align_backward(grad_out, boxes, batch_idx, features_shape, features_dtype,
                       output_size: int = 14, sampling_ratio: int = 2):
    """dL/dfeatures from dL/dout (R, out, out, C) in the map's type: on a
    CUDA tensor K7's backward (atomics into a zeroed f32 buffer, rounded
    once to bf16 for a bf16 map), on a CPU tensor
    ``roi_align_backward_plain``."""
    if grad_out.device.type == "cpu":
        return roi_align_backward_plain(grad_out, boxes, batch_idx, features_shape,
                                        features_dtype, output_size, sampling_ratio)
    from tspn_tpu_torch.ops import _cuda

    n, h, w, c = features_shape
    r = boxes.shape[0]
    if features_dtype not in DTYPES:
        raise TypeError(f"roi_align backward: a map in {features_dtype}")
    grad = grad_out.to(features_dtype).contiguous()
    _check_cuda_operands(grad, boxes, batch_idx, output_size, sampling_ratio)
    if grad.shape != (r, output_size, output_size, c):
        raise ValueError(f"roi_align backward: bad gradient shape {tuple(grad.shape)}")
    dfeat = torch.zeros((n, h, w, c), dtype=torch.float32, device=grad.device)
    if r and c:
        lib = _cuda.roi_align_backward_library()
        with torch.cuda.device(grad.device):
            stream = torch.cuda.current_stream(grad.device).cuda_stream
            err = lib.tspn_roi_align_backward_launch(
                grad.data_ptr(), boxes.data_ptr(), batch_idx.data_ptr(), dfeat.data_ptr(),
                r, n, h, w, c, output_size, sampling_ratio, _vec(c, grad, dfeat),
                int(features_dtype == torch.bfloat16), ctypes.c_void_p(stream),
            )
        _cuda.check(err, "tspn_roi_align_backward_launch")
        LAUNCHES["roi_align_backward"] += 1
    return dfeat.to(features_dtype)


class RoIAlignFunction(torch.autograd.Function):
    """K7 forward with K7's backward: the gradient of the features only
    (boxes and the image index get None)."""

    @staticmethod
    def forward(ctx, features, boxes, batch_idx, output_size, sampling_ratio):
        ctx.save_for_backward(boxes, batch_idx)
        ctx.geometry = (tuple(features.shape), features.dtype, output_size, sampling_ratio)
        return _roi_align_cuda(features, boxes, batch_idx, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, batch_idx = ctx.saved_tensors
        shape, dtype, output_size, sampling_ratio = ctx.geometry
        dfeat = roi_align_backward(grad_out, boxes, batch_idx, shape, dtype,
                                   output_size, sampling_ratio)
        return dfeat, None, None, None, None


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    batch_idx: torch.Tensor | None = None,
    output_size: int = 14,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign -> (R, out, out, C) in the map's type (float32 or
    bfloat16): K7 on a CUDA tensor (with K7's backward when the features
    require a gradient), the plain gather form on a CPU tensor."""
    if features.dtype not in DTYPES:
        raise TypeError(f"roi_align: features in {features.dtype}; float32 or bfloat16")
    features, batch_idx = _as_batch(features, boxes, batch_idx)
    if features.device.type == "cuda":
        batch_idx = batch_idx.to(torch.int32)
        if torch.is_grad_enabled() and features.requires_grad:
            return RoIAlignFunction.apply(features, boxes, batch_idx, output_size,
                                          sampling_ratio)
        return _roi_align_cuda(features, boxes, batch_idx, output_size, sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, boxes, batch_idx, output_size, sampling_ratio)
    raise ValueError(f"roi_align: no implementation for device {features.device}")


# ------------------------------------------------------------------ levels
def roi_align_levels_plain(maps, boxes, batch_idx, levels, scales, output_size: int = 7,
                           sampling_ratio: int = 2) -> torch.Tensor:
    """RoI r pooled from ``maps[levels[r]]`` at ``boxes[r] * scales[l]`` by
    ``roi_align_plain`` -> (R, out, out, C); autograd reaches every map."""
    r, c = boxes.shape[0], maps[0].shape[-1]
    out = maps[0].new_zeros((r, output_size, output_size, c))
    for lvl, (fmap, scale) in enumerate(zip(maps, scales)):
        sel = torch.nonzero(levels == lvl)[:, 0]
        if len(sel):
            out = out.index_copy(0, sel, roi_align_plain(fmap, boxes[sel] * scale,
                                                         batch_idx[sel], output_size,
                                                         sampling_ratio))
    return out


def _levels_ints(maps):
    """The entry points' level table: (n_levels, h0, w0, .. h3, w3), the
    unused slots 0."""
    hw = [d for m in maps for d in m.shape[1:3]]
    return [len(maps)] + hw + [0] * (2 * MAX_LEVELS - len(hw))


def _check_levels(maps, boxes, batch_idx, levels, scales):
    if not 1 <= len(maps) <= MAX_LEVELS or len(scales) != len(maps):
        raise ValueError(f"roi_align_levels: 1 to {MAX_LEVELS} maps, a scale each")
    n, c = maps[0].shape[0], maps[0].shape[-1]
    if any(m.dtype != torch.float32 or m.dim() != 4 or m.shape[0] != n or m.shape[-1] != c
           for m in maps):
        raise TypeError("roi_align_levels: float32 maps (N, H, W, C) of one N and C")
    if levels.dtype != torch.int32 or levels.shape != batch_idx.shape or not \
            levels.is_contiguous():
        raise TypeError("roi_align_levels: levels must be contiguous int32, one a RoI")
    if levels.device != maps[0].device:
        raise ValueError("roi_align_levels: all operands must be on one device")


def _pointers(tensors):
    return [t.data_ptr() for t in tensors] + [0] * (MAX_LEVELS - len(tensors))


def _roi_align_levels_cuda(maps, boxes, batch_idx, levels, scales, output_size,
                           sampling_ratio):
    from tspn_tpu_torch.ops import _cuda

    for m in maps:
        _check_cuda_operands(m, boxes, batch_idx, output_size, sampling_ratio)
    n, c = maps[0].shape[0], maps[0].shape[-1]
    r = boxes.shape[0]
    out = torch.empty((r, output_size, output_size, c), dtype=torch.float32,
                      device=boxes.device)
    if r == 0 or c == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _cuda.roi_align_levels_library().tspn_roi_align_levels_launch(
            *_pointers(maps), boxes.data_ptr(), batch_idx.data_ptr(), levels.data_ptr(),
            out.data_ptr(), r, n, *_levels_ints(maps), c, output_size, sampling_ratio,
            _vec(c, *maps, out), *(list(scales) + [1.0] * (MAX_LEVELS - len(maps))),
            ctypes.c_void_p(stream))
    _cuda.check(err, "tspn_roi_align_levels_launch")
    LAUNCHES["roi_align_levels"] += 1
    return out


def _roi_align_levels_backward_cuda(grad_out, boxes, batch_idx, levels, scales, shapes,
                                    output_size, sampling_ratio):
    """dL/dmaps (one f32 buffer, zeroed once, split by level) from dL/dout."""
    from tspn_tpu_torch.ops import _cuda

    grad = grad_out.float().contiguous()
    _check_cuda_operands(grad, boxes, batch_idx, output_size, sampling_ratio)
    sizes = [math.prod(s) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=grad.device)
    dmaps = [t.view(s) for t, s in zip(flat.split(sizes), shapes)]
    r, c = boxes.shape[0], shapes[0][-1]
    if r and c:
        with torch.cuda.device(grad.device):
            stream = torch.cuda.current_stream(grad.device).cuda_stream
            err = _cuda.roi_align_levels_backward_library(
            ).tspn_roi_align_levels_backward_launch(
                grad.data_ptr(), boxes.data_ptr(), batch_idx.data_ptr(), levels.data_ptr(),
                *_pointers(dmaps), r, shapes[0][0], *_levels_ints(dmaps), c,
                output_size, sampling_ratio, _vec(c, grad, *dmaps),
                *(list(scales) + [1.0] * (MAX_LEVELS - len(dmaps))), ctypes.c_void_p(stream))
        _cuda.check(err, "tspn_roi_align_levels_backward_launch")
        LAUNCHES["roi_align_levels_backward"] += 1
    return dmaps


class RoIAlignLevelsFunction(torch.autograd.Function):
    """K7's levels forward with its backward: the gradient of each map
    only."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, levels, scales, output_size, sampling_ratio, *maps):
        ctx.save_for_backward(boxes, batch_idx, levels)
        ctx.geometry = ([tuple(m.shape) for m in maps], scales, output_size, sampling_ratio)
        return _roi_align_levels_cuda(maps, boxes, batch_idx, levels, scales, output_size,
                                      sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, batch_idx, levels = ctx.saved_tensors
        shapes, scales, output_size, sampling_ratio = ctx.geometry
        dmaps = _roi_align_levels_backward_cuda(grad_out, boxes, batch_idx, levels, scales,
                                                shapes, output_size, sampling_ratio)
        return (None,) * 6 + tuple(dmaps)


def roi_align_levels(maps, boxes: torch.Tensor, batch_idx: torch.Tensor, levels: torch.Tensor,
                     scales, output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """RoI r of (R, 4) ``boxes`` (image coordinates) pooled from image
    ``batch_idx[r]`` of ``maps[levels[r]]`` (float32 (N, H_l, W_l, C)) at
    the box times ``scales[l]`` -> (R, out, out, C): one K7 launch on a
    CUDA tensor (with one backward launch when a map requires a gradient),
    ``roi_align_levels_plain`` on a CPU tensor."""
    scales = tuple(float(v) for v in scales)
    batch_idx = batch_idx.to(torch.int32)
    _check_levels(maps, boxes, batch_idx, levels, scales)
    if boxes.device.type == "cuda":
        maps = [m.contiguous() for m in maps]
        if torch.is_grad_enabled() and any(m.requires_grad for m in maps):
            return RoIAlignLevelsFunction.apply(boxes, batch_idx, levels, scales, output_size,
                                                sampling_ratio, *maps)
        return _roi_align_levels_cuda(maps, boxes, batch_idx, levels, scales, output_size,
                                      sampling_ratio)
    if boxes.device.type == "cpu":
        return roi_align_levels_plain(maps, boxes, batch_idx, levels, scales, output_size,
                                      sampling_ratio)
    raise ValueError(f"roi_align_levels: no implementation for device {boxes.device}")
