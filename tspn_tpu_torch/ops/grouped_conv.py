"""The grouped 3x3 convolution of ResNeXt's bottlenecks, with its weight
gradient on a hand-written kernel.

- ``grouped_conv2d``: the autograd op that ``detection/resnet.py::Conv2d``
  runs where ``groups > 1``. Forward: ``F.conv2d`` on the NCHW-contiguous
  input and weight, the output made channels-last (cuDNN's channels-last
  grouped kernels in f32 are several times slower). Backward: dY made
  NCHW-contiguous once (the copy cuDNN's own backward would make), dX by
  ``aten::convolution_backward`` with only the input's mask set, and dW by
  ``grouped_wgrad``.
- ``grouped_wgrad``: the dispatch by device. On a CUDA tensor one call of
  ``csrc/grouped_wgrad.cu`` (its main launch and a fixed-order reduction of
  the K slices), inside a ``tspn.conv2d.grouped_wgrad`` span
  (``runtime/spans.py``); it raises on what the kernel does not take (any
  dtype but float32, a kernel other than 3x3, padding other than 1,
  dilation, a stride other than 1 or 2, Cg outside 8, 16, 32, 64, C not a
  multiple of 64). On a CPU tensor ``grouped_wgrad_plain``.
- ``grouped_wgrad_plain``: im2col (``F.unfold``) and one product per group,
  the plain version of the kernel.
- ``grouped_wgrad_plan``: the kernel's tile width and K split, chosen from
  the shapes.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from tspn_tpu_torch.runtime.spans import span

SPAN = "tspn.conv2d.grouped_wgrad"
# kernel launches made by the dispatch on CUDA tensors
LAUNCHES = {"grouped_wgrad": 0}

SLAB = 64             # input channels a block of the kernel takes
STAGE_FLOATS = 14336  # a shared-memory stage: two blocks of two stages an SM
CHANNEL_GROUPS = (8, 16, 32, 64)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _GroupedConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, weight, None, stride, padding, 1, groups
                        ).contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        dy = gy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy, x, weight, None, _pair(stride), _pair(padding), (1, 1), False, (0, 0),
                groups, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            dw = grouped_wgrad(x, dy, tuple(weight.shape), stride, padding, groups)
        return dx, dw, None, None, None


def grouped_conv2d(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                   groups: int) -> torch.Tensor:
    """``F.conv2d(x, weight, None, stride, padding, 1, groups)`` on NCHW-
    contiguous ``x`` and ``weight``, given back channels-last; its weight
    gradient is ``grouped_wgrad``'s."""
    return _GroupedConv2d.apply(x, weight, stride, padding, groups)


def grouped_wgrad(x: torch.Tensor, dy: torch.Tensor, weight_shape: tuple, stride, padding,
                  groups: int) -> torch.Tensor:
    """The weight gradient (C_out, C / groups, kh, kw) of a grouped conv
    from its NCHW input ``x`` and output gradient ``dy``: the kernel on a
    CUDA tensor, ``grouped_wgrad_plain`` on a CPU tensor."""
    if x.device.type == "cuda":
        return _grouped_wgrad_cuda(x, dy, weight_shape, stride, padding, groups)
    if x.device.type == "cpu":
        return grouped_wgrad_plain(x, dy, weight_shape, stride, padding, groups)
    raise ValueError(f"grouped_wgrad: no implementation for device {x.device}")


def grouped_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, weight_shape: tuple, stride,
                        padding, groups: int) -> torch.Tensor:
    """``grouped_wgrad`` in plain PyTorch: im2col of ``x`` and, per group,
    dY (Cg_out x K) by the columns (K x Cg kh kw), K = N Ho Wo."""
    cout, cg, kh, kw = weight_shape
    n = x.shape[0]
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)  # (N, C kh kw, L)
    cols = cols.view(n, groups, cg * kh * kw, cols.shape[-1])
    dyg = dy.reshape(n, groups, cout // groups, -1)
    return torch.einsum("ngol,ngkl->gok", dyg, cols).reshape(weight_shape)


class Plan(NamedTuple):
    """The kernel's schedule: ``tw`` output columns a tile, ``ksplit`` K
    slices, ``phases`` thread sets splitting a tile, ``blocks`` in the main
    launch, ``ws_floats`` of partial sums."""
    tw: int
    ksplit: int
    phases: int
    blocks: int
    ws_floats: int


def _stage_floats(tw: int, stride: int, co_span: int) -> int:
    """Floats of one shared-memory stage (csrc/grouped_wgrad.cu's Plan)."""
    dyp = tw + 2 if tw % 4 == 0 else tw
    xw = (tw - 1) * stride + 3
    return co_span * dyp + SLAB * ((3 * xw) | 1)


def grouped_wgrad_plan(n: int, c: int, h: int, w: int, cg: int, stride: int, sms: int) -> Plan:
    """The widest tile (even, at most the output row) whose stage fits two
    blocks of two stages an SM, narrowed to cut the row into equal tiles;
    then as many K slices as bring the launch to about two blocks an SM
    (at most one a tile)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    cs = min(cg, 32) // 8
    co_span = SLAB // cg * 8 * cs
    widest = 2
    for tw in range(4, wo + wo % 2 + 1, 2):
        if _stage_floats(tw, stride, co_span) <= STAGE_FLOATS:
            widest = tw
    col_tiles = math.ceil(wo / widest)
    tw = math.ceil(wo / col_tiles)
    tw += tw % 2
    tiles = n * ho * math.ceil(wo / tw)
    blocks_y = c // SLAB * (cg // (8 * cs))
    ksplit = max(1, min(tiles, 2 * sms // blocks_y))
    phases = 4 // cs
    return Plan(tw, ksplit, phases, ksplit * blocks_y, ksplit * phases * c * cg * 9)


def _grouped_wgrad_cuda(x, dy, weight_shape, stride, padding, groups):
    from tspn_tpu_torch.ops import _cuda

    n, c, h, w = x.shape
    cout, cg, kh, kw = weight_shape
    s = _pair(stride)
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"grouped_wgrad: {x.dtype} / {dy.dtype}; the kernel takes float32")
    if (kh, kw) != (3, 3) or _pair(padding) != (1, 1) or s[0] != s[1] or s[0] not in (1, 2):
        raise ValueError(f"grouped_wgrad: kernel {(kh, kw)}, padding {padding}, stride "
                         f"{stride}; the kernel takes 3x3, padding 1, stride 1 or 2")
    if cout != c or c != groups * cg or cg not in CHANNEL_GROUPS or c % SLAB:
        raise ValueError(f"grouped_wgrad: {c} -> {cout} channels in {groups} groups; the "
                         f"kernel takes C -> C with Cg in {CHANNEL_GROUPS}, C a multiple of "
                         f"{SLAB}")
    ho, wo = (h - 1) // s[0] + 1, (w - 1) // s[0] + 1
    if dy.shape != (n, c, ho, wo) or dy.device != x.device:
        raise ValueError(f"grouped_wgrad: dY {tuple(dy.shape)} on {dy.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("grouped_wgrad: x and dY must be NCHW-contiguous")
    dev = x.device
    plan = grouped_wgrad_plan(n, c, h, w, cg, s[0],
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    dw = torch.empty(weight_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), span(SPAN):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _cuda.grouped_wgrad_library().tspn_grouped_wgrad_launch(
            x.data_ptr(), dy.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, c, h, w, cg, s[0],
            plan.tw, plan.ksplit, ctypes.c_void_p(stream))
    _cuda.check(err, "tspn_grouped_wgrad_launch")
    LAUNCHES["grouped_wgrad"] += 1
    return dw
