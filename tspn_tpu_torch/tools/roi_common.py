"""What the ported RoIAlign probe tools (``bench_roialign_fused``,
``bench_roialign_variants``) share: the flags and inputs of the JAX
tools, the plain-torch legs (the separable forms the JAX package left to
XLA), the error bounds, and the leg runner.

Inputs: ``RandomState(0)`` draws exactly as the JAX tools do, so both
see the same numbers: features (B, H, W, C) ``randn`` in f32 (cast to the
map's dtype for the legs), boxes (B, R, 4) from ``uniform(0, hw - 2)``
corners and ``uniform(1, hw / 2)`` sizes. RoIAlign's out is 14 and s 2.

Bounds. Every weight of these functions is non-negative, so T = (the
f32 separable form applied to |F|) is the summed |term| of each output.
A leg computed in f32 throughout is held to ``1e-5 * T + 1e-6``; a leg
that rounds to bf16 to ``2**-5 * T + 1e-6`` against the f32 oracle: the
map, the tables, the intermediate and the output may each round (2**-8
relative each), and PyTorch's bf16 einsum on the CPU rounds its partial
sums too. A kernel is held
to its own plain version within ``1e-5 * T + 1e-6`` plus, for a bf16
output, one bf16 ulp of the plain value (``bf16_ulp``). The JAX tools' 1.5e-2 and
4e-2 relative gates absorbed the TPU's bf16 matmul passes and are not
used; their relative error figures are reported as ``parity``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tspn_tpu_torch.ops import roi_align as ra
from tspn_tpu_torch.ops import roi_probes as rp
from tspn_tpu_torch.runtime import timing

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
INV_S2 = 1.0 / (rp.RATIO * rp.RATIO)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rois", type=int, default=256)
    ap.add_argument("--hw", type=int, default=40)
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def inputs(args, dev: torch.device):
    """(f32 features, boxes) as the JAX tools draw them, on ``dev``."""
    b, r, hw, c = args.batch, args.rois, args.hw, args.channels
    rng = np.random.RandomState(0)
    feats = rng.randn(b, hw, hw, c).astype(np.float32)
    bx = rng.uniform(0, hw - 2, (b, r, 2))
    wh = rng.uniform(1, hw / 2, (b, r, 2))
    boxes = np.concatenate([bx, bx + wh], axis=-1).astype(np.float32)
    return torch.from_numpy(feats).to(dev), torch.from_numpy(boxes).to(dev)


def _tables(boxes, h, w, dtype, fold: bool):
    """Per-image lists of (wy, wx) in ``dtype``, 1/s^2 folded into wy with
    ``fold``."""
    out = []
    for bx in boxes:
        ty, tx = rp.axis_tables(bx, h, w)
        out.append(((ty * INV_S2 if fold else ty).to(dtype), tx.to(dtype)))
    return out


def sep(features, boxes):
    """The shipped separable two-einsum (``roi_align_separable``), tables
    and einsums in the map's dtype, 1/s^2 at the end."""
    b, r = boxes.shape[:2]
    idx = torch.arange(b, device=boxes.device).repeat_interleave(r)
    out = ra.roi_align_separable(features, boxes.reshape(-1, 4), idx)
    return out.reshape(b, r, *out.shape[1:])


def sep_b16t(features, boxes):
    """``sep`` with the intermediate cast to bf16 between the einsums."""
    _b, h, w, _c = features.shape
    outs = []
    for f, (wy, wx) in zip(features, _tables(boxes, h, w, features.dtype, False)):
        tmp = torch.einsum("rih,hwc->riwc", wy, f).to(torch.bfloat16)
        pooled = torch.einsum("rjw,riwc->rijc", wx.to(torch.bfloat16), tmp)
        outs.append((pooled.float() * INV_S2).to(features.dtype))
    return torch.stack(outs)


def xlasep(features, boxes):
    """The variants tool's two-einsum XLA form."""
    _b, h, w, _c = features.shape
    outs = []
    for f, (wy, wx) in zip(features, _tables(boxes, h, w, features.dtype, False)):
        tmp = torch.einsum("rih,hwc->riwc", wy, f)
        outs.append((torch.einsum("rjw,riwc->rijc", wx, tmp) * INV_S2).to(features.dtype))
    return torch.stack(outs)


def xlasep2(features, boxes):
    """The transpose-free form: one GEMM over H, then a matmul batched over
    (RoI, i) with wx broadcast over i."""
    _b, h, w, c = features.shape
    outs = []
    for f, (wy, wx) in zip(features, _tables(boxes, h, w, features.dtype, False)):
        r, out = wy.shape[:2]
        tmp = (wy @ f.reshape(h, w * c)).reshape(r, out, w, c)
        pooled = torch.matmul(wx[:, None], tmp)  # (R, i, j, C)
        outs.append((pooled * INV_S2).to(features.dtype))
    return torch.stack(outs)


def oracle(features32, boxes, chunk: int = 256):
    """``roi_align_plain`` (the gather form, f32) image by image, ``chunk``
    RoIs at a time -> (B, R, 14, 14, C)."""
    outs = []
    for f, bx in zip(features32, boxes):
        outs.append(torch.cat([ra.roi_align_plain(f, bx[k : k + chunk]) for k in
                               range(0, bx.shape[0], chunk)]))
    return torch.stack(outs)


def sum_terms(features32, boxes):
    """T, the summed |term| of each output: the f32 separable form on |F|."""
    return rp.roi_sep_fused_plain(features32.abs(), boxes)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at each |x|, 2**(floor(log2 |x|) - 7); 0 at 0."""
    x = x.double()
    _, e = torch.frexp(x)  # |x| in [2**(e-1), 2**e)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def over_bound(out, ref, terms, rel: float, ulp: bool = False) -> float:
    """max |out - ref| / (rel * T + 1e-6 [+ bf16_ulp(ref)]); <= 1 passes."""
    d = ref.double()
    tol = rel * terms.double() + 1e-6 + (bf16_ulp(d) if ulp else 0.0)
    return float(((out.double() - d).abs() / tol).max())


def rel_err(out, ref) -> float:
    """The JAX tools' parity figure: max |out - ref| / max |ref|."""
    return float((out.float() - ref).abs().max() / (ref.abs().max() + 1e-9))


def sep_ops(b, r, h, w, c) -> tuple:
    """(stage-1, stage-2) operations of the separable form."""
    return 2.0 * b * r * 14 * h * w * c, 2.0 * b * r * 14 * 14 * w * c


def materialized_g(boxes, h: int, w: int, dtype, const: bool) -> torch.Tensor:
    """(B, R * 196, H * W) G of ``roi_constg`` (``const``) or ``roi_selector``
    in ``dtype``, for the one ``torch.matmul`` with the maps that computes
    the same function: a yardstick, never called by the port."""
    b, r = boxes.shape[:2]
    if const:
        g = rp.constg_value(boxes, dtype)[:, :, None, None].expand(b, r, 14 * 14, h * w)
        return g.reshape(b, r * 14 * 14, h * w).contiguous()
    return torch.stack([rp.selector_g(*rp.axis_tables(bx, h, w), dtype).reshape(r * 14 * 14, -1)
                        for bx in boxes])


def gemm_ops(b, r, h, w, c) -> float:
    """Operations of the dense G @ F form (out^2 rows, H*W columns)."""
    return 2.0 * b * r * 14 * 14 * h * w * c


def time_leg(fn, dev, operands, out, ops) -> dict:
    """Median and quartiles of ``fn`` (``timing.times_ms``) and its bound."""
    times = timing.times_ms(fn, dev)
    q1, q3 = np.percentile(times, [25, 75])
    return {"ms": float(np.median(times)), "iqr_ms": [float(q1), float(q3)],
            **timing.bound(operands, out, ops)}


def kind(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def ops_by_kind(*parts) -> dict:
    """(kind, operations) pairs -> {kind: summed operations}, the form
    ``timing.bound`` takes for work of mixed types."""
    out = {}
    for k, n in parts:
        out[k] = out.get(k, 0.0) + n
    return out
