"""Pair-feature normalization and predicate classification.

Counterpart of ``tspn_tpu/ops/pairwise.py``. Two halves:

* Weight and feature prep in numpy, copied from the JAX package so that
  the port's device path needs neither jax nor h5py. Every copy is held
  bit-exact against its original by ``tests/test_torch_pairwise.py``.
  The 128-lane padding of the JAX package's ``*_fused``/``*_pad`` weight
  keys is a TPU workaround and is not carried over.
* The scorers in PyTorch. Two dispatchers front hand-written kernels:
  on a CUDA tensor they launch the kernel (or raise), on a CPU tensor
  they run the kernel's plain version, which is also its oracle.
  ``normalize_classify_q8s`` is the int8 x int8 segmented scorer
  (``csrc/q8s_sm90.cu``, wgmma, planned by ``q8s_plan``);
  ``normalize_classify_fused_forward`` is the f32
  fused L1 normalization + classifier over device-layout rows
  (``csrc/fused_classify.cu``, three-pass TF32 wgmma, planned by
  ``fused_plan``), and ``normalize_classify_fused`` /
  ``normalize_classify_fused_nofeatgrad`` wrap it in autograd;
  on bf16 rows the same two ops run K3's bf16 half
  (``csrc/fused_classify_bf16.cu``, ``normalize_classify_fused_bf16``);
  ``q8f_fused`` is the factored rel pass with the per-tracklet A-table
  add in its epilogue (``csrc/q8f_fused.cu``), which
  ``factored_classify_q8_fused`` runs after a q8s tracklet pass.
  K1's variants: ``normalize_classify_q8t`` (transposed operands, the same
  kernel), ``normalize_classify_q8i8`` (block scales computed in the
  kernel, ``csrc/q8s.cu``, dp4a); ``pair_probe`` is the raw int32 product of
  ``tools/bench_pair_kernels.py`` (``csrc/pair_probe.cu``, wgmma, planned
  by ``probe_plan``); ``normalize_classify_q8`` is the int8 x bf16 scorer
  (``csrc/q8_bf16.cu``).
"""

from __future__ import annotations

import ctypes
import heapq
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from tspn_tpu_torch.data.layout import DEFAULT_LAYOUT, FeatureLayout, round_up

# kernel launches made by the dispatchers on CUDA tensors
LAUNCHES = {"q8s": 0, "fused_classify": 0, "q8f_fused": 0,
            "q8i8": 0, "q8bf": 0, "q8t": 0, "q8_probe": 0, "fused_classify_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ layout prep
@lru_cache(maxsize=None)
def _permutation(layout: FeatureLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """storage column index for each device column (-1 = zero pad)."""
    perm = np.full(layout.device_dim, -1, np.int64)
    perm[: layout.head] = np.arange(layout.head)
    perm[layout.head : layout.dev_head_dim] = np.arange(
        layout.rel_start, layout.rel_start + layout.rel_dim
    )
    for k, start in enumerate(layout.bow_block_starts):
        dst = layout.dev_head_pad + k * layout.dev_block
        perm[dst : dst + layout.bow_block_size] = np.arange(
            start, start + layout.bow_block_size
        )
    return perm


def to_device_layout(feats: np.ndarray, layout: FeatureLayout = None) -> np.ndarray:
    """(..., dim) storage layout -> (..., device_dim) device layout."""
    if layout is None:
        layout = FeatureLayout.from_dim(feats.shape[-1])
    perm = _permutation(layout)
    out = np.zeros(feats.shape[:-1] + (layout.device_dim,), feats.dtype)
    valid = perm >= 0
    out[..., valid] = np.asarray(feats)[..., perm[valid]]
    return out


def weights_to_device_layout(w: np.ndarray, layout: FeatureLayout = None) -> np.ndarray:
    """(dim, R) -> (device_dim, R) matching to_device_layout."""
    if layout is None:
        layout = FeatureLayout.from_dim(w.shape[0])
    perm = _permutation(layout)
    out = np.zeros((layout.device_dim, w.shape[1]), w.dtype)
    valid = perm >= 0
    out[valid] = np.asarray(w)[perm[valid]]
    return out


def weights_from_device_layout(w_dev: np.ndarray, layout: FeatureLayout) -> np.ndarray:
    """(device_dim, R) -> (dim, R), the inverse of weights_to_device_layout
    (pad rows are dropped)."""
    perm = _permutation(layout)
    valid = perm >= 0
    w = np.zeros((layout.dim, w_dev.shape[1]), np.float32)
    w[perm[valid]] = np.asarray(w_dev)[valid]
    return w


def to_device_layout_q8(feats: np.ndarray, layout: FeatureLayout = None) -> tuple:
    """(..., dim) storage floats -> (q (..., device_dim) int8, head_scale
    (...,) f32). Head columns dequantize by head_scale; each BoW block is
    max-scaled, a scale that L1 normalization cancels."""
    if layout is None:
        layout = FeatureLayout.from_dim(feats.shape[-1])
    dev = to_device_layout(np.asarray(feats, np.float32), layout)
    hp = layout.dev_head_pad
    q = np.zeros(dev.shape, np.int8)

    head = dev[..., :hp]
    head_max = np.max(np.abs(head), axis=-1)
    head_scale = np.where(head_max > 0, head_max / 127.0, 1.0).astype(np.float32)
    q[..., :hp] = np.clip(
        np.rint(head / head_scale[..., None]), -127, 127
    ).astype(np.int8)

    lead = dev.shape[:-1]
    bow = dev[..., hp:].reshape(*lead, layout.num_bow_blocks, layout.dev_block)
    bmax = np.max(np.abs(bow), axis=-1, keepdims=True)
    bscale = np.where(bmax > 0, bmax / 127.0, 1.0)
    q[..., hp:] = np.clip(np.rint(bow / bscale), -127, 127).reshape(
        *lead, layout.num_bow_blocks * layout.dev_block
    ).astype(np.int8)
    return q, head_scale


def quantize_weights_percol(w_dev: np.ndarray) -> tuple:
    """(D, R) f32 -> (qW (D, R) int8, sW (R,) f32), per-column max scaling."""
    w = np.asarray(w_dev, np.float32)
    cmax = np.max(np.abs(w), axis=0)
    sw = np.where(cmax > 0, cmax / 127.0, 1.0).astype(np.float32)
    qw = np.clip(np.rint(w / sw[None, :]), -127, 127).astype(np.int8)
    return qw, sw


def precompute_q8_scales(
    q: np.ndarray, head_scale: np.ndarray, layout: FeatureLayout = DEFAULT_LAYOUT
) -> np.ndarray:
    """(P, 16) f32 row multipliers: col 0 = head scale, cols
    1..num_bow_blocks = 1/L1(q_block) (1 for empty blocks), rest zero."""
    p = q.shape[0]
    hp = layout.dev_head_pad
    out = np.zeros((p, 16), np.float32)
    out[:, 0] = head_scale
    bow = np.abs(q[:, hp:].astype(np.int32)).reshape(
        p, layout.num_bow_blocks, layout.dev_block
    )
    denom = bow.sum(axis=-1).astype(np.float32)
    out[:, 1 : 1 + layout.num_bow_blocks] = 1.0 / np.where(denom > 0, denom, 1.0)
    return out


# ------------------------------------------------------- factored geometry
class BlockGeom(NamedTuple):
    """Geometry of a q8s row: a head slab of ``dev_head_pad`` columns
    followed by ``num_bow_blocks`` blocks of ``dev_block`` columns
    (duck-types FeatureLayout's fields)."""

    dev_head_pad: int
    num_bow_blocks: int = 0
    dev_block: int = 1024

    @property
    def device_dim(self) -> int:
        return self.dev_head_pad + self.num_bow_blocks * self.dev_block


def tracklet_geom(layout: FeatureLayout = DEFAULT_LAYOUT) -> BlockGeom:
    """Per-tracklet factored rows: [classeme C | pad to 128 | 4 x 1024]."""
    return BlockGeom(
        dev_head_pad=round_up(layout.classeme_dim, 128),
        num_bow_blocks=layout.num_bow_blocks // 2,
        dev_block=layout.dev_block,
    )


def rel_geom(layout: FeatureLayout = DEFAULT_LAYOUT) -> BlockGeom:
    """Per-pair factored rows: [relative 3000 | pad to 3072], no blocks."""
    return BlockGeom(dev_head_pad=round_up(layout.rel_dim, 128))


def factor_tracklet_features_q8(
    classemes: np.ndarray,   # (N, C) float
    motion_bow: np.ndarray,  # (N, 4 * 1000) float, one role's BoW blocks
    layout: FeatureLayout = DEFAULT_LAYOUT,
) -> tuple:
    """-> (q (N, trk_dim) int8, scales (N, 16) f32): col 0 = classeme
    dequant scale, cols 1..4 = 1/L1 of each quantized BoW block."""
    geom = tracklet_geom(layout)
    n = classemes.shape[0]
    c = layout.classeme_dim
    bs = layout.bow_block_size
    q = np.zeros((n, geom.device_dim), np.int8)
    scales = np.zeros((n, 16), np.float32)

    cmax = np.max(np.abs(classemes), axis=-1)
    cscale = np.where(cmax > 0, cmax / 127.0, 1.0).astype(np.float32)
    q[:, :c] = np.clip(
        np.rint(classemes / cscale[:, None]), -127, 127
    ).astype(np.int8)
    scales[:, 0] = cscale

    bow = np.asarray(motion_bow, np.float32).reshape(n, geom.num_bow_blocks, bs)
    bmax = np.max(np.abs(bow), axis=-1, keepdims=True)
    bscale = np.where(bmax > 0, bmax / 127.0, 1.0)
    qb = np.clip(np.rint(bow / bscale), -127, 127).astype(np.int8)
    for k in range(geom.num_bow_blocks):
        lo = geom.dev_head_pad + k * geom.dev_block
        q[:, lo : lo + bs] = qb[:, k]
    denom = np.abs(qb.astype(np.int32)).sum(axis=-1).astype(np.float32)
    scales[:, 1 : 1 + geom.num_bow_blocks] = 1.0 / np.where(denom > 0, denom, 1.0)
    return q, scales


def factor_rel_features_q8(
    rel: np.ndarray, layout: FeatureLayout = DEFAULT_LAYOUT
) -> tuple:
    """(P, 3000) float -> (q (P, 3072) int8, scales (P, 16) f32 col 0)."""
    geom = rel_geom(layout)
    p = rel.shape[0]
    q = np.zeros((p, geom.device_dim), np.int8)
    rmax = np.max(np.abs(rel), axis=-1)
    rscale = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
    q[:, : layout.rel_dim] = np.clip(
        np.rint(rel / rscale[:, None]), -127, 127
    ).astype(np.int8)
    scales = np.zeros((p, 16), np.float32)
    scales[:, 0] = rscale
    return q, scales


def factor_expanded_rows_q8(
    feats: np.ndarray,   # (P, dim) expanded storage rows
    pairs: np.ndarray,   # (P, 2) tracklet indices
    num_tracklets: int,
    layout: FeatureLayout = None,
) -> tuple:
    """Factor expanded storage rows into per-tracklet + per-pair q8 rows.
    Tracklet n's descriptors come from its earliest row in either role
    (subject wins a same-row tie). -> (trk_q, trk_scales, rel_q, rel_scales)."""
    if layout is None:
        layout = FeatureLayout.from_dim(feats.shape[-1])
    c = layout.classeme_dim
    n = num_tracklets
    half = layout.num_bow_blocks // 2 * layout.bow_block_size
    cls = np.zeros((n, c), np.float32)
    bow = np.zeros((n, half), np.float32)
    p = pairs.shape[0]
    first = np.full((n, 2), p, np.int64)  # (tracklet, role) -> row
    for role in (0, 1):
        ids, idx = np.unique(pairs[:, role].astype(np.int64), return_index=True)
        keep = (ids >= 0) & (ids < n)
        first[ids[keep], role] = idx[keep]
    use_sub = first[:, 0] <= first[:, 1]
    row = np.where(use_sub, first[:, 0], first[:, 1])
    seen = row < p
    sub_rows = seen & use_sub
    obj_rows = seen & ~use_sub
    cls[sub_rows] = feats[row[sub_rows], :c]
    bow[sub_rows] = feats[row[sub_rows], layout.bow_start : layout.bow_start + half]
    cls[obj_rows] = feats[row[obj_rows], c : 2 * c]
    bow[obj_rows] = feats[row[obj_rows], layout.bow_start + half : layout.rel_start]
    trk_q, trk_scales = factor_tracklet_features_q8(cls, bow, layout)
    rel_q, rel_scales = factor_rel_features_q8(feats[:, layout.rel_start :], layout)
    return trk_q, trk_scales, rel_q, rel_scales


def split_weights_factored(w: np.ndarray, layout: FeatureLayout = None) -> dict:
    """Split + per-column-quantize the storage-layout classifier (dim, R)
    for the factored path: {"qw_trk" (trk_dim, 2R), "sw_trk" (2R,),
    "qw_rel" (rel_pad, R), "sw_rel" (R,)}, subject role in output columns
    [0, R) and object role in [R, 2R)."""
    if layout is None:
        layout = FeatureLayout.from_dim(w.shape[0])
    c = layout.classeme_dim
    bs = layout.bow_block_size
    half_blocks = layout.num_bow_blocks // 2
    geom_t = tracklet_geom(layout)
    r = w.shape[1]

    w_trk = np.zeros((geom_t.device_dim, 2 * r), np.float32)
    w_trk[:c, :r] = w[:c]
    w_trk[:c, r:] = w[c : 2 * c]
    for k in range(half_blocks):
        lo = geom_t.dev_head_pad + k * geom_t.dev_block
        src_sub = layout.bow_start + k * bs
        src_obj = layout.bow_start + (half_blocks + k) * bs
        w_trk[lo : lo + bs, :r] = w[src_sub : src_sub + bs]
        w_trk[lo : lo + bs, r:] = w[src_obj : src_obj + bs]

    w_rel = np.zeros((rel_geom(layout).device_dim, r), np.float32)
    w_rel[: layout.rel_dim] = w[layout.rel_start :]

    qw_trk, sw_trk = quantize_weights_percol(w_trk)
    qw_rel, sw_rel = quantize_weights_percol(w_rel)
    return {"qw_trk": qw_trk, "sw_trk": sw_trk, "qw_rel": qw_rel, "sw_rel": sw_rel}


# ---------------------------------------------------------------- scorers
def normalize_classify(
    feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = None,
) -> torch.Tensor:
    """Raw storage-layout rows (..., dim) -> (..., R): L1-normalize the
    eight BoW blocks (a zero block stays zero), then ``@ w + b``."""
    if layout is None:
        layout = FeatureLayout.from_dim(feats.shape[-1])
    lead = feats.shape[:-1]
    head = feats[..., : layout.head]
    bow = feats[..., layout.head : layout.rel_start].reshape(
        *lead, layout.num_bow_blocks, layout.bow_block_size
    )
    denom = bow.abs().sum(dim=-1, keepdim=True)
    bow_n = (bow / torch.where(denom > 0, denom, torch.ones_like(denom))).reshape(
        *lead, layout.num_bow_blocks * layout.bow_block_size
    )
    xn = torch.cat([head, bow_n, feats[..., layout.rel_start :]], dim=-1)
    return xn @ w + b


def _normalize_device_layout(
    feats_dev: torch.Tensor, layout: FeatureLayout = DEFAULT_LAYOUT
) -> torch.Tensor:
    """L1-normalize the BoW slots of device-layout rows (..., device_dim)
    by division, as the JAX package's XLA path does."""
    lead = feats_dev.shape[:-1]
    hp = layout.dev_head_pad
    bow = feats_dev[..., hp:].reshape(*lead, layout.num_bow_blocks, layout.dev_block)
    denom = bow.abs().sum(dim=-1, keepdim=True)
    bow_n = (bow / torch.where(denom > 0, denom, torch.ones_like(denom))).reshape(
        *lead, layout.num_bow_blocks * layout.dev_block
    )
    return torch.cat([feats_dev[..., :hp], bow_n], dim=-1)


def normalize_classify_device(
    feats_dev: torch.Tensor, w_dev: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT,
) -> torch.Tensor:
    """Device-layout rows (..., device_dim) -> (..., R): L1-normalize the
    BoW slots (a zero block stays zero), then ``@ w_dev + b``."""
    return _normalize_device_layout(feats_dev, layout) @ w_dev + b


def normalize_classify_fused_plain(
    x: torch.Tensor, w_dev: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT,
) -> torch.Tensor:
    """Plain version of the fused_classify kernel, (P, D) f32 -> (P, R) f32.

    As the kernel does: each BoW block's L1 sum s is taken in f32 and the
    block is multiplied by ``s > 0 ? 1/s : 1`` (a reciprocal multiply,
    not a division); the head slab passes through; then ``@ w_dev + b``
    in f32. The kernel sums in another order, so it agrees with this
    within a tolerance, not bit for bit. On a card, run it with
    ``torch.backends.cuda.matmul.allow_tf32 = False``.
    """
    p = x.shape[0]
    hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
    bow = x[:, hp:].reshape(p, nb, blk)
    s = bow.abs().sum(dim=-1, keepdim=True)
    scale = torch.where(s > 0, 1.0 / s, torch.ones_like(s))
    xn = torch.cat([x[:, :hp], (bow * scale).reshape(p, nb * blk)], dim=1)
    return xn @ w_dev + b


def _require(name: str, tensors: tuple, dtypes: tuple, shapes: tuple,
             aligned: tuple = ()) -> None:
    """Raise unless the operands lie on one device with these dtypes and
    shapes, contiguous, and each of ``aligned`` starts on 16 bytes."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if any(t.dtype != dt for t, dt in zip(tensors, dtypes)):
        raise TypeError(f"{name}: operand dtypes {[t.dtype for t in tensors]}, "
                        f"want {list(dtypes)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if any(tuple(t.shape) != s for t, s in zip(tensors, shapes)):
        raise ValueError(f"{name}: bad shapes {[tuple(t.shape) for t in tensors]}, "
                         f"want {list(shapes)}")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: the int8 and bf16 operands must be 16-byte aligned")


def _require_geom(name: str, geom, d: int) -> None:
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    if d != geom.device_dim or hp % 64 or blk % 64 or nb > 15:
        raise ValueError(f"{name}: geometry {geom} does not fit width {d}")


def _launch(key: str, library: str, entry: str, device, args: tuple,
            counts: dict = LAUNCHES) -> None:
    """Call the C entry ``entry`` of ``_cuda.<library>()`` with ``args`` on
    the current stream of ``device``, raise on its error, count it in
    ``counts[key]``."""
    from tspn_tpu_torch.ops import _cuda

    lib = getattr(_cuda, library)()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    _cuda.check(err, entry)
    counts[key] += 1


def _dispatch(name: str, lead: torch.Tensor, kernel, plain, *args) -> torch.Tensor:
    """``kernel(*args)`` for a CUDA ``lead`` operand, ``plain(*args)`` for a
    CPU one; any other device raises."""
    if lead.device.type == "cuda":
        return kernel(*args)
    if lead.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"{name}: no implementation for device {lead.device}")


# csrc/fused_classify.cu's tile: 128 rows x 136 output columns, D in chunks
# of 32 floats; the head is folded in shares of at most 1024 columns, and a
# launch takes at most 32 units (shares and BoW blocks)
FUSED_TILE_ROWS, FUSED_N, FUSED_CHUNK, FUSED_HEAD_SHARE, FUSED_MAX_UNITS = 128, 136, 32, 1024, 32
# fused_plan's cost model, from the kernel's design (NVIDIA H100 SXM, 700 W):
# one SM takes about 0.9 us for a chunk of a tile (4 k8 steps x 3 TF32
# passes of 64 x 136 for each of two warpgroups at 494.7 TFLOP/s); the
# split's f32 slabs cross L2 twice at about 0.9 us a MB, and the fold
# kernel adds about 5 us.
FUSED_CHUNK_US, FUSED_WS_US_PER_MB, FUSED_FOLD_US = 0.9, 0.9, 5.0


class FusedPlan(NamedTuple):
    """How ``csrc/fused_classify.cu`` runs one call (``fused_plan``)."""
    tiles: int     # row tiles x column tiles
    units: tuple   # (first chunk, end chunk, scaled) of each unit, in fold order
    pieces: tuple  # (first unit, end unit) of each piece, in fold order

    @property
    def split(self) -> bool:
        return len(self.pieces) > 1

    @property
    def blocks(self) -> int:
        return self.tiles * len(self.pieces)

    def table(self) -> tuple:
        """The kernel's unit table: (first chunk, end chunk, scaled, piece)
        of each unit in fold order."""
        return tuple((lo, hi, s, i) for i, (a, e) in enumerate(self.pieces)
                     for lo, hi, s in self.units[a:e])


def fused_units(layout) -> tuple:
    """The fold units of K3's kernel: the head in about equal shares of at
    most ``FUSED_HEAD_SHARE`` columns (scale 1), then each BoW block (scaled
    by its 1/L1), as (first chunk, end chunk, scaled) of 32 columns."""
    hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
    c, head = FUSED_CHUNK, layout.dev_head_pad // FUSED_CHUNK
    shares = -(-hp // FUSED_HEAD_SHARE)
    cuts = [j * head // shares for j in range(shares + 1)]
    units = [(a, b, 0) for a, b in zip(cuts, cuts[1:]) if b > a]
    units += [((hp + k * blk) // c, (hp + (k + 1) * blk) // c, 1) for k in range(nb)]
    return tuple(units)


def _partitions(lengths: list, n: int) -> tuple:
    """The cut of ``lengths`` into ``n`` contiguous groups whose largest sum
    is least (the first such cut, by dynamic programming) -> ((lo, hi), ...)."""
    m = len(lengths)
    pre = [0]
    for v in lengths:
        pre.append(pre[-1] + v)
    best = {(0, 0): (0, None)}  # (groups, units) -> (largest sum, last cut)
    for k in range(1, n + 1):
        for j in range(k, m + 1):
            options = [(max(best[(k - 1, i)][0], pre[j] - pre[i]), i)
                       for i in range(k - 1, j) if (k - 1, i) in best]
            best[(k, j)] = min(options)
    cuts, j = [], m
    for k in range(n, 0, -1):
        i = best[(k, j)][1]
        cuts.append((i, j))
        j = i
    return tuple(reversed(cuts))


def _makespan(tiles: int, sizes: list, sms: int) -> int:
    """Chunks the busiest SM runs when the blocks (piece-major, one block an
    SM at a time) go to whichever SM frees first."""
    free = [0] * min(sms, tiles * len(sizes))
    for size in sizes:
        for _ in range(tiles):
            heapq.heapreplace(free, free[0] + size)
    return max(free)


@lru_cache(maxsize=256)
def fused_plan(p: int, r: int, layout, sms: int) -> FusedPlan:
    """K3's plan for P rows and R outputs at ``layout`` on a card of ``sms``
    SMs. Every tile runs all units in one block, unless cutting the units
    into pieces (each piece's units contiguous, the cut that least loads
    its largest piece) takes less time by the cost model above: then a block
    runs one (tile, piece) and a second kernel folds the pieces."""
    units = fused_units(layout)
    lengths = [hi - lo for lo, hi, _s in units]
    tiles = -(-p // FUSED_TILE_ROWS) * -(-r // FUSED_N)
    best = None
    for n in range(1, len(units) + 1 if tiles < sms else 2):
        pieces = _partitions(lengths, n)
        sizes = [sum(lengths[a:b]) for a, b in pieces]
        us = FUSED_CHUNK_US * _makespan(tiles, sizes, sms)
        if n > 1:
            us += FUSED_FOLD_US + FUSED_WS_US_PER_MB * 2 * n * p * r * 4 / 1e6
        if best is None or us < best[0]:
            best = (us, pieces)
    return FusedPlan(tiles, units, best[1])


def _tf32_weights(w_dev: torch.Tensor) -> torch.Tensor:
    """K3's B operand (2 n_pad, D) f32 from W (D, R): tf32(W)^T and
    tf32(W - tf32(W))^T, prepared on the card by the prep kernel (each
    call: a training step changes W)."""
    d, r = w_dev.shape
    n_pad = -(-r // FUSED_N) * FUSED_N
    wt = torch.empty((2 * n_pad, d), dtype=torch.float32, device=w_dev.device)
    from tspn_tpu_torch.ops import _cuda

    lib = _cuda.fused_classify_prep_library()
    with torch.cuda.device(w_dev.device):
        stream = torch.cuda.current_stream(w_dev.device).cuda_stream
        err = lib.tspn_fused_classify_prep_launch(w_dev.data_ptr(), wt.data_ptr(), d, r,
                                                  ctypes.c_void_p(stream))
    _cuda.check(err, "tspn_fused_classify_prep_launch")
    return wt


def _fused_classify_cuda(x, w_dev, b, layout) -> torch.Tensor:
    p, d = x.shape
    r = w_dev.shape[1]
    hp, blk = layout.dev_head_pad, layout.dev_block
    f32 = torch.float32
    _require("fused_classify", (x, w_dev, b), (f32, f32, f32), ((p, d), (d, r), (r,)),
             aligned=(x,))
    if (d != layout.device_dim or hp % FUSED_CHUNK or blk % FUSED_CHUNK
            or len(fused_units(layout)) > FUSED_MAX_UNITS):
        raise ValueError(f"fused_classify: layout {layout} does not fit width {d}")
    out = torch.empty((p, r), dtype=f32, device=x.device)
    if not (p and r):
        return out
    wt = _tf32_weights(w_dev)
    plan = fused_plan(p, r, layout,
                      torch.cuda.get_device_properties(x.device).multi_processor_count)
    # the split's pieces store their f32 folds in a slab each
    ws = (torch.empty((len(plan.pieces), p, r), dtype=f32, device=x.device)
          if plan.split else out)
    quads = plan.table()
    table = (ctypes.c_int32 * (4 * len(quads)))(*(v for q in quads for v in q))
    _launch("fused_classify", "fused_classify_library", "tspn_fused_classify_launch",
            x.device, (x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(),
                       ws.data_ptr(), ctypes.addressof(table), p, r, d, len(quads)))
    return out


def normalize_classify_fused_bf16_plain(
    x: torch.Tensor, w_bf16_t: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT,
) -> torch.Tensor:
    """Plain version of K3's bf16 half, (P, D) bf16 rows, (R, D) bf16
    K-major weights (``weights_bf16_t``), (R,) f32 b -> (P, R) f32.

    As the TPU kernel (``_kernel`` on bf16 rows) does: each BoW block's L1
    sum s is taken in f32, ``scale = s > 0 ? 1/s : 1`` is an IEEE divide,
    the block times scale is rounded to bf16 (nearest even), the head
    passes through, then bf16 x bf16 with f32 accumulation (each product
    is exact in f32) plus b in f32. The kernel sums |x| in another order,
    so a normalized value near a bf16 rounding midpoint can round one ulp
    apart: it agrees with this within ``1e-5 * T + 2**-8 * M`` (T the
    summed |terms|, M the largest |term|), not bit for bit. On a card, run
    it with ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    p = x.shape[0]
    hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
    bow = x[:, hp:].float().reshape(p, nb, blk)
    s = bow.abs().sum(dim=-1, keepdim=True)
    one = torch.ones_like(s)
    scale = torch.where(s > 0, one / torch.where(s > 0, s, one), one)
    bow_n = (bow * scale).to(torch.bfloat16).reshape(p, nb * blk)
    xn = torch.cat([x[:, :hp], bow_n], dim=1)
    return xn.float() @ w_bf16_t.float().T + b


def _fused_classify_bf16_cuda(x, w_bf16_t, b, layout) -> torch.Tensor:
    p, d = x.shape
    r = w_bf16_t.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    _require("fused_classify_bf16", (x, w_bf16_t, b), (bf16, bf16, f32),
             ((p, d), (r, d), (r,)), aligned=(x, w_bf16_t))
    _require_geom("fused_classify_bf16", layout, d)
    if layout.dev_block % 256:
        raise ValueError(f"fused_classify_bf16: BoW slots of {layout.dev_block} are not a "
                         "multiple of 256 (the kernel's L1 pass reduces 256 at a time)")
    out = torch.empty((p, r), dtype=f32, device=x.device)
    if p and r:
        _launch("fused_classify_bf16", "fused_classify_bf16_library",
                "tspn_fused_classify_bf16_launch", x.device,
                (x.data_ptr(), w_bf16_t.data_ptr(), b.data_ptr(), out.data_ptr(),
                 p, r, d, layout.dev_head_pad, layout.dev_block))
    return out


def normalize_classify_fused_bf16(
    x: torch.Tensor, w_bf16_t: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT, plain: bool = False,
) -> torch.Tensor:
    """K3's bf16 half, (P, D) bf16 rows -> (P, R) f32, with the weights
    already prepared by ``weights_bf16_t``: the kernel on a CUDA tensor,
    the plain version on a CPU tensor (or with ``plain=True``)."""
    if plain:
        return normalize_classify_fused_bf16_plain(x, w_bf16_t, b, layout)
    return _dispatch("fused_classify_bf16", x, _fused_classify_bf16_cuda,
                     normalize_classify_fused_bf16_plain, x, w_bf16_t, b, layout)


def normalize_classify_fused_forward(
    x: torch.Tensor, w_dev: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT, plain: bool = False,
) -> torch.Tensor:
    """Fused normalize + classify, (P, device_dim) f32 or bf16 -> (P, R)
    f32: the kernel on a CUDA tensor, the plain version on a CPU tensor
    (or with ``plain=True``, on any device). On bf16 rows W is cast to
    bf16 (nearest even) as the TPU kernel casts it to the rows' dtype."""
    if x.dtype == torch.bfloat16:
        return normalize_classify_fused_bf16(x, weights_bf16_t(w_dev), b, layout, plain)
    if x.dtype != torch.float32:
        raise TypeError(f"fused classifier in {x.dtype}: float32 or bfloat16 rows only")
    if plain or x.device.type == "cpu":
        return normalize_classify_fused_plain(x, w_dev, b, layout)
    if x.device.type == "cuda":
        return _fused_classify_cuda(x, w_dev, b, layout)
    raise ValueError(f"fused_classify: no implementation for device {x.device}")


class _FusedClassify(torch.autograd.Function):
    """The kernel's forward with the general backward of
    ``tspn_tpu/ops/pairwise.py::_fused_for_layout`` (plain PyTorch, as the
    JAX package's VJP is XLA). For a block x_b with s = sum|x_b| > 0 and
    u = g @ W^T: d x_b = u/s - sign(x_b) <u, x_b> / s^2; the head passes
    u through. The backward normalizes in f32 whatever the rows' dtype and
    returns dx, dW and db in the dtypes of x, W and b (bf16 rows and W
    give a bf16 dW, as the JAX VJP does)."""

    @staticmethod
    def forward(ctx, x, w_dev, b, layout, plain):
        ctx.layout = layout
        ctx.b_dtype = b.dtype
        ctx.save_for_backward(x, w_dev)
        return normalize_classify_fused_forward(x, w_dev, b, layout, plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        layout = ctx.layout
        g = g.float()
        dw = _normalize_device_layout(x.float(), layout).T @ g
        db = g.sum(dim=0)
        u = g @ w.float().T
        p = x.shape[0]
        hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
        xb = x[:, hp:].float().reshape(p, nb, blk)
        ub = u[:, hp:].reshape(p, nb, blk)
        s = xb.abs().sum(dim=-1, keepdim=True)
        safe = s > 0
        s1 = torch.where(safe, s, torch.ones_like(s))
        inner = (ub * xb).sum(dim=-1, keepdim=True)
        dxb = torch.where(safe, ub / s1 - torch.sign(xb) * inner / (s1 * s1), ub)
        dx = torch.cat([u[:, :hp], dxb.reshape(p, nb * blk)], dim=1).to(x.dtype)
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype), None, None


class _FusedClassifyNoFeatGrad(torch.autograd.Function):
    """The kernel's forward with the backward of
    ``_fused_nofeatgrad_for_layout``: dW = N(x)^T g and db = sum g only.
    The pair features are data-pipeline inputs, so their cotangent is a
    structural zero (returned as zeros only if x asks for a gradient)."""

    @staticmethod
    def forward(ctx, x, w_dev, b, layout, plain):
        ctx.layout = layout
        ctx.save_for_backward(x)
        ctx.w_dtype, ctx.b_dtype = w_dev.dtype, b.dtype
        return normalize_classify_fused_forward(x, w_dev, b, layout, plain)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = g.float()
        dw = _normalize_device_layout(x.float(), ctx.layout).T @ g
        db = g.sum(dim=0)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return dx, dw.to(ctx.w_dtype), db.to(ctx.b_dtype), None, None


def normalize_classify_fused(
    x: torch.Tensor, w_dev: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT, plain: bool = False,
) -> torch.Tensor:
    """Differentiable fused op, (P, device_dim) -> (P, R), general backward."""
    return _FusedClassify.apply(x, w_dev, b, layout, plain)


def normalize_classify_fused_nofeatgrad(
    x: torch.Tensor, w_dev: torch.Tensor, b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT, plain: bool = False,
) -> torch.Tensor:
    """Fused op whose backward gives only dW and db (the training path)."""
    return _FusedClassifyNoFeatGrad.apply(x, w_dev, b, layout, plain)


def normalize_classify_q8s_plain(
    q: torch.Tensor,       # (P, D) int8
    scales: torch.Tensor,  # (P, 16) f32, precompute_q8_scales
    qw_t: torch.Tensor,    # (R, D) int8, K-major
    sw: torch.Tensor,      # (R,) f32
    b: torch.Tensor,       # (R,) f32
    geom,
) -> torch.Tensor:
    """Plain version of the q8s kernel: -> (P, R) f32.

    The integer products are summed in float64, which is exact here
    (|sum| <= 127^2 * 11264 < 2^53) and runs on every device (PyTorch has
    no int32 GEMM on CUDA). Each segment's exact sum is rounded to f32
    and folded in the kernel's order: head, then blocks 0..nb-1, then
    ``acc * sw + b``; so the kernel must equal this bit for bit.
    """
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    qd = q.to(torch.float64)
    wd = qw_t.to(torch.float64)

    def seg(lo, hi):
        return (qd[:, lo:hi] @ wd[:, lo:hi].T).to(torch.float32)

    acc = seg(0, hp) * scales[:, 0:1]
    for k in range(nb):
        lo = hp + k * blk
        acc = acc + seg(lo, lo + blk) * scales[:, k + 1 : k + 2]
    return acc * sw + b


# csrc/q8s_sm90.cu's tile: 128 rows x 144 output columns, D in chunks of 128
# bytes; a tile's work is cut into at most 64 pieces
Q8S_TILE_ROWS, Q8S_N, Q8S_CHUNK, Q8S_MAX_PIECES = 128, 144, 128, 64
# q8s_plan's cost model, from design probes on an H100 SXM at 700 W: one SM
# takes about 0.65 us for a chunk of a tile whose rows come by TMA, 3.9 us
# where K6's producers stage them by loads; the split's int32 sums cross L2
# twice (stored by the pieces, read by the fold kernel) at about 0.9 us a
# MB, and the fold kernel adds about 5 us.
Q8S_CHUNK_US = {"tma": 0.65, "loads": 3.9}
Q8S_WS_US_PER_MB, Q8S_FOLD_US = 0.9, 5.0


class Q8sPlan(NamedTuple):
    """How ``csrc/q8s_sm90.cu`` runs one call (``q8s_plan``)."""
    tiles: int       # row tiles x column blocks
    segments: tuple  # (lo, hi) bytes of D of each segment, in fold order
    pieces: tuple    # (segment, lo chunk, hi chunk) of a tile's work, in fold order
    split: bool      # one work item a (tile, piece) and a fold kernel; else one a tile
    staging: str     # how K6's xt reaches shared memory: "tma", "word" or "shift"
    grid: int        # persistent blocks

    @property
    def items(self) -> int:
        return self.tiles * (len(self.pieces) if self.split else 1)


def _q8s_cuts(chunks: list):
    """Every way to cut a tile's segments into shares of whole chunks of at
    most ``size`` chunks each, about equal, as ``(size, pieces)``, from
    whole segments down to pieces of one chunk (at most 64 pieces)."""
    for size in range(max(chunks), 0, -1):
        shares = [-(-c // size) for c in chunks]
        if sum(shares) > Q8S_MAX_PIECES:
            return
        yield size, tuple((k, j * c // n, (j + 1) * c // n)
                          for k, (c, n) in enumerate(zip(chunks, shares)) for j in range(n))


def q8s_plan(p: int, r: int, d: int, geom, sms: int, transposed: bool = False) -> Q8sPlan:
    """K1's (or, ``transposed``, K6's) plan for P rows of width D and R
    outputs at ``geom`` on a card of ``sms`` SMs. A tile is one work item
    that folds its segments in registers, unless there are fewer tiles
    than SMs and a split takes less time by the cost model above: then a
    tile's work is cut into pieces (each segment into shares of about
    equal length; of the cuts ``_q8s_cuts`` offers, the one the model
    times lowest), one work item each, and a second kernel folds them."""
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    segments = ((0, hp),) + tuple((hp + k * blk, hp + (k + 1) * blk) for k in range(nb))
    chunks = [-(-(hi - lo) // Q8S_CHUNK) for lo, hi in segments]
    tiles = -(-p // Q8S_TILE_ROWS) * -(-r // Q8S_N)
    staging = ("tma" if not transposed or p % 16 == 0 else "word" if p % 4 == 0
               else "shift")
    chunk_us = Q8S_CHUNK_US["tma" if staging == "tma" else "loads"]
    pieces = tuple((k, 0, c) for k, c in enumerate(chunks))
    best_us, split = chunk_us * sum(chunks) * -(-tiles // sms), False
    for size, cut in (_q8s_cuts(chunks) if tiles < sms else ()):
        us = (chunk_us * -(-tiles * len(cut) // sms) * size + Q8S_FOLD_US
              + Q8S_WS_US_PER_MB * 2 * len(cut) * p * r * 4 / 1e6)
        if us < best_us:
            best_us, pieces, split = us, cut, True
    items = tiles * (len(pieces) if split else 1)
    return Q8sPlan(tiles, segments, pieces, split, staging, min(items, sms))


def _q8s_sm90(key: str, x, scales, qw_t, sw, b, geom, transposed: bool) -> torch.Tensor:
    """Launch K1 (x = q (P, D), scales (P, 16) -> (P, R)) or K6 (x = xt (D,
    P), scales_t (16, P) -> (R, P)) on ``csrc/q8s_sm90.cu`` as
    ``q8s_plan`` cuts it."""
    d, p = x.shape if transposed else x.shape[::-1]
    r = qw_t.shape[0]
    f32, i8 = torch.float32, torch.int8
    s_shape, out_shape = ((16, p), (r, p)) if transposed else ((p, 16), (p, r))
    _require(key, (x, scales, qw_t, sw, b), (i8, f32, i8, f32, f32),
             (tuple(x.shape), s_shape, (r, d), (r,), (r,)), aligned=(x, qw_t))
    _require_geom(key, geom, d)
    if d >= 1 << 17:
        raise ValueError(f"{key}: width {d} is not below 2^17")
    out = torch.empty(out_shape, dtype=f32, device=x.device)
    if not (p and r):
        return out
    plan = q8s_plan(p, r, d, geom, torch.cuda.get_device_properties(x.device).multi_processor_count,
                    transposed)
    # the split's pieces store their int32 sums in a slab each
    ws = (torch.empty((len(plan.pieces), *out_shape), dtype=torch.int32, device=x.device)
          if plan.split else out)
    table = (ctypes.c_int32 * (3 * len(plan.pieces)))(*(v for pc in plan.pieces for v in pc))
    _launch(key, "q8s_sm90_library", "tspn_q8s_sm90_launch", x.device, (
        x.data_ptr(), scales.data_ptr(), qw_t.data_ptr(), sw.data_ptr(), b.data_ptr(),
        out.data_ptr(), ws.data_ptr(), ctypes.addressof(table), int(transposed), p, r, d,
        geom.dev_head_pad, geom.dev_block, len(plan.pieces), int(plan.split),
        int(plan.staging != "tma"), plan.grid))
    return out


def _q8s_cuda(q, scales, qw_t, sw, b, geom) -> torch.Tensor:
    return _q8s_sm90("q8s", q, scales, qw_t, sw, b, geom, transposed=False)


def normalize_classify_q8s(q, scales, qw_t, sw, b, geom) -> torch.Tensor:
    """int8 x int8 segmented scorer, (P, D) -> (P, R) f32: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8s", q, _q8s_cuda, normalize_classify_q8s_plain,
                     q, scales, qw_t, sw, b, geom)


# ----------------------------------------- K1's variants, and the bf16 scorer
PROBE_MODES = ("stream", "onedot", "blocks_noscale")
PROBE_STREAM_ROWS = 32  # the rows that the probe's "stream" mode computes
# csrc/pair_probe.cu's tile: 128 pairs x N output rows (160, or 32 in stream
# mode), D in chunks of 128 bytes
PROBE_TILE_PAIRS, PROBE_CHUNK, PROBE_N = 128, 128, 160


def q8_block_scales(q: torch.Tensor, head_scale: torch.Tensor, geom) -> torch.Tensor:
    """``precompute_q8_scales`` in torch, on q's device -> (P, 16) f32:
    col 0 the head scale, cols 1..nb 1/L1 of each int8 block (1 for an
    empty block). The sums are exact integers and the quotient a true f32
    division by a tensor (PyTorch on CUDA multiplies by the reciprocal of
    a Python number), so it equals the numpy helper bit for bit."""
    p = q.shape[0]
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    denom = (q[:, hp:].to(torch.int32).abs().reshape(p, nb, blk)
             .sum(dim=-1).to(torch.float32))
    one = torch.ones_like(denom)
    out = torch.zeros((p, 16), dtype=torch.float32, device=q.device)
    out[:, 0] = head_scale
    out[:, 1 : 1 + nb] = one / torch.where(denom > 0, denom, one)
    return out


def normalize_classify_q8i8_plain(
    q: torch.Tensor,           # (P, D) int8
    head_scale: torch.Tensor,  # (P,) f32
    qw_t: torch.Tensor,        # (R, D) int8, K-major
    sw: torch.Tensor,          # (R,) f32
    b: torch.Tensor,           # (R,) f32
    geom,
) -> torch.Tensor:
    """Plain version of K4 (``normalize_classify_q8i8_pallas``): -> (P, R)
    f32, K1's plain version fed ``q8_block_scales``. The kernel computes
    the same scales in-kernel from the same integer sums, so it must
    equal this bit for bit."""
    return normalize_classify_q8s_plain(
        q, q8_block_scales(q, head_scale, geom), qw_t, sw, b, geom)


def weights_bf16_t(w_dev) -> torch.Tensor:
    """K5's and K3 bf16's weight prep: device-layout weights (D, R) f32 or
    bf16 -> (R, D) bf16, K-major, rounded to nearest even as JAX's
    ``astype(jnp.bfloat16)``."""
    w = torch.as_tensor(w_dev).detach().to(torch.float32)
    return w.to(torch.bfloat16).T.contiguous()


def normalize_classify_q8_plain(
    q: torch.Tensor,           # (P, D) int8
    head_scale: torch.Tensor,  # (P,) f32
    w_bf16_t: torch.Tensor,    # (R, D) bf16, K-major (weights_bf16_t)
    b: torch.Tensor,           # (R,) f32
    geom,
) -> torch.Tensor:
    """Plain version of K5 (``normalize_classify_q8_pallas``): -> (P, R) f32

        (f32(head . w) * head_scale + f32(block_k . w) * inv_k ...) + b

    with inv from ``q8_block_scales``, folded in that order. Each segment
    is summed in float64, which is exact for int8 x bf16 unless the
    weights' magnitudes span more than about 2^30, then rounded to f32.
    The kernel sums each segment in f32 in another order, so it agrees
    with this within a tolerance of the summed terms, not bit for bit."""
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    qd = q.to(torch.float64)
    wd = w_bf16_t.to(torch.float64)

    def seg(lo, hi):
        return (qd[:, lo:hi] @ wd[:, lo:hi].T).to(torch.float32)

    inv = q8_block_scales(q, head_scale, geom)
    acc = seg(0, hp) * head_scale[:, None]
    for k in range(nb):
        lo = hp + k * blk
        acc = acc + seg(lo, lo + blk) * inv[:, k + 1 : k + 2]
    return acc + b


def normalize_classify_q8t_plain(
    xt: torch.Tensor,        # (D, P) int8, transposed rows
    scales_t: torch.Tensor,  # (16, P) f32, precompute_q8_scales transposed
    qw_t: torch.Tensor,      # (R, D) int8, K-major
    sw: torch.Tensor,        # (R,) f32
    b: torch.Tensor,         # (R,) f32
    geom,
) -> torch.Tensor:
    """Plain version of K6 (``normalize_classify_q8t_pallas``): -> (R, P)
    f32, K1's arithmetic on the transposed operands. The segment sums are
    exact in float64 and every f32 step is K1's, so this equals the plain
    K1 transposed bit for bit, and the kernel must equal this."""
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    xd = xt.to(torch.float64)
    wd = qw_t.to(torch.float64)

    def seg(lo, hi):
        return (wd[:, lo:hi] @ xd[lo:hi]).to(torch.float32)

    acc = seg(0, hp) * scales_t[0:1]
    for k in range(nb):
        lo = hp + k * blk
        acc = acc + seg(lo, lo + blk) * scales_t[k + 1 : k + 2]
    return acc * sw[:, None] + b[:, None]


def _probe_rows(r: int, mode: str) -> int:
    if mode not in PROBE_MODES:
        raise ValueError(f"pair_probe: mode {mode!r} is not one of {PROBE_MODES}")
    return min(r, PROBE_STREAM_ROWS) if mode == "stream" else r


def pair_probe_plain(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of the probe of ``tools/bench_pair_kernels.py``: x (D,
    P) int8, w (R, D) int8 -> (R, P) int32, the exact product (summed in
    float64, exact: |sum| <= 128^2 * D < 2^31). ``stream`` computes
    rows r < 32 and leaves the rest zero; ``onedot`` and
    ``blocks_noscale`` (one dot, or the sum of its segment dots) give the
    same integers, the full product."""
    live = _probe_rows(w.shape[0], mode)
    out = torch.zeros((w.shape[0], x.shape[1]), dtype=torch.int32, device=x.device)
    out[:live] = (w[:live].to(torch.float64) @ x.to(torch.float64)).to(torch.int32)
    return out


class ProbePlan(NamedTuple):
    """How ``csrc/pair_probe.cu`` runs one call (``probe_plan``)."""
    live: int        # output rows computed (the rest are zero)
    n: int           # rows per tile (wgmma N)
    tiles: int       # pair tiles x row blocks
    chunks: int      # 128-byte chunks of D (the last zero-padded)
    split: int       # D shares per tile, summed by atomics when > 1
    staging: str     # how x reaches shared memory: "tma", "word" or "shift"
    grid: int        # persistent blocks

    def shares(self) -> list:
        """The chunk range [lo, hi) of each D share, as the kernel cuts them."""
        return [(k * self.chunks // self.split, (k + 1) * self.chunks // self.split)
                for k in range(self.split)]


def probe_plan(p: int, r: int, d: int, mode: str, sms: int) -> ProbePlan:
    """The probe kernel's plan for x (D, P), w (R, D) on a card of ``sms``
    SMs: ``stream`` runs 32-row tiles, the others 160; TMA stages x when
    its rows are a multiple of 16 bytes apart, else the kernel's own
    aligned 4-byte loads (shifted when P % 4 != 0); with fewer tiles than
    SMs, D is split in whole chunks so that the tiles' shares come near
    the SM count."""
    live = _probe_rows(r, mode)
    n = PROBE_STREAM_ROWS if mode == "stream" else PROBE_N
    tiles = -(-p // PROBE_TILE_PAIRS) * -(-live // n)
    chunks = -(-d // PROBE_CHUNK)
    split = max(1, min(chunks, sms // tiles))
    staging = "tma" if p % 16 == 0 else "word" if p % 4 == 0 else "shift"
    return ProbePlan(live, n, tiles, chunks, split, staging, min(tiles * split, sms))


def _q8i8_cuda(q, head_scale, qw_t, sw, b, geom) -> torch.Tensor:
    p, d = q.shape
    r = qw_t.shape[0]
    f32, i8 = torch.float32, torch.int8
    _require("q8i8", (q, head_scale, qw_t, sw, b), (i8, f32, i8, f32, f32),
             ((p, d), (p,), (r, d), (r,), (r,)), aligned=(q, qw_t))
    _require_geom("q8i8", geom, d)
    out = torch.empty((p, r), dtype=f32, device=q.device)
    if p and r:
        _launch("q8i8", "q8i8_library", "tspn_q8i8_launch", q.device, (
            q.data_ptr(), head_scale.data_ptr(), qw_t.data_ptr(), sw.data_ptr(),
            b.data_ptr(), out.data_ptr(), p, r, d, geom.dev_head_pad, geom.dev_block))
    return out


def _q8_bf16_cuda(q, head_scale, w_bf16_t, b, geom) -> torch.Tensor:
    p, d = q.shape
    r = w_bf16_t.shape[0]
    f32 = torch.float32
    _require("q8bf", (q, head_scale, w_bf16_t, b), (torch.int8, f32, torch.bfloat16, f32),
             ((p, d), (p,), (r, d), (r,)), aligned=(q, w_bf16_t))
    _require_geom("q8bf", geom, d)
    out = torch.empty((p, r), dtype=f32, device=q.device)
    if p and r:
        _launch("q8bf", "q8_bf16_library", "tspn_q8_bf16_launch", q.device, (
            q.data_ptr(), head_scale.data_ptr(), w_bf16_t.data_ptr(), b.data_ptr(),
            out.data_ptr(), p, r, d, geom.dev_head_pad, geom.dev_block))
    return out


def _q8t_cuda(xt, scales_t, qw_t, sw, b, geom) -> torch.Tensor:
    return _q8s_sm90("q8t", xt, scales_t, qw_t, sw, b, geom, transposed=True)


def _pair_probe_cuda(x, w, mode) -> torch.Tensor:
    d, p = x.shape
    r = w.shape[0]
    _probe_rows(r, mode)
    _require("q8_probe", (x, w), (torch.int8, torch.int8), ((d, p), (r, d)),
             aligned=(x, w))
    if d % 64 or d >= 1 << 17:
        raise ValueError(f"q8_probe: width {d} is not a multiple of 64 below 2^17")
    if not (p and r):
        return torch.zeros((r, p), dtype=torch.int32, device=x.device)
    plan = probe_plan(p, r, d, mode, torch.cuda.get_device_properties(x.device).multi_processor_count)
    # split shares add into a zeroed output
    out = (torch.zeros if plan.split > 1 else torch.empty)((r, p), dtype=torch.int32,
                                                             device=x.device)
    _launch("q8_probe", "pair_probe_library", "tspn_pair_probe_launch", x.device,
            (x.data_ptr(), w.data_ptr(), out.data_ptr(), p, r, d, plan.live, plan.n,
             plan.split, int(plan.staging != "tma"), plan.grid))
    return out


def normalize_classify_q8i8(q, head_scale, qw_t, sw, b, geom) -> torch.Tensor:
    """K4, int8 x int8 with in-kernel block scales, (P, D) -> (P, R) f32:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8i8", q, _q8i8_cuda, normalize_classify_q8i8_plain,
                     q, head_scale, qw_t, sw, b, geom)


def normalize_classify_q8(q, head_scale, w_bf16_t, b, geom) -> torch.Tensor:
    """K5, int8 x bf16 with in-kernel block scales, (P, D) -> (P, R) f32:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8bf", q, _q8_bf16_cuda, normalize_classify_q8_plain,
                     q, head_scale, w_bf16_t, b, geom)


def normalize_classify_q8t(xt, scales_t, qw_t, sw, b, geom) -> torch.Tensor:
    """K6, K1 on transposed operands, (D, P) -> (R, P) f32: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8t", xt, _q8t_cuda, normalize_classify_q8t_plain,
                     xt, scales_t, qw_t, sw, b, geom)


def pair_probe(x, w, mode: str) -> torch.Tensor:
    """The raw int8 probe, x (D, P) and w (R, D) -> (R, P) int32: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8_probe", x, _pair_probe_cuda, pair_probe_plain, x, w, mode)


def factored_classify_q8_batched(
    trk_q: torch.Tensor,       # (B, N, trk_dim) int8
    trk_scales: torch.Tensor,  # (B, N, 16) f32
    rel_q: torch.Tensor,       # (B, P, rel_pad) int8
    rel_scales: torch.Tensor,  # (B, P, 16) f32
    pairs: torch.Tensor,       # (B, P, 2) int, tracklet index per rel row
    wq: dict,                  # qw_trk_t, sw_trk, qw_rel_t, sw_rel tensors
    b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT,
) -> torch.Tensor:
    """Two-pass factored scoring of padded segment batches -> (B, P, R)
    f32: ``(y + A_sub[sub]) + A_obj[obj]`` with A = the q8s tracklet pass
    (B, N, 2R) and y = the q8s rel pass plus bias, the JAX package's
    ``factored_classify_q8_batched``. The serve path runs
    ``factored_classify_q8_fused`` instead; this stays as its reference.
    The JAX package expands A with a one-hot matmul (TPU row gathers
    scalarize); here it is an index gather, which is exactly equal. Pair
    indices must lie in [0, N)."""
    bsz, n, _ = trk_q.shape
    p = rel_q.shape[1]
    r = b.shape[0]
    a = normalize_classify_q8s(
        trk_q.reshape(bsz * n, -1), trk_scales.reshape(bsz * n, -1),
        wq["qw_trk_t"], wq["sw_trk"], torch.zeros_like(wq["sw_trk"]),
        tracklet_geom(layout),
    ).reshape(bsz, n, 2 * r)
    y = normalize_classify_q8s(
        rel_q.reshape(bsz * p, -1), rel_scales.reshape(bsz * p, -1),
        wq["qw_rel_t"], wq["sw_rel"], b, rel_geom(layout),
    ).reshape(bsz, p, r)
    sub = pairs[..., 0].long().unsqueeze(-1).expand(bsz, p, r)
    obj = pairs[..., 1].long().unsqueeze(-1).expand(bsz, p, r)
    return (
        y
        + torch.gather(a[..., :r], 1, sub)
        + torch.gather(a[..., r:], 1, obj)
    )


def factored_classify_q8_fused_plain(
    rel_q: torch.Tensor,     # (B, P, D) int8 rel rows
    s: torch.Tensor,         # (B, P) f32 row scale (column 0 of the scales)
    pairs: torch.Tensor,     # (B, P, 2) int, tracklet index per rel row
    qw_rel_t: torch.Tensor,  # (R, D) int8, K-major
    sw: torch.Tensor,        # (R,) f32
    b: torch.Tensor,         # (R,) f32
    a: torch.Tensor,         # (B, N, 2R) f32 tracklet pass [A_sub | A_obj]
) -> torch.Tensor:
    """Plain version of the q8f_fused kernel: -> (B, P, R) f32

        ((f32(rel_q . qw) * s) * sw + b) + (A[sub, :R] + A[obj, R:])

    rounded in that order, the kernel's. The integer sum is taken in
    float64, which is exact (|sum| <= 127^2 * D < 2^53), then rounded to
    f32, so the kernel must equal this bit for bit. A pair index outside
    [0, N) adds 0 and is never read."""
    bsz, p, d = rel_q.shape
    n, r = a.shape[1], b.shape[0]
    acc = (rel_q.reshape(bsz * p, d).to(torch.float64)
           @ qw_rel_t.to(torch.float64).T).to(torch.float32).reshape(bsz, p, r)
    y = acc * s[..., None] * sw + b

    def gather(idx, table):  # (B, P) indices into (B, N, R) -> (B, P, R)
        idx = idx.long()
        inside = (idx >= 0) & (idx < n)
        rows = torch.gather(
            table, 1, torch.where(inside, idx, 0)[..., None].expand(bsz, p, r)
        )
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return y + (gather(pairs[..., 0], a[..., :r]) + gather(pairs[..., 1], a[..., r:]))


def _q8f_fused_cuda(rel_q, s, pairs, qw_rel_t, sw, b, a) -> torch.Tensor:
    bsz, p, d = rel_q.shape
    r = qw_rel_t.shape[0]
    n = a.shape[1]
    f32, i8 = torch.float32, torch.int8
    _require("q8f_fused", (rel_q, s, pairs, qw_rel_t, sw, b, a),
             (i8, f32, torch.int32, i8, f32, f32, f32),
             ((bsz, p, d), (bsz, p), (bsz, p, 2), (r, d), (r,), (r,), (bsz, n, 2 * r)),
             aligned=(rel_q, qw_rel_t))
    if d % 128:
        raise ValueError(f"q8f_fused: width {d} is not a multiple of 128")
    out = torch.empty((bsz, p, r), dtype=f32, device=rel_q.device)
    if bsz * p:
        _launch("q8f_fused", "q8f_fused_library", "tspn_q8f_fused_launch", rel_q.device, (
            rel_q.data_ptr(), s.data_ptr(), pairs.data_ptr(), qw_rel_t.data_ptr(),
            sw.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(), bsz * p, p, n, r, d))
    return out


def q8f_fused(rel_q, s, pairs, qw_rel_t, sw, b, a) -> torch.Tensor:
    """Factored rel pass with the A-table add, (B, P, D) int8 -> (B, P, R)
    f32: the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    return _dispatch("q8f_fused", rel_q, _q8f_fused_cuda, factored_classify_q8_fused_plain,
                     rel_q, s, pairs, qw_rel_t, sw, b, a)


def factored_classify_q8_fused(
    trk_q: torch.Tensor,       # (B, N, trk_dim) int8
    trk_scales: torch.Tensor,  # (B, N, 16) f32
    rel_q: torch.Tensor,       # (B, P, rel_pad) int8
    rel_scales: torch.Tensor,  # (B, P, 16) f32
    pairs: torch.Tensor,       # (B, P, 2) int32, arbitrary pair indices
    wq: dict,                  # qw_trk_t, sw_trk, qw_rel_t, sw_rel tensors
    b: torch.Tensor,
    layout: FeatureLayout = DEFAULT_LAYOUT,
    plain: bool = False,
) -> torch.Tensor:
    """Factored scoring of padded segment batches -> (B, P, R) f32, the
    math of ``factored_classify_q8_batched`` in two launches: the q8s
    tracklet pass gives the A table (B, N, 2R), then one q8f_fused launch
    scores the rel rows and adds A_sub[sub] + A_obj[obj] in its epilogue,
    so the (P, R) rel logits never round-trip through device memory.
    ``plain=True`` runs both passes' plain versions on any device."""
    bsz, n, _ = trk_q.shape
    r = b.shape[0]
    q8s = normalize_classify_q8s_plain if plain else normalize_classify_q8s
    a = q8s(
        trk_q.reshape(bsz * n, -1), trk_scales.reshape(bsz * n, -1),
        wq["qw_trk_t"], wq["sw_trk"], torch.zeros_like(wq["sw_trk"]),
        tracklet_geom(layout),
    ).reshape(bsz, n, 2 * r)
    rel = factored_classify_q8_fused_plain if plain else q8f_fused
    return rel(rel_q, rel_scales[..., 0].contiguous(), pairs, wq["qw_rel_t"],
               wq["sw_rel"], b, a)
