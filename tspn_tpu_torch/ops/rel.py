"""The rel-pass probe products: (P, D) feature rows x K-major weights on the
int8 tensor cores, the kernels of the ported ``tools/bench_rel_*`` tools.

Three dispatchers front one kernel template (``csrc/rel.cu``): on a CUDA
tensor they launch it (or raise), on a CPU tensor they run its plain
version, which is also its oracle.

* ``rel_s8`` (Kr): int8 rows (P, D) x int8 weights (R, D) with one of
  three epilogues, ``int32`` (the exact product), ``f32`` (``f32(acc) *
  sw + b``) or ``side`` (``(f32(acc) * s[:, 0]) * sw + b``, with s a (P,
  16) or (P, 128) f32 sidecar, K1's rel math), a ring of 2, 3 or 4
  stages, the ``grid`` or ``persistent`` schedule and a split of K across
  ``ks`` = 1, 2 or 4 blocks. Kn and Ks4 run a 2-stage ring on the row
  grid.
* ``rel_s4x8`` (Kn): int4 rows packed two to a byte (``pack_int4``) x the
  even and odd columns of int8 weights (``split_even_odd``) -> int32.
* ``rel_s4x4`` (Ks4): packed int4 rows x packed int4 weights -> int32.

The plain versions sum the products in float64, which is exact (|sum| <=
128 * 127 * D < 2^53), cast to int32, and fold the f32 epilogues in the
kernel's order; so every kernel equals its plain version bit for bit, and
``rel_s8(..., epilogue="side")`` equals
``pairwise.normalize_classify_q8s_plain`` at ``rel_geom``.

``LAUNCHES`` is this module's own: the keys of ``pairwise.LAUNCHES`` are
pinned by its tests.
"""

from __future__ import annotations

import torch

from tspn_tpu_torch.ops.pairwise import _dispatch, _launch, _require

# kernel launches made by the dispatchers on CUDA tensors
LAUNCHES = {"rel_s8": 0, "rel_s4x8": 0, "rel_s4x4": 0}
EPILOGUES = ("int32", "f32", "side")
SCHEDULES = ("grid", "persistent")
SPLITS = (1, 2, 4)
CHUNK = 128  # bytes of a row per ring stage: rows are a multiple of CHUNK * ks
TILE_ROWS, TILE_COLS = 128, 144  # the kernel's output tile
# Kr's ring depths; the default, 2, lets it run two blocks per SM
STAGES = (2, 3, 4)
_MODE = {"rel_s8": 0, "rel_s4x8": 1, "rel_s4x4": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ int4 helpers
def wrap_int4(w: torch.Tensor) -> torch.Tensor:
    """Integers -> int8 in [-8, 7] by two's-complement truncation,
    ((w + 8) mod 16) - 8: what ``astype(jnp.int4)`` does."""
    return ((w.to(torch.int32) + 8) % 16 - 8).to(torch.int8)


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """(..., D) int8 in [-8, 7] -> (..., D / 2) int8, column 2j in the low
    nibble and 2j + 1 in the high (the byte order of a ``jnp.int4``
    array)."""
    if x.shape[-1] % 2:
        raise ValueError(f"pack_int4: odd width {x.shape[-1]}")
    if x.numel() and (x.min() < -8 or x.max() > 7):
        raise ValueError("pack_int4: values outside [-8, 7]")
    lo, hi = x[..., 0::2].to(torch.int32), x[..., 1::2].to(torch.int32)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8).contiguous()


def unpack_int4(xp: torch.Tensor) -> tuple:
    """Packed (..., D / 2) int8 -> (low, high) nibbles, each sign-extended
    to int8: the even and the odd columns."""
    v = xp.to(torch.int32)
    return (((v & 0xF) ^ 8) - 8).to(torch.int8), (v >> 4).to(torch.int8)


def split_even_odd(w_t: torch.Tensor) -> tuple:
    """K-major (R, D) weights -> (W_even, W_odd), each (R, D / 2)."""
    return w_t[:, 0::2].contiguous(), w_t[:, 1::2].contiguous()


# --------------------------------------------------------- plain versions
def _exact(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (P, K) @ b_t (R, K)^T summed in float64: exact for int8 operands
    at K < 2^38 / 127^2."""
    return a.to(torch.float64) @ b_t.to(torch.float64).T


def rel_s8_plain(x, w_t, s=None, sw=None, b=None, epilogue: str = "int32") -> torch.Tensor:
    """Plain version of Kr: x (P, D) int8, w_t (R, D) int8 -> (P, R), int32
    for ``int32``, else f32 folded as the kernel folds it."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"rel_s8: epilogue {epilogue!r} is not one of {EPILOGUES}")
    acc = _exact(x, w_t)
    if epilogue == "int32":
        return acc.to(torch.int32)
    y = acc.to(torch.float32)
    if epilogue == "side":
        y = y * s[:, 0:1]
    return y * sw + b


def rel_s4x8_plain(xp, w_even, w_odd) -> torch.Tensor:
    """Plain version of Kn: packed int4 xp (P, D / 2), W_even and W_odd
    (R, D / 2) int8 -> (P, R) int32, lo @ W_even + hi @ W_odd."""
    lo, hi = unpack_int4(xp)
    return (_exact(lo, w_even) + _exact(hi, w_odd)).to(torch.int32)


def rel_s4x4_plain(xp, wp) -> torch.Tensor:
    """Plain version of Ks4: packed int4 xp (P, D / 2) and wp (R, D / 2)
    -> (P, R) int32."""
    lo, hi = unpack_int4(xp)
    w_lo, w_hi = unpack_int4(wp)
    return (_exact(lo, w_lo) + _exact(hi, w_hi)).to(torch.int32)


# ------------------------------------------------------------------ kernels
def _rel_cuda(name: str, x, w0, w1, s, sw, b, epilogue: str, stages: int,
              schedule: str, ks: int) -> torch.Tensor:
    """Launch ``csrc/rel.cu`` for ``name`` on the current stream of x's
    device; the operands are checked by the caller."""
    p, kb = x.shape
    r = w0.shape[0]
    if kb % (CHUNK * ks):
        raise ValueError(f"{name}: row of {kb} bytes is not a multiple of {CHUNK} x ks {ks}")
    dt = torch.int32 if epilogue == "int32" else torch.float32
    out = torch.empty((p, r), dtype=dt, device=x.device)
    if not (p and r):
        return out
    if ks > 1:
        ws = torch.empty((ks, p, r), dtype=torch.int32, device=x.device)
        tiles = -(-p // TILE_ROWS) * -(-r // TILE_COLS)
        counters = torch.zeros((tiles,), dtype=torch.int32, device=x.device)
    else:
        ws = counters = out
    ptr = lambda t: t.data_ptr() if t is not None else 0  # noqa: E731
    _launch(name, "rel_library", "tspn_rel_launch", x.device, (
        ptr(x), ptr(w0), ptr(w1), ptr(s), ptr(sw), ptr(b), out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), _MODE[name], EPILOGUES.index(epilogue), stages,
        int(schedule == "persistent"), ks, p, r, kb, s.shape[1] if s is not None else 0),
        counts=LAUNCHES)
    return out


def _rel_s8_cuda(x, w_t, s, sw, b, epilogue, stages, schedule, ks) -> torch.Tensor:
    p, d = x.shape
    r = w_t.shape[0]
    f32, i8 = torch.float32, torch.int8
    if epilogue == "int32":
        _require("rel_s8", (x, w_t), (i8, i8), ((p, d), (r, d)), aligned=(x, w_t))
        s = sw = b = None
    elif epilogue == "f32":
        _require("rel_s8", (x, w_t, sw, b), (i8, i8, f32, f32),
                 ((p, d), (r, d), (r,), (r,)), aligned=(x, w_t))
        s = None
    else:
        if s.dim() != 2 or s.shape[1] < 1:
            raise ValueError(f"rel_s8: sidecar of shape {tuple(s.shape)}, want (P, W >= 1)")
        _require("rel_s8", (x, s, w_t, sw, b), (i8, f32, i8, f32, f32),
                 ((p, d), (p, s.shape[1]), (r, d), (r,), (r,)), aligned=(x, w_t))
    return _rel_cuda("rel_s8", x, w_t, None, s, sw, b, epilogue, stages, schedule, ks)


def rel_s8(x, w_t, s=None, sw=None, b=None, *, epilogue: str = "int32",
           stages: int = 2, schedule: str = "grid", ks: int = 1) -> torch.Tensor:
    """Kr: x (P, D) int8 @ w_t (R, D) int8 -> (P, R) int32, or f32 through
    the ``f32`` or ``side`` epilogue (s: (P, W) f32 sidecar, column 0 the
    row scale; sw, b: (R,) f32). ``stages``, ``schedule`` and ``ks`` choose
    the kernel's ring depth, block schedule and K split; every choice gives
    the same bits. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"rel_s8: epilogue {epilogue!r} is not one of {EPILOGUES}")
    if epilogue != "int32" and (sw is None or b is None or (epilogue == "side" and s is None)):
        raise ValueError(f"rel_s8: the {epilogue} epilogue needs sw, b"
                         + (" and the sidecar s" if epilogue == "side" else ""))
    if stages not in STAGES:
        raise ValueError(f"rel_s8: stages {stages} is not one of {STAGES}")
    if schedule not in SCHEDULES:
        raise ValueError(f"rel_s8: schedule {schedule!r} is not one of {SCHEDULES}")
    if ks not in SPLITS:
        raise ValueError(f"rel_s8: ks {ks} is not one of {SPLITS}")
    return _dispatch("rel_s8", x, _rel_s8_cuda,
                     lambda *a: rel_s8_plain(*a[:5], epilogue=epilogue),
                     x, w_t, s, sw, b, epilogue, stages, schedule, ks)


def _rel_s4x8_cuda(xp, w_even, w_odd) -> torch.Tensor:
    p, kb = xp.shape
    r = w_even.shape[0]
    i8 = torch.int8
    _require("rel_s4x8", (xp, w_even, w_odd), (i8, i8, i8), ((p, kb), (r, kb), (r, kb)),
             aligned=(xp, w_even, w_odd))
    return _rel_cuda("rel_s4x8", xp, w_even, w_odd, None, None, None, "int32", 2, "grid", 1)


def rel_s4x8(xp, w_even, w_odd) -> torch.Tensor:
    """Kn: packed int4 xp (P, D / 2) x int8 W_even, W_odd (R, D / 2) ->
    (P, R) int32. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    return _dispatch("rel_s4x8", xp, _rel_s4x8_cuda, rel_s4x8_plain, xp, w_even, w_odd)


def _rel_s4x4_cuda(xp, wp) -> torch.Tensor:
    p, kb = xp.shape
    r = wp.shape[0]
    _require("rel_s4x4", (xp, wp), (torch.int8, torch.int8), ((p, kb), (r, kb)),
             aligned=(xp, wp))
    return _rel_cuda("rel_s4x4", xp, wp, None, None, None, None, "int32", 2, "grid", 1)


def rel_s4x4(xp, wp) -> torch.Tensor:
    """Ks4: packed int4 xp (P, D / 2) x packed int4 wp (R, D / 2) -> (P, R)
    int32. The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    return _dispatch("rel_s4x4", xp, _rel_s4x4_cuda, rel_s4x4_plain, xp, wp)
