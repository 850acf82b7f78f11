"""The plan of K1's and K6's wgmma kernel (csrc/q8s_sm90.cu), plain Python.

``ops/pairwise.py::q8s_plan`` cuts a call's work: a tile (128 rows x 144
outputs) is one work item that folds its segments in registers, or, with
fewer tiles than SMs where its cost model says the split pays, its work
is cut into pieces of whole 128-byte chunks, one work item each, folded
by a second kernel. The
kernel refuses a piece table that does not cover each segment once, in
order; these tests hold the planner to that at every geometry the port
runs K1 and K6 at, and the kernel's arithmetic is held to the plain
versions on the card (tests/test_torch_q8s_gpu.py).
"""

import pytest

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.ops import pairwise as pw

SMS = 132  # an H100 SXM
EXPANDED = pw.BlockGeom(3072, 8, 1024)
# (name, rows P, outputs R, geometry): the serve path's three, the
# pair-kernel bench's, its ragged count, a VidOR segment's pairs, and the
# serve loop's batches (16 segments of 32 tracklets, q8f and PPN-pruned)
GEOMETRIES = (
    ("tracklet", 3065, 264, pw.tracklet_geom()),
    ("rel", 95203, 132, pw.rel_geom()),
    ("expanded", 4083, 132, EXPANDED),
    ("tool", 95232, 132, EXPANDED),
    ("ragged", 95155, 132, EXPANDED),
    ("vidor", 333, 132, FeatureLayout.for_objects(80)),
    ("serve_tracklets", 16 * 32, 264, pw.tracklet_geom()),
    ("serve_rel", 16 * 992, 132, pw.rel_geom()),
    ("pruned", 16 * 256, 132, EXPANDED),
    ("one_row", 1, 132, EXPANDED),
)


def _plan(p, r, geom, transposed=False):
    return pw.q8s_plan(p, r, geom.device_dim, geom, SMS, transposed)


@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K6"])
@pytest.mark.parametrize("name,p,r,geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_q8s_plan_covers_each_segment_once(name, p, r, geom, transposed):
    plan = _plan(p, r, geom, transposed)
    hp, nb, blk = geom.dev_head_pad, geom.num_bow_blocks, geom.dev_block
    assert plan.segments == ((0, hp),) + tuple(
        (hp + k * blk, hp + (k + 1) * blk) for k in range(nb))
    assert plan.tiles == -(-p // pw.Q8S_TILE_ROWS) * -(-r // pw.Q8S_N)
    # the pieces of a tile: segments in fold order, each cut into
    # consecutive chunk ranges that cover it exactly once
    assert [k for k, _lo, _hi in plan.pieces] == sorted(k for k, _lo, _hi in plan.pieces)
    for k, (lo, hi) in enumerate(plan.segments):
        ranges = [(a, b) for seg, a, b in plan.pieces if seg == k]
        assert ranges and ranges[0][0] == 0 and ranges[-1][1] == -(-(hi - lo) // pw.Q8S_CHUNK)
        assert all(a < b for a, b in ranges)
        assert all(b == a2 for (_a, b), (a2, _b) in zip(ranges, ranges[1:]))
    assert len(plan.pieces) <= pw.Q8S_MAX_PIECES
    if not plan.split:  # a tile folds the whole segments in registers
        assert len(plan.pieces) == len(plan.segments)
    # a split only where the tiles do not fill the card
    if plan.split:
        assert plan.tiles < SMS
    assert plan.grid == min(plan.items, SMS)


@pytest.mark.parametrize("p,staging", [(95232, "tma"), (4096, "tma"), (95204, "word"),
                                       (333, "shift"), (95155, "shift")])
def test_q8s_plan_staging_follows_p(p, staging):
    assert _plan(p, 132, EXPANDED, transposed=True).staging == staging
    assert _plan(p, 132, EXPANDED).staging == "tma"  # K1's rows: always TMA


def test_q8s_plan_splits_where_it_pays():
    """The split's sums cross L2 twice, and the fold kernel is one launch
    more: K1, whose rows come by TMA, splits only where the tiles leave
    nearly every SM idle (VidOR, one row, the serve loop's tracklet
    batches); K6 staging its rows by loads (P % 16 != 0) takes about six
    times as long a chunk and splits at the tracklet and expanded
    geometries too. Neither splits with the card full."""
    for transposed, splits in (
            (False, {"vidor", "serve_tracklets", "one_row"}),
            (True, {"tracklet", "expanded", "vidor", "serve_tracklets", "one_row"})):
        got = {name for name, p, r, geom in GEOMETRIES if _plan(p, r, geom, transposed).split}
        assert got == splits


@pytest.mark.parametrize("transposed", [False, True], ids=["K1", "K6"])
def test_q8s_plan_takes_the_cheapest_cut(transposed):
    """Of the cuts offered, the plan is the one the cost model times
    lowest; cuts run from whole segments down to one-chunk pieces, each
    covering every segment."""
    lo = FeatureLayout.for_objects(80)
    p, r = 333, 132
    plan = _plan(p, r, lo, transposed)
    chunks = [-(-(hi - a) // pw.Q8S_CHUNK) for a, hi in plan.segments]
    cuts = list(pw._q8s_cuts(chunks))
    assert cuts[0][1] == tuple((k, 0, c) for k, c in enumerate(chunks))
    assert all(len(cut) <= pw.Q8S_MAX_PIECES for _size, cut in cuts)
    chunk_us = pw.Q8S_CHUNK_US["tma" if plan.staging == "tma" else "loads"]

    def us(size, cut):
        return (chunk_us * -(-plan.tiles * len(cut) // SMS) * size + pw.Q8S_FOLD_US
                + pw.Q8S_WS_US_PER_MB * 2 * len(cut) * p * r * 4 / 1e6)

    assert plan.split and plan.pieces == min(cuts, key=lambda c: us(*c))[1]
