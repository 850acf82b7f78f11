"""How K3's f32 kernel and K7's forward cut a call, plain Python.

* ``ops/pairwise.py::fused_plan`` plans csrc/fused_classify.cu: a tile
  (128 rows x 136 outputs) runs all fold units (the head in shares of at
  most 1024 columns, then each BoW block) in one block, or, with fewer
  tiles than SMs where its cost model says the split pays, the units are
  cut into contiguous pieces, one block a (tile, piece), folded by a
  second kernel. The kernel refuses a unit table that does not cover D's
  32-column chunks once, in order, with pieces numbered in order; these
  tests hold the planner to that at the geometries the port runs K3 at.
  The kernel's arithmetic is held to the plain version on the card
  (tests/test_torch_fused_classify_gpu.py).
* ``ops/roi_align.py::_vec`` picks K7's channels a thread: 16-byte
  accesses (8 bf16 or 4 f32 channels) where C and every tensor's base
  allow them, else 4, else 1; the backward takes 4 or 1.
"""

import itertools

import pytest
import torch

from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.ops import pairwise as pw
from tspn_tpu_torch.ops import roi_align as ra

SMS = 132  # an H100 SXM
VIDVRD, VIDOR = FeatureLayout(), FeatureLayout.for_objects(80)
# (name, rows P, outputs R, layout): the training step (8 x 992 pairs), a
# ragged one, the fused serve batch (16 x 992), the serve loop's smaller
# buckets, a VidOR segment, one row, and R past one column tile
GEOMETRIES = (
    ("train", 7936, 132, VIDVRD),
    ("train_ragged", 7923, 132, VIDVRD),
    ("serve", 16 * 992, 132, VIDVRD),
    ("bucket8", 16 * 56, 132, VIDVRD),
    ("bucket16", 16 * 240, 132, VIDVRD),
    ("vidor", 333, 132, VIDOR),
    ("one_row", 1, 132, VIDVRD),
    ("r12", 129, 12, VIDVRD),
    ("r300", 130, 300, VIDOR),
    ("many_tiles", 40000, 132, VIDVRD),
)


@pytest.mark.parametrize("layout", [VIDVRD, VIDOR], ids=["vidvrd", "vidor"])
def test_fused_units_cover_d_once(layout):
    units = pw.fused_units(layout)
    hp, blk = layout.dev_head_pad, layout.dev_block
    chunk = pw.FUSED_CHUNK
    assert units[0][0] == 0 and units[-1][1] * chunk == layout.device_dim
    assert all(a[1] == b[0] for a, b in zip(units, units[1:]))
    head = [u for u in units if not u[2]]
    assert head[-1][1] * chunk == hp
    assert all(0 < (hi - lo) * chunk <= pw.FUSED_HEAD_SHARE for lo, hi, _s in head)
    blocks = [u for u in units if u[2]]
    assert [(lo * chunk, hi * chunk) for lo, hi, _s in blocks] == [
        (hp + k * blk, hp + (k + 1) * blk) for k in range(layout.num_bow_blocks)]
    assert len(units) <= pw.FUSED_MAX_UNITS


@pytest.mark.parametrize("name,p,r,layout", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_fused_plan_covers_each_unit_once(name, p, r, layout):
    plan = pw.fused_plan(p, r, layout, SMS)
    assert plan.units == pw.fused_units(layout)
    assert plan.tiles == -(-p // pw.FUSED_TILE_ROWS) * -(-r // pw.FUSED_N)
    assert plan.pieces[0][0] == 0 and plan.pieces[-1][1] == len(plan.units)
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(plan.pieces, plan.pieces[1:]))
    if plan.tiles >= SMS:
        assert not plan.split
    # the table the kernel takes: chunks in order, pieces numbered in order
    table = plan.table()
    assert [t[:3] for t in table] == list(plan.units)
    assert table[0][3] == 0
    assert all(b[3] in (a[3], a[3] + 1) for a, b in zip(table, table[1:]))
    assert table[-1][3] == len(plan.pieces) - 1


def test_fused_plan_fills_the_card():
    """The training step's 62 tiles take two pieces (124 blocks on 132
    SMs); the serve batch's 124 tiles stay whole; a bucket-8 batch (7
    tiles) takes one piece a unit."""
    assert len(pw.fused_plan(7936, 132, VIDVRD, SMS).pieces) == 2
    assert not pw.fused_plan(16 * 992, 132, VIDVRD, SMS).split
    small = pw.fused_plan(16 * 56, 132, VIDVRD, SMS)
    assert len(small.pieces) == len(small.units)


@pytest.mark.parametrize("lengths,n", [([3, 1, 4, 1, 5, 9, 2, 6], 3), ([32] * 11, 2),
                                        ([25] * 4 + [32] * 8, 4), ([7], 1)])
def test_partitions_least_largest_piece(lengths, n):
    cut = pw._partitions(lengths, n)
    assert len(cut) == n and cut[0][0] == 0 and cut[-1][1] == len(lengths)
    assert all(a[1] == b[0] for a, b in zip(cut, cut[1:]))
    best = min(max(sum(lengths[a:b]) for a, b in zip((0,) + c, c + (len(lengths),)))
               for c in itertools.combinations(range(1, len(lengths)), n - 1))
    assert max(sum(lengths[a:b]) for a, b in cut) == best


@pytest.mark.parametrize("tiles,sizes,sms,want", [(62, [352], 132, 352),
                                                  (62, [192, 160], 132, 192),
                                                  (10, [5], 4, 15), (3, [4, 2], 2, 10)])
def test_makespan(tiles, sizes, sms, want):
    assert pw._makespan(tiles, sizes, sms) == want


def _at(dtype, c, offset_elems=0):
    """A (2, 3, 3, C) map whose base lies ``offset_elems`` past an
    allocation's start."""
    t = torch.zeros(2 * 9 * c + offset_elems, dtype=dtype)[offset_elems:]
    return t.view(2, 3, 3, c)


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.bfloat16, 1024, 0, 8), (torch.bfloat16, 8, 0, 8), (torch.bfloat16, 12, 0, 4),
    (torch.bfloat16, 6, 0, 1), (torch.bfloat16, 1024, 4, 4), (torch.bfloat16, 1024, 1, 1),
    (torch.float32, 1024, 0, 4), (torch.float32, 12, 0, 4), (torch.float32, 6, 0, 1),
    (torch.float32, 1024, 1, 1)])
def test_vec_picks_the_widest_access(dtype, c, offset, want):
    feats = _at(dtype, c, offset)
    assert ra._vec(c, feats, widest=16 // feats.element_size()) == want


def test_backward_vec_stays_at_four():
    grad, dfeat = _at(torch.bfloat16, 1024), _at(torch.float32, 1024)
    assert ra._vec(1024, grad, dfeat) == 4
