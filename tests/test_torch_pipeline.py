"""The port's pipelined serve loop and prefetching loader, held against the
JAX package.

* predict_segments at pipeline_depth 0, 1 and 2 gives bit-identical
  results on the golden fixture (the port's counterpart of
  tests/test_golden_h5.py::test_predict_pipeline_depth_parity), and the
  same selections as the JAX predict_segments there.
* batch_hook runs once on each dispatched batch, before its dispatch.
* BucketedLoader at prefetch 0 and 2 yields the JAX BucketedLoader's
  batches, key by key, in the serve pass and in the training stream
  (shuffle, max_iter, skip_batches).
* An exception of the producer thread reaches the consumer, and a
  consumer that stops early stops the thread.
"""

import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_predict import _assert_same_predictions
from tspn_tpu.data.loader import BucketedLoader as JaxLoader
from tspn_tpu_torch.data import segments as tseg
from tspn_tpu_torch.data.loader import BucketedLoader
from tspn_tpu_torch.data.synthetic import synthetic_segments
from tspn_tpu_torch.runtime import predict as tpred

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_vidvrd")
THREAD = "BucketedLoader-prefetch"


@pytest.fixture(scope="module")
def golden_serve():
    """The golden fixture's test segments (the JAX reader), its numpy-seeded
    JAX parameters and the port's model carrying them; both packages'
    artifact roots point at the fixture."""
    from tools.make_golden_fixture import _seeded_params
    from tspn_tpu.config import get_default_config
    from tspn_tpu.data.annotations import VidVRD
    from tspn_tpu.data.segments import get_output_dir, set_output_dir
    from tspn_tpu.data.vrdataset import SegmentDataset
    from tspn_tpu.models.tspn import build_model as jax_build_model
    from tspn_tpu_torch.models.tspn import build_model
    from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

    before = (get_output_dir(), tseg.get_output_dir())
    set_output_dir(os.path.join(FIXTURE, "output"))
    tseg.set_output_dir(os.path.join(FIXTURE, "output"))
    data_dir = os.path.join(FIXTURE, "vidvrd")
    golden = VidVRD(data_dir, os.path.join(data_dir, "videos"), ["train", "test"])
    cfg = get_default_config()
    cfg.PREDICT.PREDICATE_NUM = golden.get_predicate_num()
    cfg.RELPN.USE_PPN = False
    cfg.RELPN.USE_DPN = False
    cfg.DATASET.TEST_BATCH_SIZE = 1
    sds = SegmentDataset(cfg, golden, phase="test")
    model = jax_build_model(cfg)
    params = _seeded_params(model, cfg, sds)
    port = build_model(cfg.PREDICT.PREDICATE_NUM, cfg.PREDICT.FEATURE_DIM)
    port.load_state_dict(state_dict_from_jax(params))
    yield cfg, model, params, port.eval(), sds
    set_output_dir(before[0])
    tseg.set_output_dir(before[1])


def _port_predict(cfg, port, dataset, **kw):
    return tpred.predict_segments(
        port, dataset, device="cpu", buckets=cfg.BUCKETS.NUM_TRACKLETS,
        batch_size=cfg.DATASET.TEST_BATCH_SIZE, topk_per_pair=cfg.PREDICT.TOPK_PER_PAIR,
        topk_per_seg=cfg.PREDICT.TOPK_PER_SEG, num_objects=cfg.PREDICT.OBJECT_NUM,
        feature_dim=cfg.PREDICT.FEATURE_DIM, **kw)


def _assert_identical(a, b):
    assert set(a) == set(b) and a
    for key in a:
        (pa, iou_a, tid_a), (pb, iou_b, tid_b) = a[key], b[key]
        np.testing.assert_array_equal(iou_a, iou_b)
        np.testing.assert_array_equal(tid_a, tid_b)
        assert len(pa) == len(pb)
        for (s_a, trip_a, pair_a), (s_b, trip_b, pair_b) in zip(pa, pb):
            assert s_a == s_b
            np.testing.assert_array_equal(trip_a, trip_b)
            np.testing.assert_array_equal(pair_a, pair_b)


def test_predict_pipeline_depth_parity(golden_serve):
    from tspn_tpu.runtime.predict import predict_segments as jax_predict_segments

    cfg, model, params, port, sds = golden_serve
    outs = {depth: _port_predict(cfg, port, sds, pipeline_depth=depth) for depth in (0, 1, 2)}
    _assert_identical(outs[0], outs[1])
    _assert_identical(outs[0], outs[2])
    ref = jax_predict_segments(cfg, model, params, sds, pipeline_depth=2)
    _assert_same_predictions(ref, outs[2], 1e-6)


def test_batch_hook_runs_once_per_dispatched_batch(golden_serve):
    cfg, _model, _params, port, sds = golden_serve
    n_batches = len(BucketedLoader(sds, cfg.BUCKETS.NUM_TRACKLETS, cfg.DATASET.TEST_BATCH_SIZE,
                                   cfg.PREDICT.FEATURE_DIM, cfg.PREDICT.OBJECT_NUM))
    seen = []

    def hook(batch):  # masks every pair: what is dispatched must be this batch
        seen.append(batch["pair_mask"].sum())
        return dict(batch, pair_mask=np.zeros_like(batch["pair_mask"]))

    for depth in (0, 2):
        seen.clear()
        out = _port_predict(cfg, port, sds, batch_hook=hook, pipeline_depth=depth)
        assert len(seen) == n_batches and all(s > 0 for s in seen)
        assert out and all(len(preds) == 0 for preds, _iou, _tid in out.values())


def _assert_batches_equal(ref, out):
    assert len(out) == len(ref)
    for (b0, batch0, idx0, *_), (b1, batch1, idx1, *_) in zip(ref, out):
        assert b0 == b1 and idx0 == idx1
        assert set(batch0) == set(batch1)
        for k in batch0:
            assert batch0[k].dtype == batch1[k].dtype, k
            np.testing.assert_array_equal(batch0[k], batch1[k], err_msg=k)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("mode", ["q8f", "q8"])
def test_loader_prefetch_matches_jax(mode, prefetch):
    buckets, bsz = (4, 8, 12), 3
    ds = synthetic_segments(7, mode, seed=2, max_tracklets=14)
    width = ds.records[0].feats.shape[1]
    ref = list(JaxLoader(ds, buckets, bsz, width, 132, 35, shuffle=False,
                         include_records=True, include_labels=False, feats_dtype=np.int8))
    _assert_batches_equal(ref, list(BucketedLoader(ds, buckets, bsz, width, 35,
                                                   prefetch=prefetch)))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_prefetch_training_stream_matches_jax(prefetch):
    ds = synthetic_segments(7, "f32", seed=4, max_tracklets=10, num_predicates=12)
    width = ds.feature_width()
    kw = dict(max_iter=11, shuffle=True, seed=5, skip_batches=3)
    ref = list(JaxLoader(ds, (4, 8, 10), 2, width, 12, 35, include_records=True, **kw))
    out = list(BucketedLoader(ds, (4, 8, 10), 2, width, 35, include_labels=True,
                              prefetch=prefetch, **kw))
    _assert_batches_equal(ref, out)


class _Failing:
    """A dataset whose third record cannot be read."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def num_proposals_of(self, i):
        return self.ds.num_proposals_of(i)

    def load_segment(self, i, with_labels=False):
        if i == 2:
            raise OSError("segment 2 is unreadable")
        return self.ds.load_segment(i, with_labels)


def _prefetch_threads() -> int:
    return sum(t.name == THREAD and t.is_alive() for t in threading.enumerate())


def _wait_for_no_prefetch_thread(before: int) -> bool:
    deadline = time.monotonic() + 5.0
    while _prefetch_threads() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    return _prefetch_threads() == before


def test_loader_producer_error_reaches_consumer():
    ds = synthetic_segments(6, "q8", seed=4, max_tracklets=6)
    width = ds.records[0].feats.shape[1]
    before = _prefetch_threads()
    loader = BucketedLoader(_Failing(ds), (4, 8), 1, width, 35, prefetch=2)
    got = []
    with pytest.raises(OSError, match="segment 2 is unreadable"):
        for item in loader:
            got.append(item[2])
    assert got == [[ds.records[0].index], [ds.records[1].index]]
    assert _wait_for_no_prefetch_thread(before)


def test_loader_early_break_stops_the_producer():
    ds = synthetic_segments(12, "q8", seed=4, max_tracklets=6)
    width = ds.records[0].feats.shape[1]
    before = _prefetch_threads()
    loader = BucketedLoader(ds, (4, 8), 1, width, 35, prefetch=2)
    it = iter(loader)
    next(it)
    time.sleep(0.2)  # the producer fills the queue and blocks on it
    assert _prefetch_threads() == before + 1
    it.close()  # what breaking out of a for loop does to the generator
    assert _wait_for_no_prefetch_thread(before)
