"""Parity of the PyTorch port's serve path with the JAX package.

* select_topk selects the same (pair, predicate) entries as
  _select_topk. Ties break differently in lax.top_k and torch.topk, so
  selections are compared as sets, apart from entries tied with the
  last one selected.
* The port's BucketedLoader yields the JAX BucketedLoader's batches
  (shuffle=False, include_labels=False), key by key.
* The slice as a whole: predict_segments of both packages on the
  synthetic fixture's q8f store (and per-file f32 segments) give the same
  segments, the same selections and scores within 1e-6.
* The port's expanded q8 scorer agrees with normalize_classify_q8s_pallas
  on a consolidated q8 batch (the JAX package's CPU predict path scores
  q8 with an f32 XLA oracle, which is not exact, so the slice is held
  against the Pallas function instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.data.loader import BucketedLoader as JaxLoader
from tspn_tpu.data.preprocess import ConsolidatedSegmentDataset, consolidate_split
from tspn_tpu.data.vrdataset import SegmentDataset
from tspn_tpu.models.tspn import build_model as jax_build_model
from tspn_tpu.runtime import predict as jpred
from tspn_tpu_torch.data.loader import BucketedLoader, SegmentRecord
from tspn_tpu_torch.data.synthetic import InMemorySegments, synthetic_segments
from tspn_tpu_torch.models.tspn import build_model
from tspn_tpu_torch.runtime import predict as tpred
from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax


def _selection_sets(scores, pairs, preds, valid, tol):
    """-> (scores sorted high to low, the entries scored above the last
    selected one by more than tol)."""
    ok = np.asarray(valid, bool)
    s = np.asarray(scores)[ok]
    entries = list(zip(s.tolist(), np.asarray(pairs)[ok].tolist(),
                       np.asarray(preds)[ok].tolist()))
    last = s.min() if s.size else 0.0
    above = {(repr(p), repr(q)) for v, p, q in entries if v > last + tol}
    return np.sort(s)[::-1], above


def _assert_same_selection(a, b, tol):
    sa, above_a = _selection_sets(*a, tol)
    sb, above_b = _selection_sets(*b, tol)
    assert sa.shape == sb.shape
    np.testing.assert_allclose(sa, sb, rtol=0, atol=tol)
    assert above_a == above_b


def test_select_topk_matches_jax():
    rng = np.random.RandomState(0)
    b, p, r = 3, 12, 9
    prob = rng.rand(b, p, r).astype(np.float32)
    mask = (rng.rand(b, p) < 0.7).astype(np.float32)
    mask[2] = 0  # a segment with no valid pair
    mask[1, :2] = 1
    for k1, k2 in ((4, 10), (20, 200), (1, 3)):
        ref = [np.asarray(x) for x in jax.vmap(
            lambda rp, pm: jpred._select_topk(rp, pm, k1, k2)
        )(jnp.asarray(prob), jnp.asarray(mask))]
        out = [t.numpy() for t in tpred.select_topk(
            torch.from_numpy(prob), torch.from_numpy(mask), k1, k2
        )]
        for x, y in zip(ref, out):
            assert x.shape == y.shape
        assert out[1].dtype == np.int32 and out[2].dtype == np.int32
        np.testing.assert_array_equal(ref[3], out[3])
        assert (out[0][~out[3]] == 0).all()
        for i in range(b):
            _assert_same_selection([x[i] for x in ref], [y[i] for y in out], 0.0)


def _f32_records(rng, sizes, dim=11070, c=35):
    from tspn_tpu_torch.data.synthetic import ordered_pairs

    recs = []
    for k, n in enumerate(sizes):
        pairs = ordered_pairs(n)
        recs.append(SegmentRecord(
            index=("F32", k, k + 30), feats=rng.rand(len(pairs), dim).astype(np.float32),
            pairs=pairs, labels=None, cls_logits=rng.randn(n, c).astype(np.float32),
            num_proposals=n, iou=np.eye(n, dtype=np.float32),
            trackid=np.full(n, -1, np.int64),
        ))
    return InMemorySegments(recs, "f32")


@pytest.mark.parametrize("mode", ["q8f", "q8", "f32"])
def test_loader_batches_match_jax(mode):
    buckets, bsz = (4, 8, 12), 3
    if mode == "f32":
        ds = _f32_records(np.random.RandomState(1), [3, 9, 14, 2, 5, 4, 13])
    else:  # 14 tracklets truncate to the 12 bucket
        ds = synthetic_segments(7, mode, seed=2, max_tracklets=14)
    width = ds.records[0].feats.shape[1]
    dtype = np.float32 if mode == "f32" else np.int8
    ref = list(JaxLoader(ds, buckets, bsz, width, 132, 35, shuffle=False,
                         include_records=True, include_labels=False,
                         feats_dtype=dtype))
    loader = BucketedLoader(ds, buckets, bsz, width, 35)
    out = list(loader)
    assert len(out) == len(ref) == len(loader)
    for (b0, batch0, idx0, _r0), (b1, batch1, idx1, _r1) in zip(ref, out):
        assert b0 == b1 and idx0 == idx1
        assert set(batch0) == set(batch1)
        for k in batch0:
            assert batch0[k].dtype == batch1[k].dtype, k
            np.testing.assert_array_equal(batch0[k], batch1[k], err_msg=k)


@pytest.fixture(scope="module")
def slice_setup():
    from tspn_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.RELPN.USE_PPN = False
    cfg.RELPN.USE_DPN = False
    cfg.DATASET.TEST_BATCH_SIZE = 4
    model = jax_build_model(cfg)
    bucket = min(cfg.BUCKETS.NUM_TRACKLETS)
    p = bucket * (bucket - 1)
    example = {
        "feats": np.zeros((1, p, cfg.PREDICT.FEATURE_DIM), np.float32),
        "cls_logits": np.zeros((1, bucket, cfg.PREDICT.OBJECT_NUM), np.float32),
    }
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(3), example)["params"]
    )
    port = build_model(cfg.PREDICT.PREDICATE_NUM, cfg.PREDICT.FEATURE_DIM)
    port.load_state_dict(state_dict_from_jax(params))
    return cfg, model, params, port.eval()


def _port_predict(cfg, port, dataset, **kw):
    return tpred.predict_segments(
        port, dataset, device="cpu", buckets=cfg.BUCKETS.NUM_TRACKLETS,
        batch_size=cfg.DATASET.TEST_BATCH_SIZE,
        topk_per_pair=cfg.PREDICT.TOPK_PER_PAIR,
        topk_per_seg=cfg.PREDICT.TOPK_PER_SEG,
        num_objects=cfg.PREDICT.OBJECT_NUM, **kw,
    )


def _as_arrays(preds):
    """predictions -> (scores, tracklet pairs, triplets, valid)."""
    scores = np.array([float(s) for s, _t, _i in preds], np.float64)
    pairs = [tuple(int(x) for x in i) for _s, _t, i in preds]
    trips = [tuple(int(x) for x in t) for _s, t, _i in preds]
    return scores, pairs, trips, np.ones(len(preds), bool)


def _assert_same_predictions(ref, out, tol):
    assert set(ref) == set(out) and ref
    for key in ref:
        p0, iou0, tid0 = ref[key]
        p1, iou1, tid1 = out[key]
        np.testing.assert_array_equal(iou0, iou1)
        np.testing.assert_array_equal(tid0, tid1)
        _assert_same_selection(_as_arrays(p0), _as_arrays(p1), tol)


@pytest.mark.parametrize("mode", ["q8f", "f32"])
def test_predict_segments_matches_jax(mode, slice_setup, synthetic_dataset, tmp_path):
    cfg, model, params, port = slice_setup
    if mode == "q8f":
        path = consolidate_split(cfg, synthetic_dataset, "test",
                                 str(tmp_path / "test_q8f.hdf5"), quantize="q8f")
        dataset = ConsolidatedSegmentDataset(cfg, path)
        assert dataset.factored
    else:
        dataset = SegmentDataset(cfg, synthetic_dataset, phase="test")
    ref = jpred.predict_segments(cfg, model, params, dataset)
    out = _port_predict(
        cfg, port, dataset,
        feature_dim=None if mode == "q8f" else cfg.PREDICT.FEATURE_DIM,
    )
    _assert_same_predictions(ref, out, 1e-6)


def test_q8_scorer_matches_pallas(slice_setup, synthetic_dataset, tmp_path):
    from tspn_tpu.ops.pairwise import normalize_classify_q8s_pallas

    cfg, _model, params, port = slice_setup
    path = consolidate_split(cfg, synthetic_dataset, "test",
                             str(tmp_path / "test_q8.hdf5"), quantize="q8")
    dataset = ConsolidatedSegmentDataset(cfg, path)
    assert dataset.quantized and not dataset.factored
    loader = BucketedLoader(dataset, cfg.BUCKETS.NUM_TRACKLETS, 1,
                            dataset.feature_width(), 35)
    _bucket, batch, _idx, _recs = next(iter(loader))
    rows = min(60, batch["feats"].shape[1])  # interpret-mode Pallas is slow
    feats, scales = batch["feats"][:, :rows], batch["feat_scale"][:, :rows]

    qw, sw, b, layout, r = jpred._q8_classifier_weights(cfg, params)
    ref = np.asarray(normalize_classify_q8s_pallas(
        jnp.asarray(feats[0]), jnp.asarray(scales[0]), qw, sw, b, layout=layout,
    ))[:, :r]
    w, bias = tpred.classifier_weights(port)
    score = tpred.make_q8_scorer(tpred.q8_classifier_weights(w, bias, layout, "cpu"))
    out = score({"feats": torch.from_numpy(feats),
                 "feat_scale": torch.from_numpy(scales)})[0].numpy()
    assert out.shape == ref.shape == (rows, 132)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    # the whole q8 slice runs on the port and serves every segment
    served = _port_predict(cfg, port, dataset)
    ref_keys = {dataset.index[i] for i in range(len(dataset))
                if dataset.num_proposals_of(i) > 1}
    assert set(served) == ref_keys
