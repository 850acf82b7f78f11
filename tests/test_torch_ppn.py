"""The PPN configuration of the port against the JAX package, on the CPU.

* ``PPNHead`` with weights carried across by ``state_dict_from_jax``
  (and back by ``jax_params_from_state_dict``) gives the flax head's pair
  logits, and ``ppn_loss`` its loss, within rtol 1e-5 / atol 1e-6 (the
  two frameworks sum in different orders); ``gt_pair_matrix`` is equal
  exactly; ``top_pair_proposals`` selects the same cells (as sets) with
  the same scores.
* ``compute_losses`` gives ``loss_rel`` and ``loss_pair`` of the JAX
  ``compute_losses`` on one batch, within the same tolerance.
* Training with the PPN head (``RELPN.USE_PPN``, span mode off): the JAX
  ``train`` and the port's from the same carried-across init, 6 steps,
  unfused and fused; per-step losses (total and each term) agree to rtol
  1e-4 and final parameters to atol 1e-4, as tests/test_torch_train.py
  holds training without the head.
* PPN-pruned ``predict_segments`` (``PRUNE_AT_INFERENCE``, few proposals
  so that pruning cuts) against the JAX ``predict_segments`` for the
  q8f, q8 and f32 scorers, with ``FUSE_SCORE`` off and on. Selections
  are compared as sets, apart from entries tied with the last selected,
  and sorted scores within 1e-6 (q8: 1e-5, since the JAX package's CPU
  q8 scorer sums int8 products in f32 and is not exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.data.preprocess import consolidate_split
from tspn_tpu.data.segments import get_output_dir
from tspn_tpu.models import ppn as jppn
from tspn_tpu.models.tspn import TSPNModel as JaxTSPNModel
from tspn_tpu.parallel.train_step import compute_losses as jax_compute_losses
from tspn_tpu.runtime import predict as jpred
from tspn_tpu.runtime import train as jtrain
from tspn_tpu_torch.data import segments as tseg
from tspn_tpu_torch.data.preprocess import ConsolidatedSegmentDataset
from tspn_tpu_torch.data.vrdataset import SegmentDataset
from tspn_tpu_torch.models import ppn as tppn
from tspn_tpu_torch.models.tspn import build_model, build_model_from_config
from tspn_tpu_torch.parallel.train_step import PPN_TRAIN_KEYS, batch_to_device, compute_losses
from tspn_tpu_torch.runtime import predict as tpred
from tspn_tpu_torch.runtime import train as ttrain
from tspn_tpu_torch.runtime.checkpoint import jax_params_from_state_dict, state_dict_from_jax

R, DIM, C = 7, 11070, 35
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_model_params(seed=0, n=6):
    model = JaxTSPNModel(num_predicates=R, use_ppn=True, use_dpn=False)
    example = {"feats": np.zeros((1, 2, DIM), np.float32),
               "cls_logits": np.zeros((1, n, C), np.float32)}
    params = model.init(jax.random.PRNGKey(seed), example)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _batch(rng, bsz=3, n=6, sizes=(6, 4, 2)):
    """A padded batch: segment k has sizes[k] real tracklets, all its
    ordered pairs as rows, a few positive labels; padded pairs are (0, 0)."""
    p = n * (n - 1)
    pairs = np.zeros((bsz, p, 2), np.int32)
    mask = np.zeros((bsz, p), np.float32)
    labels = np.zeros((bsz, p, R), np.float32)
    track = np.zeros((bsz, n), np.float32)
    for k, m in enumerate(sizes):
        sub, obj = np.nonzero(~np.eye(m, dtype=bool))
        pairs[k, : sub.size] = np.stack([sub, obj], 1)
        mask[k, : sub.size] = 1
        track[k, :m] = 1
        hot = rng.randint(sub.size, size=2)
        labels[k, hot, rng.randint(R, size=2)] = 1
    labels[0, -1, 0] = 1  # a label on a padded row: masked out
    return {
        "feats": rng.rand(bsz, p, DIM).astype(np.float32),
        "pairs": pairs, "labels": labels, "pair_mask": mask,
        "cls_logits": (rng.randn(bsz, n, C) * 2).astype(np.float32),
        "track_mask": track,
    }


def test_ppn_head_carried_weights_match():
    model, params = _jax_model_params(seed=1)
    rng = np.random.RandomState(0)
    cls = (rng.randn(3, 6, C) * 2).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, cls,
                                 method=lambda m, x: m.ppn_head(x)))
    port = build_model(R, DIM, use_ppn=True)
    port.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        out = port.ppn_head(torch.from_numpy(cls)).numpy()
    assert out.shape == ref.shape == (3, 6, 6)
    np.testing.assert_allclose(out, ref, **TOL)
    back = jax_params_from_state_dict(port.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_ppn_head_init_matches_flax_in_kind():
    port = build_model(R, DIM, use_ppn=True, seed=3)
    _, params = _jax_model_params(seed=3)
    for name in ("sub_fc1", "sub_fc2", "obj_fc1", "obj_fc2"):
        fc = getattr(port.ppn_head, name)
        kernel = params["ppn_head"][name]["kernel"]
        assert tuple(fc.weight.shape) == kernel.shape[::-1]
        assert float(fc.bias.detach().abs().max()) == 0.0
        std = float(fc.weight.detach().std())
        assert abs(std - kernel.std()) < 0.35 * kernel.std(), name


def test_gt_pair_matrix_and_loss_match():
    rng = np.random.RandomState(2)
    batch = _batch(rng)
    batch["pairs"][1, 3] = (9, 1)  # out of range: JAX drops it
    n = batch["cls_logits"].shape[1]
    ref_gt = np.asarray(jax.vmap(lambda p, l, m: jppn.gt_pair_matrix(p, l, m, n))(
        batch["pairs"], batch["labels"], batch["pair_mask"]))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    gt = tppn.gt_pair_matrix(t["pairs"], t["labels"], t["pair_mask"], n)
    assert gt.dtype == torch.float32 and ref_gt.sum() > 0
    np.testing.assert_array_equal(gt.numpy(), ref_gt)

    logits = (rng.randn(3, n, n) * 3).astype(np.float32)
    ref = np.asarray(jax.vmap(jppn.ppn_loss)(logits, ref_gt, batch["track_mask"]))
    out = tppn.ppn_loss(torch.from_numpy(logits), gt, t["track_mask"]).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_top_pair_proposals_match():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 7, 7).astype(np.float32)
    track = np.ones((2, 7), np.float32)
    track[1, 4:] = 0
    for k in (5, 20, 49):
        for i in range(2):
            j_idx, j_sc = (np.asarray(a) for a in jppn.top_pair_proposals(
                jnp.asarray(logits[i]), jnp.asarray(track[i]), k))
            t_idx, t_sc = tppn.top_pair_proposals(
                torch.from_numpy(logits[i:i + 1]), torch.from_numpy(track[i:i + 1]), k)
            assert t_idx.shape == (1, min(k, 49))
            finite = j_sc > 0  # the sigmoid of a masked (-inf) cell
            assert set(j_idx[finite].tolist()) == set(t_idx[0].numpy()[finite].tolist())
            np.testing.assert_allclose(np.sort(t_sc[0].numpy()), np.sort(j_sc), **TOL)


def test_compute_losses_with_ppn_match():
    model, params = _jax_model_params(seed=5)
    batch = _batch(np.random.RandomState(6))
    ref = jax_compute_losses(model, params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = build_model(R, DIM, use_ppn=True)
    port.load_state_dict(state_dict_from_jax(params))
    out = compute_losses(port, batch_to_device(batch, "cpu", PPN_TRAIN_KEYS))
    assert set(out) == set(ref) == {"loss_rel", "loss_pair"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), **TOL)


# ---------------------------------------------------------------- training
@pytest.fixture
def port_dataset(synthetic_dataset):
    """The synthetic set, with the port's artifact root where the JAX
    package's points."""
    tseg.set_output_dir(get_output_dir())
    return synthetic_dataset


def _ppn_cfg(cfg, dataset, name, fused):
    cfg = cfg.clone()
    cfg.merge_from_dict({
        "MODEL": {"NAME": name, "FUSED_CLASSIFIER": fused},
        "PREDICT": {"PREDICATE_NUM": dataset.get_predicate_num()},
        "RELPN": {"USE_PPN": True, "USE_DPN": False},
        "SOLVER": {"MAX_ITER": 6,
                   "SCHEDULER": {"MILESTONES": [3, 5], "WARMUP_ITERS": 2}},
        "ETC": {"SAVE_FREQ": 100, "DISPLAY_FREQ": 100},
        "BUCKETS": {"SEGMENTS_PER_STEP": 2},
        "MESH": {"NUM_DEVICES": 1},
    })
    return cfg


@pytest.mark.parametrize("fused", [False, True])
def test_train_with_ppn_matches_jax(fused, cfg, port_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcfg = _ppn_cfg(cfg, port_dataset, f"ppn_parity_jax_{int(fused)}", fused)
    tcfg = _ppn_cfg(cfg, port_dataset, f"ppn_parity_port_{int(fused)}", fused)

    jax_metrics = []
    make_step = jtrain.make_train_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, *rest):
            state, metrics = step(state, batch, *rest)
            jax_metrics.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        return run

    monkeypatch.setattr(jtrain, "make_train_step", recording_step)
    state = jtrain.train(jcfg, port_dataset)
    model = jtrain.build_model(jcfg)
    init = model.init(
        jax.random.PRNGKey(jcfg.ETC.RANDOM_SEED),
        jtrain._example_batch(min(jcfg.BUCKETS.NUM_TRACKLETS), 1, jcfg),
    )["params"]
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, init))
    result = ttrain.train(tcfg, port_dataset, "cpu", init_state_dict=init)

    assert result.step == int(np.asarray(state.step)) == 6
    assert set(result.loss_terms) == {"loss_rel", "loss_pair"}
    np.testing.assert_allclose(result.losses, [m["loss"] for m in jax_metrics], rtol=1e-4)
    for k, v in result.loss_terms.items():
        np.testing.assert_allclose(v, [m[k] for m in jax_metrics], rtol=1e-4, err_msg=k)
    assert result.losses[-1] < result.losses[0]
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    got = result.model.state_dict()
    assert set(got) == set(final) and any(k.startswith("ppn_head.") for k in got)
    for k, v in final.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ pruned serve
K = 10  # below the 8-bucket's 56 pairs, so pruning cuts every segment


@pytest.fixture(scope="module")
def pruned_setup():
    from tspn_tpu.config import get_default_config
    from tspn_tpu.models.tspn import build_model as jax_build_model

    cfg = get_default_config()
    cfg.RELPN.USE_DPN = False
    cfg.RELPN.PPN.PRUNE_AT_INFERENCE = True
    cfg.RELPN.PPN.NUM_PAIR_PROPOSALS = K
    cfg.DATASET.TEST_BATCH_SIZE = 4
    model = jax_build_model(cfg, inference=True)
    bucket = min(cfg.BUCKETS.NUM_TRACKLETS)
    example = {
        "feats": np.zeros((1, bucket * (bucket - 1), cfg.PREDICT.FEATURE_DIM), np.float32),
        "cls_logits": np.zeros((1, bucket, cfg.PREDICT.OBJECT_NUM), np.float32),
    }
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(8), example)["params"])
    port = build_model_from_config(cfg, inference=True)
    port.load_state_dict(state_dict_from_jax(params))
    return cfg, model, params, port.eval()


def _selection(preds, tol):
    """-> (scores sorted high to low, entries scored above the last one
    selected by more than tol)."""
    scores = np.array([float(s) for s, _t, _i in preds])
    last = scores.min() if scores.size else 0.0
    above = {(tuple(int(x) for x in i), int(t[1]))
             for s, t, i in preds if float(s) > last + tol}
    return np.sort(scores)[::-1], above


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("mode", ["q8f", "q8", "f32"])
def test_pruned_predict_matches_jax(mode, fuse, pruned_setup, port_dataset, tmp_path):
    cfg, model, params, port = pruned_setup
    cfg = cfg.clone()
    cfg.RELPN.PPN.FUSE_SCORE = fuse
    if mode == "f32":
        jds = tds = SegmentDataset(cfg, port_dataset, phase="test")
        feature_dim = cfg.PREDICT.FEATURE_DIM
    else:
        path = consolidate_split(cfg, port_dataset, "test",
                                 str(tmp_path / f"test_{mode}.hdf5"), quantize=mode)
        from tspn_tpu.data.preprocess import ConsolidatedSegmentDataset as JaxStore

        jds, tds = JaxStore(cfg, path), ConsolidatedSegmentDataset(cfg, path)
        feature_dim = None
    ref = jpred.predict_segments(cfg, model, params, jds)
    num_pair_proposals, fuse_score = tpred.prune_settings(cfg)
    assert (num_pair_proposals, fuse_score) == (K, fuse)
    out = tpred.predict_segments(
        port, tds, device="cpu", buckets=cfg.BUCKETS.NUM_TRACKLETS,
        batch_size=cfg.DATASET.TEST_BATCH_SIZE, topk_per_pair=cfg.PREDICT.TOPK_PER_PAIR,
        topk_per_seg=cfg.PREDICT.TOPK_PER_SEG, num_objects=cfg.PREDICT.OBJECT_NUM,
        feature_dim=feature_dim, num_pair_proposals=num_pair_proposals,
        fuse_ppn_score=fuse_score,
    )
    tol = 1e-5 if mode == "q8" else 1e-6
    assert set(out) == set(ref) and ref
    for key in ref:
        np.testing.assert_array_equal(out[key][1], ref[key][1])
        np.testing.assert_array_equal(out[key][2], ref[key][2])
        s_ref, above_ref = _selection(ref[key][0], tol)
        s_out, above_out = _selection(out[key][0], tol)
        assert len(out[key][0]) <= 20 * K
        assert s_out.shape == s_ref.shape
        np.testing.assert_allclose(s_out, s_ref, rtol=0, atol=tol)
        assert above_out == above_ref, key
