"""Parity of the port's training path with the JAX package's, on the CPU.

* The training loader (epoch-seeded shuffle, max_iter across epochs,
  skip_batches, end-of-epoch flush by repetition, labels) yields the JAX
  ``BucketedLoader(shuffle=True, max_iter=..., skip_batches=...)``'s
  batches, key by key and bit for bit.
* The slice as a whole: ``tspn_tpu.runtime.train.train`` and the port's
  ``train`` on the ``synthetic_dataset`` fixture, unfused and fused, from the same
  weights (the JAX init carried across with ``state_dict_from_jax``).
  Per-step losses agree to rtol 1e-4 and final parameters to atol 1e-4.
  They are not exact: the two frameworks sum the forward and the
  gradients in different orders, and Adam divides each gradient by its
  own running RMS, which turns ulp-level gradient differences into small
  update differences that accumulate over the steps.
  The port reads the artifacts through its own copies of the JAX
  package's readers, pointed at the same artifact root.
* Resume: 5 steps, then ``--resume`` to 10, equals 10 uninterrupted steps
  bit for bit (torch.equal), plateau state included; a JAX checkpoint
  given to ``--resume`` raises.

The JAX ``train`` writes ``configs/<name>_config.yaml`` under the working
directory, so every run here works in a temporary directory.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tspn_tpu.data.loader import BucketedLoader as JaxLoader
from tspn_tpu.data.segments import get_model_path
from tspn_tpu.runtime import train as jtrain
from tspn_tpu.data.segments import get_output_dir
from tspn_tpu_torch.data import segments as tseg
from tspn_tpu_torch.data.loader import BucketedLoader
from tspn_tpu_torch.data.synthetic import synthetic_segments
from tspn_tpu_torch.runtime import train as ttrain
from tspn_tpu_torch.runtime.checkpoint import latest_checkpoint, state_dict_from_jax


@pytest.fixture
def synthetic_dataset(synthetic_dataset):
    """The conftest's synthetic set, with the port's artifact root (its own
    copy of the JAX package's segments module) where the JAX package's
    points."""
    tseg.set_output_dir(get_output_dir())
    return synthetic_dataset


@pytest.mark.parametrize("mode,skip", [("f32", 0), ("f32", 3), ("f32dev", 2)])
def test_training_loader_matches_jax(mode, skip):
    ds = synthetic_segments(7, mode, seed=4, max_tracklets=10, num_predicates=12)
    width = ds.feature_width()
    kw = dict(max_iter=9, shuffle=True, seed=3, skip_batches=skip)
    ref = list(JaxLoader(ds, (4, 8, 10), 2, width, 12, 35, include_records=True,
                         **kw))
    out = list(BucketedLoader(ds, (4, 8, 10), 2, width, 35, include_labels=True, **kw))
    assert len(out) == len(ref) == 9 - skip
    for (b0, batch0, idx0, _r0), (b1, batch1, idx1, _r1) in zip(ref, out):
        assert b0 == b1 and idx0 == idx1
        assert set(batch0) == set(batch1) and "labels" in batch1
        for k in batch0:
            assert batch0[k].dtype == batch1[k].dtype, k
            np.testing.assert_array_equal(batch0[k], batch1[k], err_msg=k)


def _cfg(cfg, dataset, name, fused, **solver):
    cfg = cfg.clone()
    cfg.merge_from_dict({
        "MODEL": {"NAME": name, "FUSED_CLASSIFIER": fused},
        "PREDICT": {"PREDICATE_NUM": dataset.get_predicate_num()},
        "RELPN": {"USE_PPN": False, "USE_DPN": False},
        "SOLVER": {"MAX_ITER": 6,
                   "SCHEDULER": {"MILESTONES": [3, 5], "WARMUP_ITERS": 2}},
        "ETC": {"SAVE_FREQ": 100, "DISPLAY_FREQ": 100},
        "BUCKETS": {"SEGMENTS_PER_STEP": 2},
        "MESH": {"NUM_DEVICES": 1},
    })
    cfg.merge_from_dict({"SOLVER": solver})
    return cfg


@pytest.mark.parametrize("fused", [False, True])
def test_train_matches_jax(fused, cfg, synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcfg = _cfg(cfg, synthetic_dataset, f"torch_parity_jax_{int(fused)}", fused)
    tcfg = _cfg(cfg, synthetic_dataset, f"torch_parity_port_{int(fused)}", fused)

    jax_losses = []
    make_step = jtrain.make_train_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, *rest):
            state, metrics = step(state, batch, *rest)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(jtrain, "make_train_step", recording_step)
    state = jtrain.train(jcfg, synthetic_dataset)

    # the JAX run's own init, recomputed as its train() makes it
    model = jtrain.build_model(jcfg)
    init = model.init(
        jax.random.PRNGKey(jcfg.ETC.RANDOM_SEED),
        jtrain._example_batch(min(jcfg.BUCKETS.NUM_TRACKLETS), 1, jcfg),
    )["params"]
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, init))
    result = ttrain.train(tcfg, synthetic_dataset, "cpu", init_state_dict=init)

    assert result.step == int(np.asarray(state.step)) == 6
    assert len(jax_losses) == len(result.losses) == 6
    np.testing.assert_allclose(result.losses, jax_losses, rtol=1e-4)
    assert result.losses[-1] < result.losses[0]
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
    got = result.model.state_dict()
    assert set(got) == set(final)
    for k, v in final.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    ckpt = latest_checkpoint(get_model_path(), tcfg.MODEL.NAME)
    assert ckpt.endswith("_iter_6.pt")


@pytest.mark.parametrize("sched", ["warmup_multi", "plateau"])
def test_resume_equals_uninterrupted(sched, cfg, synthetic_dataset, tmp_path,
                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(MAX_ITER=10, SCHEDULER={"TYPE": sched, "MILESTONES": [4, 7],
                                      "WARMUP_ITERS": 3})
    straight_cfg = _cfg(cfg, synthetic_dataset, f"torch_straight_{sched}", True, **kw)
    resumed_cfg = _cfg(cfg, synthetic_dataset, f"torch_resumed_{sched}", True, **kw)
    straight = ttrain.train(straight_cfg, synthetic_dataset, "cpu")

    first = resumed_cfg.clone()
    first.SOLVER.MAX_ITER = 5
    assert ttrain.train(first, synthetic_dataset, "cpu").step == 5
    resumed = ttrain.train(resumed_cfg, synthetic_dataset, "cpu", resume=True)
    assert resumed.step == 10 and len(resumed.losses) == 5
    assert resumed.losses == straight.losses[5:]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert resumed.plateau == straight.plateau
    if sched == "plateau":
        assert resumed.plateau.num_bad > 0 or resumed.plateau.best < float("inf")
    ckpt = latest_checkpoint(get_model_path(), resumed_cfg.MODEL.NAME)
    assert ckpt.endswith("_iter_10.pt")


def test_resume_refuses_jax_checkpoint(cfg, synthetic_dataset, tmp_path, monkeypatch):
    from tspn_tpu.runtime.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    tcfg = _cfg(cfg, synthetic_dataset, "torch_resume_jax", False)
    model = jtrain.build_model(tcfg)
    params = model.init(jax.random.PRNGKey(0),
                        jtrain._example_batch(8, 1, tcfg))["params"]
    save_checkpoint(os.path.join(get_model_path(), "torch_resume_jax_weights_iter_2.pt"),
                    params, step=2)
    with pytest.raises(NotImplementedError, match="optax state"):
        ttrain.train(tcfg, synthetic_dataset, "cpu", resume=True)
