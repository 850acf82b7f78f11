"""Checkpoint bridge of the PyTorch port (tspn_tpu_torch/runtime/checkpoint.py).

* load_jax_checkpoint decodes a flax msgpack checkpoint written by the
  JAX package to the same tree as load_checkpoint_raw, leaf for leaf.
* A flax-initialized model and the port's model loaded through
  state_dict_from_jax give equal f32 logits (rtol 1e-5, atol 1e-6: the
  two frameworks' f32 GEMMs sum in different orders).
* The same holds for the fused classifier (``classifier/kernel`` in the
  device layout), whose JAX forward on the CPU is the XLA path.
* Native torch.save checkpoints round-trip, and load_checkpoint reads
  both formats; a training checkpoint also carries the optimizer, the LR
  scheduler and the plateau state, and only such a checkpoint resumes.
"""

import jax
import numpy as np
import pytest
import torch

from tspn_tpu.models.tspn import TSPNModel as JaxTSPNModel
from tspn_tpu.runtime import checkpoint as jckpt
from tspn_tpu_torch.models.tspn import build_model
from tspn_tpu_torch.runtime import checkpoint as tckpt

R, DIM = 9, 11070


@pytest.fixture(scope="module")
def jax_params():
    model = JaxTSPNModel(num_predicates=R, use_ppn=False, use_dpn=False)
    example = {"feats": np.zeros((1, 12, DIM), np.float32)}
    params = model.init(jax.random.PRNGKey(5), example)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_load_jax_checkpoint_matches_raw(jax_params, tmp_path):
    _model, params = jax_params
    opt_state = {"mu": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
                 "count": np.asarray(7, np.int32)}
    path = str(tmp_path / "baseline_weights_iter_7.pt")
    jckpt.save_checkpoint(path, params, opt_state=opt_state, step=7, loss=0.25)
    ref = jckpt.load_checkpoint_raw(path)
    got = tckpt.load_jax_checkpoint(path)
    assert (got["step"], got["loss"]) == (ref["step"], ref["loss"]) == (7, 0.25)
    for key in ("params", "opt_state"):
        a, b = _flatten(ref[key]), _flatten(got[key])
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_bridged_model_logits_match(jax_params):
    model, params = jax_params
    rng = np.random.RandomState(0)
    feats = rng.rand(2, 12, DIM).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, {"feats": feats})["rel_logits"])
    port = build_model(num_predicates=R, feature_dim=DIM)
    port.load_state_dict(tckpt.state_dict_from_jax(params))
    with torch.no_grad():
        out = port({"feats": torch.from_numpy(feats)})["rel_logits"].numpy()
    assert out.shape == ref.shape == (2, 12, R)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_load_checkpoint_reads_both_formats(jax_params, tmp_path):
    _model, params = jax_params
    jpath = str(tmp_path / "a" / "baseline_weights_iter_3.pt")
    jckpt.save_checkpoint(jpath, params, step=3, loss=1.5)
    from_jax = tckpt.load_checkpoint(jpath)
    assert from_jax["step"] == 3
    port = build_model(num_predicates=R, feature_dim=DIM)
    port.load_state_dict(from_jax["state_dict"])

    npath = tckpt.save_checkpoint(
        str(tmp_path / "b" / "baseline_weights_iter_12.pt"), port, step=12, loss=0.5
    )
    tckpt.save_checkpoint(str(tmp_path / "b" / "baseline_weights_iter_4.pt"), port)
    assert tckpt.latest_checkpoint(str(tmp_path / "b"), "baseline") == npath
    assert tckpt.latest_checkpoint(str(tmp_path / "missing"), "baseline") is None
    native = tckpt.load_checkpoint(npath)
    assert (native["step"], native["loss"]) == (12, 0.5)
    for k, v in port.state_dict().items():
        assert torch.equal(native["state_dict"][k], v)


def test_seeded_init_statistics():
    a = build_model(num_predicates=R, feature_dim=DIM, seed=3)
    b = build_model(num_predicates=R, feature_dim=DIM, seed=3)
    w = a.classifier.rel_predictor.weight.detach()
    assert torch.equal(w, b.classifier.rel_predictor.weight)
    assert abs(float(w.std()) - 0.01) < 1e-3
    assert float(a.classifier.rel_predictor.bias.abs().max()) == 0.0


def test_bridged_fused_model_logits_match():
    model = JaxTSPNModel(num_predicates=R, use_ppn=False, use_dpn=False,
                         fused_classifier=True)
    rng = np.random.RandomState(1)
    feats = (rng.rand(2, 12, 11264) * (rng.rand(2, 12, 11264) < 0.2)).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(6), {"feats": feats})["params"])
    ref = np.asarray(model.apply({"params": params}, {"feats": feats})["rel_logits"])
    port = build_model(num_predicates=R, fused_classifier=True, inference=True)
    port.load_state_dict(tckpt.state_dict_from_jax(params))
    with torch.no_grad():
        out = port({"feats": torch.from_numpy(feats)})["rel_logits"].numpy()
    assert out.shape == ref.shape == (2, 12, R)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_training_checkpoint_round_trip(tmp_path):
    from tspn_tpu_torch.solver.optim import ReduceOnPlateauState, build_optimizer
    from tspn_tpu.config import get_default_config

    port = build_model(num_predicates=R, fused_classifier=True, seed=1)
    optimizer, scheduler = build_optimizer(get_default_config().SOLVER, port)
    for p in port.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    scheduler.step()
    plateau = ReduceOnPlateauState().update(0.5).update(0.7)
    path = tckpt.save_checkpoint(str(tmp_path / "x_weights_iter_1.pt"), port, step=1,
                                 loss=0.5, optimizer=optimizer, scheduler=scheduler,
                                 plateau=plateau)
    restored = tckpt.load_training_checkpoint(path)
    assert restored["step"] == 1 and restored["native"]
    assert ReduceOnPlateauState(**restored["plateau"]) == plateau
    assert restored["scheduler"]["last_epoch"] == 1
    fresh, _ = build_optimizer(get_default_config().SOLVER,
                               build_model(num_predicates=R, fused_classifier=True))
    fresh.load_state_dict(restored["optimizer"])
    for a, b in zip(fresh.state.values(), optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    bare = tckpt.save_checkpoint(str(tmp_path / "x_weights_iter_2.pt"), port)
    with pytest.raises(ValueError):
        tckpt.load_training_checkpoint(bare)


@pytest.mark.parametrize("what", ["ppn", "fused", "ppn_weights", "fused_weights"])
def test_unported_parts_raise(what, jax_params, tmp_path):
    """Span mode raises: the CLI's training with RELPN.USE_DPN ("ppn": the
    PPN itself is ported, its video-level chain ranker belongs to span
    mode) and a param tree with a span-mode subtree ("ppn_weights"); so
    does a JAX checkpoint given to --resume (its optax state is not
    carried across). The fused classifier in bf16 ("fused") no longer
    raises: its f32 parameters load from the same checkpoint and it
    serves bf16 rows with f32 logits."""
    from types import SimpleNamespace

    from tspn_tpu_torch import base
    from tspn_tpu_torch.config import get_default_config

    if what == "fused":
        rng = np.random.RandomState(6)
        params = {"classifier": {
            "kernel": (rng.randn(11264, R) * 0.01).astype(np.float32),
            "bias": np.zeros(R, np.float32)}}
        model = build_model(num_predicates=R, fused_classifier=True, dtype=torch.bfloat16)
        model.load_state_dict(tckpt.state_dict_from_jax(params))
        out = model({"feats": torch.ones((1, 2, 11264), dtype=torch.bfloat16)})
        assert out["rel_logits"].dtype == torch.float32
        assert out["rel_logits"].shape == (1, 2, R)
        assert bool(torch.isfinite(out["rel_logits"]).all())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "ppn":
            cfg = get_default_config()
            assert cfg.RELPN.USE_PPN and cfg.RELPN.USE_DPN
            base.training(cfg, SimpleNamespace(dataset="vidvrd", device="cpu",
                                               resume=False), str(tmp_path))
        elif what == "ppn_weights":
            tckpt.state_dict_from_jax({"classifier": {}, "ppn_head": {},
                                       "span_head": {}})
        else:
            path = str(tmp_path / "baseline_weights_iter_3.pt")
            jckpt.save_checkpoint(path, jax_params[1], step=3)
            tckpt.load_training_checkpoint(path)
