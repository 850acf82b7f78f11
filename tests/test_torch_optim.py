"""Parity of the port's optimizer, schedules and loss with the JAX package.

* ``build_optimizer`` (torch Adam / SGD over bias and non-bias groups,
  with LambdaLR multipliers) follows the JAX ``build_optimizer`` (an
  optax chain) step for step over 7 steps on the same parameters and
  gradients, for Adam and SGD under "warmup_multi" and "multi", with the
  warm-up and both milestones inside those steps, bias LR factor 2 and
  both weight decays. Tolerance rtol 1e-5 / atol 2e-6 (16 ulps of the
  O(1) parameters): the JAX schedule runs in f32 and the port's in
  Python floats, and the two frameworks round the moment updates in
  their own order, so the parameters drift apart by a few ulps a step.
* The copied ``ReduceOnPlateauState`` passes through the same states as
  the JAX one on a scripted loss sequence.
* ``compute_losses`` equals the JAX one (rtol 1e-6) on a padded batch
  with masked pairs and a segment with no real pair, for the unfused and
  the fused classifier.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tspn_tpu.config import get_default_config
from tspn_tpu.models.tspn import TSPNModel as JaxTSPNModel
from tspn_tpu.parallel import train_step as jstep
from tspn_tpu.solver import optim as joptim
from tspn_tpu_torch.models.tspn import build_model
from tspn_tpu_torch.parallel.train_step import compute_losses
from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax
from tspn_tpu_torch.solver import optim as toptim

STEPS = 7


def _cfg(opt, sched):
    cfg = get_default_config()
    cfg.merge_from_dict({"SOLVER": {
        "BASE_LR": 0.05, "BIAS_LR_FACTOR": 2, "WEIGHT_DECAY": 5e-4,
        "WEIGHT_DECAY_BIAS": 1e-3, "OPTIMIZER": {"TYPE": opt, "MOMENTUM": 0.9},
        "SCHEDULER": {"TYPE": sched, "MILESTONES": [3, 5], "GAMMA": 0.5,
                      "WARMUP_ITERS": 3, "WARMUP_FACTOR": 0.25},
    }})
    return cfg


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("sched", ["warmup_multi", "multi"])
def test_build_optimizer_matches_optax(opt, sched):
    cfg = _cfg(opt, sched)
    rng = np.random.RandomState(0)
    init = {"kernel": rng.randn(6, 4).astype(np.float32),
            "bias": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in init.items()} for _ in range(STEPS)]

    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx, _schedule = joptim.build_optimizer(cfg, jparams)
    state = tx.init(jparams)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    optimizer, scheduler = toptim.build_optimizer(cfg.SOLVER, module)

    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        scheduler.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=2e-6, err_msg=k)


def test_schedule_factors_match_jax():
    cfg = _cfg("adam", "warmup_multi")
    s = cfg.SOLVER.SCHEDULER
    jsched = joptim.warmup_multistep_schedule(
        1.0, s.MILESTONES, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD)
    tsched = toptim.lr_factor(cfg.SOLVER)
    for t in range(8):
        np.testing.assert_allclose(tsched(t), float(jsched(t)), rtol=1e-6)
    const = toptim.warmup_multistep_factor([4], 0.1, 0.5, 2, "constant")
    jconst = joptim.warmup_multistep_schedule(1.0, [4], 0.1, 0.5, 2, "constant")
    for t in range(6):
        np.testing.assert_allclose(const(t), float(jconst(t)), rtol=1e-6)


def test_plateau_state_matches_jax():
    losses = [1.0, 0.9, 0.9, 0.95, 0.91, 0.9, 0.92, 0.5, 0.6, 0.7, 0.8, 0.9,
              0.49, 0.5, 0.5, 0.5]
    kw = dict(patience=2, cooldown=1, factor=0.5, min_scale=0.2)
    jstate, tstate = joptim.ReduceOnPlateauState(**kw), toptim.ReduceOnPlateauState(**kw)
    scales = []
    for v in losses:
        jstate, tstate = jstate.update(v), tstate.update(v)
        assert tuple(tstate) == tuple(jstate)
        scales.append(tstate.lr_scale)
    assert min(scales) < 1.0  # the script does reduce the scale


@pytest.mark.parametrize("fused", [False, True])
def test_compute_losses_matches_jax(fused):
    rng = np.random.RandomState(1)
    b, p, r = 3, 6, 5
    jmodel = JaxTSPNModel(num_predicates=r, use_ppn=False, use_dpn=False,
                          fused_classifier=fused)
    d = 11264 if fused else 11070
    feats = rng.rand(b, p, d).astype(np.float32) * (rng.rand(b, p, d) < 0.1)
    mask = np.ones((b, p), np.float32)
    mask[0, 4:] = 0
    mask[2] = 0  # a segment with no real pair
    feats[mask == 0] = 0
    labels = (rng.rand(b, p, r) < 0.3).astype(np.float32) * mask[..., None]
    batch = {"feats": feats, "labels": labels, "pair_mask": mask}
    params = jmodel.init(jax.random.PRNGKey(2), {"feats": feats})["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = jstep.compute_losses(jmodel, params, {k: jnp.asarray(v) for k, v in batch.items()})

    port = build_model(num_predicates=r, feature_dim=d, fused_classifier=fused)
    port.load_state_dict(state_dict_from_jax(params))
    out = compute_losses(port, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(out) == set(ref) == {"loss_rel"}
    np.testing.assert_allclose(float(out["loss_rel"].detach()), float(ref["loss_rel"]),
                               rtol=1e-6)


def test_plateau_scale_multiplies_the_update():
    """lr_scale multiplies one update and leaves the schedule as it was."""
    from tspn_tpu_torch.parallel.train_step import train_step

    solver = get_default_config().SOLVER
    solver.SCHEDULER.TYPE = "plateau"
    rng = np.random.RandomState(3)
    feats = rng.rand(1, 4, 20).astype(np.float32)
    batch = {"feats": torch.from_numpy(feats),
             "labels": torch.from_numpy((rng.rand(1, 4, 3) < 0.5).astype(np.float32)),
             "pair_mask": torch.ones(1, 4)}
    deltas = []
    for scale in (None, 0.5):
        model = build_model(num_predicates=3, feature_dim=20, seed=0)
        before = model.classifier.rel_predictor.weight.detach().clone()
        optimizer, scheduler = toptim.build_optimizer(solver, model)
        train_step(model, optimizer, scheduler, batch, lr_scale=scale)
        deltas.append(model.classifier.rel_predictor.weight.detach() - before)
        assert optimizer.param_groups[0]["lr"] == solver.BASE_LR
    torch.testing.assert_close(deltas[1], deltas[0] * 0.5, rtol=1e-5, atol=1e-9)


def test_unknown_solver_settings_raise():
    ns = types.SimpleNamespace
    model = build_model(num_predicates=3, feature_dim=20)
    solver = get_default_config().SOLVER
    solver.OPTIMIZER.TYPE = "rmsprop"
    with pytest.raises(ValueError):
        toptim.build_optimizer(solver, model)
    with pytest.raises(ValueError):
        toptim.lr_factor(ns(SCHEDULER=ns(TYPE="cosine")))
    with pytest.raises(ValueError):
        toptim.warmup_multistep_factor([1], warmup_method="exp")
