"""The bf16 relation model (``MODEL.DTYPE: bfloat16``) of the port against
the JAX package, on the CPU.

* K3's bf16 half: ``normalize_classify_fused_bf16_plain`` (what the CUDA
  kernel is held to on the card) against ``normalize_classify_pallas`` on
  bf16 rows, run in interpret mode on the CPU, at P 16 and a ragged P,
  with all-zero BoW blocks and zero rows. Tolerance ``1e-5 * T + 2**-8 *
  M`` (T the summed |terms| of an output, M its largest |term|): the two
  sum |x| and the product in other orders, so a normalized value near a
  bf16 rounding midpoint may round one ulp apart; at most 0.1% of the
  outputs may need the second term.
* Both autograd Functions against ``jax.grad`` of
  ``normalize_classify_fused`` and ``normalize_classify_fused_nofeatgrad``
  with bf16 rows and W and an f32 bias: dW comes back in bf16 and db in
  f32, as in JAX, within one bf16 ulp (2**-7 relative: f32 sums in two
  orders can round to neighbouring bf16 values) plus 1e-6.
* Unfused and fused bf16 models, each with the PPN head, against the JAX
  ``TSPNModel(dtype=bfloat16)`` with the weights carried across by
  ``state_dict_from_jax``. On the CPU the JAX fused model takes its XLA
  branch, which sums and divides the BoW blocks in bf16, where the port
  (like the TPU kernel) sums in f32: logits agree within ``2**-6 * T +
  1e-6`` (about four bf16 ulps of the summed terms).
* Six bf16 training steps (unfused and fused, from the same carried-across
  init) against the JAX ``train``, that is ``compute_losses`` plus Adam:
  step 1 losses within rtol 2e-3, every step within rtol 1e-2, and the
  loss falls.
* The loader's bf16 feature leaves equal, bit for bit, the JAX loader's
  ``ml_dtypes.bfloat16`` leaves (ml_dtypes from the JAX install).
* bf16 serving: ``predict_segments`` of the port and of the JAX package
  on the same bf16 models select the same entries apart from near-ties.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tspn_tpu.data import feature_store as jfs
from tspn_tpu.data.loader import BucketedLoader as JaxLoader
from tspn_tpu.data.segments import get_output_dir
from tspn_tpu.models.tspn import TSPNModel as JaxTSPNModel
from tspn_tpu.ops import pairwise as jpw
from tspn_tpu.runtime import predict as jpred
from tspn_tpu.runtime import train as jtrain
from tspn_tpu_torch.data import segments as tseg
from tspn_tpu_torch.data.layout import FeatureLayout
from tspn_tpu_torch.data.loader import BucketedLoader
from tspn_tpu_torch.data.synthetic import synthetic_segments
from tspn_tpu_torch.data.vrdataset import SegmentDataset
from tspn_tpu_torch.models.tspn import build_model, build_model_from_config
from tspn_tpu_torch.ops import pairwise as tpw
from tspn_tpu_torch.runtime import predict as tpred
from tspn_tpu_torch.runtime import train as ttrain
from tspn_tpu_torch.runtime.checkpoint import state_dict_from_jax

R, C, DIM = 12, 35, 11070
BF16 = torch.bfloat16


def _rows(p, seed):
    """Raw device-layout rows (C 35): a normal head, sparse BoW counts,
    row 0 with an all-zero block 0, row 1 with every block zero, and the
    last two rows zero (batch padding)."""
    rng = np.random.RandomState(seed)
    lo = FeatureLayout()
    x = np.zeros((p, lo.device_dim), np.float32)
    x[:, : lo.dev_head_dim] = rng.randn(p, lo.dev_head_dim)
    for k in range(lo.num_bow_blocks):
        s = lo.dev_head_pad + k * lo.dev_block
        x[:, s : s + lo.bow_block_size] = (
            rng.randint(1, 6, (p, lo.bow_block_size)) * (rng.rand(p, lo.bow_block_size) < 0.1))
    x[0, lo.dev_head_pad : lo.dev_head_pad + lo.dev_block] = 0
    x[1, lo.dev_head_pad :] = 0
    x[-2:] = 0
    w = (rng.randn(lo.device_dim, R) * 0.01).astype(np.float32)
    b = rng.randn(R).astype(np.float32)
    return x, w, b


def _terms(x_bf16, w_t, layout):
    """(T, M) of the plain version's product: the summed and the largest
    |term| of each output, in float64."""
    p = x_bf16.shape[0]
    hp, nb, blk = layout.dev_head_pad, layout.num_bow_blocks, layout.dev_block
    bow = x_bf16[:, hp:].float().reshape(p, nb, blk)
    s = bow.abs().sum(-1, keepdim=True)
    n = (bow / torch.where(s > 0, s, torch.ones_like(s))).to(BF16).reshape(p, -1)
    xn = torch.cat([x_bf16[:, :hp], n], 1).double().abs()
    wa = w_t.double().abs().T
    return (xn @ wa).numpy(), (xn[:, :, None] * wa[None]).amax(1).numpy()


@pytest.mark.parametrize("p", [16, 37])
def test_k3_bf16_plain_matches_pallas(p):
    x, w, b = _rows(p, seed=p)
    lo = FeatureLayout()
    xb = torch.from_numpy(x).to(BF16)
    w_t = tpw.weights_bf16_t(w)
    out = tpw.normalize_classify_fused_bf16_plain(xb, w_t, torch.from_numpy(b), lo)
    assert out.dtype == torch.float32 and out.shape == (p, R)
    # the dispatcher on a CPU tensor: W cast to bf16 as the TPU kernel casts it
    disp = tpw.normalize_classify_fused_forward(xb, torch.from_numpy(w), torch.from_numpy(b), lo)
    assert torch.equal(disp, out) and not any(tpw.LAUNCHES.values())
    ref = np.asarray(jpw.normalize_classify_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        layout=jfs.FeatureLayout()))
    t, m = _terms(xb, w_t, lo)
    t = t + np.abs(b)
    err = np.abs(out.numpy().astype(np.float64) - ref)
    assert (err <= 1e-5 * t + 2.0 ** -8 * m).all(), float((err / (1e-5 * t + 2.0 ** -8 * m)).max())
    assert (err > 1e-5 * t).mean() <= 1e-3
    np.testing.assert_array_equal(out[-2:].numpy(), np.broadcast_to(b, (2, R)))


def _jax_grads(fn, x, w, b, g):
    def loss(x, w, b):
        return jnp.sum(fn(x, w, b, layout=jfs.FeatureLayout()) * g)

    args = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
            jnp.asarray(b))
    return [np.asarray(a.astype(jnp.float32)) for a in jax.grad(loss, (0, 1, 2))(*args)], args


@pytest.mark.parametrize("op", ["general", "nofeatgrad"])
def test_fused_bf16_grads_match_jax(op):
    x, w, b = _rows(8, seed=3)
    g = np.random.RandomState(4).randn(8, R).astype(np.float32)
    jfn = jpw.normalize_classify_fused if op == "general" else jpw.normalize_classify_fused_nofeatgrad
    tfn = tpw.normalize_classify_fused if op == "general" else tpw.normalize_classify_fused_nofeatgrad
    ref, _ = _jax_grads(jfn, x, w, b, g)
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    wt = torch.from_numpy(w).to(BF16).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    (tfn(xt, wt, bt, FeatureLayout()) * torch.from_numpy(g)).sum().backward()
    assert (xt.grad.dtype, wt.grad.dtype, bt.grad.dtype) == (BF16, BF16, torch.float32)
    out = [t.grad.float().numpy() for t in (xt, wt, bt)]
    for name, a, o in zip(("dx", "dw", "db"), ref, out):
        np.testing.assert_allclose(o, a, rtol=2.0 ** -7, atol=1e-6, err_msg=name)
    if op == "nofeatgrad":
        assert float(np.abs(out[0]).max()) == 0.0 == float(np.abs(ref[0]).max())
    else:
        assert np.abs(out[0]).max() > 0.0


def _jax_and_port_models(fused, seed, n=6):
    jm = JaxTSPNModel(num_predicates=R, use_ppn=True, use_dpn=False,
                      fused_classifier=fused, dtype=jnp.bfloat16)
    width = FeatureLayout().device_dim if fused else DIM
    example = {"feats": np.zeros((1, 2, width), np.float32),
               "cls_logits": np.zeros((1, n, C), np.float32)}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), example)["params"])
    port = build_model(R, DIM, use_ppn=True, fused_classifier=fused, dtype=BF16)
    port.load_state_dict(state_dict_from_jax(params))
    assert all(v.dtype == torch.float32 for v in port.state_dict().values())
    return jm, params, port


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_model_matches_jax(fused):
    jm, params, port = _jax_and_port_models(fused, seed=5)
    rng = np.random.RandomState(6)
    if fused:
        x = _rows(2 * 30, seed=7)[0].reshape(2, 30, -1)
    else:
        x = rng.rand(2, 30, DIM).astype(np.float32) * (rng.rand(2, 30, DIM) < 0.1)
    cls = (rng.randn(2, 6, C) * 2).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)  # the JAX loader's leaves
    ref = jm.apply({"params": params}, {"feats": jnp.asarray(xb), "cls_logits": jnp.asarray(cls)})
    out = port({"feats": torch.from_numpy(x).to(BF16), "cls_logits": torch.from_numpy(cls)})
    # unfused: nn.Dense(dtype=bf16) -> bf16 logits; fused: f32 logits
    assert out["rel_logits"].dtype == (torch.float32 if fused else BF16)
    assert out["pair_logits"].dtype == torch.float32
    assert ref["rel_logits"].dtype == jnp.dtype(jnp.float32 if fused else jnp.bfloat16)
    flat = torch.from_numpy(x.reshape(-1, x.shape[-1])).to(BF16)
    if fused:
        w = port.classifier.kernel.detach()
        xn = tpw._normalize_device_layout(flat.double(), FeatureLayout())
    else:
        w = port.classifier.rel_predictor.weight.detach().T
        xn = flat.double()
    t = (xn.abs() @ w.double().abs()).numpy().reshape(2, 30, R)
    got = out["rel_logits"].float().detach().numpy()
    err = np.abs(got - np.asarray(ref["rel_logits"].astype(jnp.float32)))
    assert (err <= 2.0 ** -6 * t + 1e-6).all(), float(err.max())
    np.testing.assert_allclose(out["pair_logits"].detach().numpy(),
                               np.asarray(ref["pair_logits"]), rtol=2.0 ** -6, atol=1e-3)


def test_bf16_loader_leaves_equal_ml_dtypes():
    ds = synthetic_segments(7, "f32dev", seed=4, max_tracklets=10, num_predicates=R)
    width = ds.feature_width()
    kw = dict(max_iter=5, shuffle=True, seed=3)
    # buckets up to 8 of segments up to 10 tracklets: some records are cut
    ref = list(JaxLoader(ds, (4, 8), 2, width, R, C, include_records=True,
                         feats_dtype=ml_dtypes.bfloat16, **kw))
    out = list(BucketedLoader(ds, (4, 8), 2, width, C, include_labels=True,
                              feats_dtype=BF16, **kw))
    assert len(out) == len(ref) == 5
    for (_b0, batch0, _i0, _r0), (_b1, batch1, _i1, _r1) in zip(ref, out):
        assert set(batch0) == set(batch1)
        feats = batch1["feats"]
        assert batch0["feats"].dtype == ml_dtypes.bfloat16 and feats.dtype == BF16
        np.testing.assert_array_equal(feats.view(torch.int16).numpy(),
                                      batch0["feats"].view(np.int16))
        for k in set(batch0) - {"feats"}:
            np.testing.assert_array_equal(batch0[k], batch1[k], err_msg=k)


# ------------------------------------------------------------ the slice
@pytest.fixture
def port_dataset(synthetic_dataset):
    """The synthetic set, with the port's artifact root where the JAX
    package's points."""
    tseg.set_output_dir(get_output_dir())
    return synthetic_dataset


def _bf16_cfg(cfg, dataset, name, fused):
    cfg = cfg.clone()
    cfg.merge_from_dict({
        "MODEL": {"NAME": name, "FUSED_CLASSIFIER": fused, "DTYPE": "bfloat16"},
        "PREDICT": {"PREDICATE_NUM": dataset.get_predicate_num()},
        "RELPN": {"USE_PPN": False, "USE_DPN": False},
        "SOLVER": {"MAX_ITER": 6,
                   "SCHEDULER": {"MILESTONES": [3, 5], "WARMUP_ITERS": 2}},
        "ETC": {"SAVE_FREQ": 100, "DISPLAY_FREQ": 100},
        "BUCKETS": {"SEGMENTS_PER_STEP": 2},
        "MESH": {"NUM_DEVICES": 1},
    })
    return cfg


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_train_matches_jax(fused, cfg, port_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jcfg = _bf16_cfg(cfg, port_dataset, f"bf16_parity_jax_{int(fused)}", fused)
    tcfg = _bf16_cfg(cfg, port_dataset, f"bf16_parity_port_{int(fused)}", fused)
    jax_losses = []
    make_step = jtrain.make_train_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, *rest):
            assert batch["feats"].dtype == jnp.bfloat16
            state, metrics = step(state, batch, *rest)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(jtrain, "make_train_step", recording_step)
    jtrain.train(jcfg, port_dataset)
    model = jtrain.build_model(jcfg)
    init = model.init(
        jax.random.PRNGKey(jcfg.ETC.RANDOM_SEED),
        jtrain._example_batch(min(jcfg.BUCKETS.NUM_TRACKLETS), 1, jcfg),
    )["params"]
    init = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, init))
    result = ttrain.train(tcfg, port_dataset, "cpu", init_state_dict=init)

    assert result.model.compute_dtype == BF16
    assert all(v.dtype == torch.float32 for v in result.model.state_dict().values())
    assert len(jax_losses) == len(result.losses) == 6
    np.testing.assert_allclose(result.losses[0], jax_losses[0], rtol=2e-3)
    np.testing.assert_allclose(result.losses, jax_losses, rtol=1e-2)
    assert result.losses[-1] < result.losses[0]


def _selection(preds, tol):
    """-> (scores sorted high to low, entries scored above the last one
    selected by more than tol)."""
    scores = np.array([float(s) for s, _t, _i in preds])
    last = scores.min() if scores.size else 0.0
    above = {(tuple(int(x) for x in i), int(t[1]))
             for s, t, i in preds if float(s) > last + tol}
    return np.sort(scores)[::-1], above


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_predict_matches_jax(fused, cfg, port_dataset):
    """Serving the same bf16 model: every segment's sorted scores within
    2**-7 (bf16 logits through a sigmoid) and the same entries above the
    last selected score plus that tie width."""
    from tspn_tpu.models.tspn import build_model as jax_build_model

    tcfg = _bf16_cfg(cfg, port_dataset, "bf16_serve", fused)
    tcfg.DATASET.TEST_BATCH_SIZE = 4
    jm = jax_build_model(tcfg, inference=True)
    bucket = min(tcfg.BUCKETS.NUM_TRACKLETS)
    width = FeatureLayout().device_dim if fused else tcfg.PREDICT.FEATURE_DIM
    example = {"feats": np.zeros((1, bucket * (bucket - 1), width), np.float32),
               "cls_logits": np.zeros((1, bucket, C), np.float32)}
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(9), example)["params"])
    # an informative classifier: scale the init so scores spread
    params = jax.tree_util.tree_map(lambda a: a * 50.0, params)
    port = build_model_from_config(tcfg, inference=True)
    port.load_state_dict(state_dict_from_jax(params))
    ds = SegmentDataset(tcfg, port_dataset, phase="test")
    ref = jpred.predict_segments(tcfg, jm, params, ds)
    out = tpred.predict_segments(
        port.eval(), ds, device="cpu", buckets=tcfg.BUCKETS.NUM_TRACKLETS,
        batch_size=tcfg.DATASET.TEST_BATCH_SIZE, topk_per_pair=tcfg.PREDICT.TOPK_PER_PAIR,
        topk_per_seg=tcfg.PREDICT.TOPK_PER_SEG, num_objects=C, feature_dim=width,
    )
    assert set(out) == set(ref) and ref
    tol = 2.0 ** -7
    for key in ref:
        s_ref, above_ref = _selection(ref[key][0], tol)
        s_out, above_out = _selection(out[key][0], tol)
        assert s_out.shape == s_ref.shape
        np.testing.assert_allclose(s_out, s_ref, rtol=0, atol=tol)
        assert above_out == above_ref, key
