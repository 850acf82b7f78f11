"""The port's detector training (tspn_tpu_torch.detection.{rpn,rcnn,train},
the K7 backward's plain version, the native checkpoint, the copied host
code and the CLI) held against the JAX package on the CPU.

* Anchor matching, the balanced sampler and the RPN loss: equal to JAX's
  on the same inputs, ties included (a stable sort on the same key, the
  first maximum), image by image against JAX's one-image functions.
* The training forward and three SGD steps: TINY of
  tests/test_torch_detection.py (depth 26, 3 classes) on two 64 x 96
  images a batch with 1-3 boxes each, JAX's init carried across; step-1
  losses within rtol 1e-5 (convolutions sum in another order), every
  step's losses within rtol 1e-4 and the parameters after three steps
  within atol 1e-4 of ``make_detector_train_step``'s.
* The optimizer: the schedule within 1e-6 relative of optax's (which
  computes in f32), and four SGD updates of a toy tree within 1e-6 of the
  optax chain's.
* RoIAlign's plain backward: autograd of ``roi_align_plain`` against
  ``jax.grad`` of ``roi_align_separable`` and of ``roi_align_xla`` within
  1e-5 * T + 1e-6, T the backward of |dOut| (another summation order).
* ``make_batch``, ``group_by_orientation``, the vocabularies and the COCO
  conversion: exactly equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tspn_tpu.detection import rpn as jrpn
from tspn_tpu.detection import train as jtrain
from tspn_tpu.detection.rcnn import FasterRCNN as JaxRCNN
from tspn_tpu.ops import roi_align as jra
from tspn_tpu_torch.detection import inputs as tinputs
from tspn_tpu_torch.detection import rpn as trpn
from tspn_tpu_torch.detection import train as ttrain
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.ops import roi_align as tra
from tspn_tpu_torch.runtime import checkpoint as tckpt

from test_torch_detection import TINY, jax_model, image  # noqa: F401
from test_torch_roi_align import BOXES, GEOMETRIES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
STEPS = 3


def _scene_batch(rng, n=2, g=4):
    """n noise images with 1-3 flat boxes each (random classes), padded to g."""
    imgs = (rng.rand(n, H, W, 3) * 0.3).astype(np.float32)
    gb = np.zeros((n, g, 4), np.float32)
    gc = np.zeros((n, g), np.int32)
    gm = np.zeros((n, g), np.float32)
    for i in range(n):
        for j in range(rng.randint(1, 4)):
            x0, y0 = rng.randint(0, W - 24), rng.randint(0, H - 20)
            x1, y1 = min(x0 + rng.randint(12, 40), W), min(y0 + rng.randint(10, 30), H)
            imgs[i, y0:y1, x0:x1] = rng.rand(3)
            gb[i, j] = [x0, y0, x1, y1]
            gc[i, j] = rng.randint(0, TINY.num_classes)
            gm[i, j] = 1.0
    return {"image": imgs, "gt_boxes": gb, "gt_classes": gc, "gt_mask": gm}


# ------------------------------------------------------------ RPN targets
def _targets_case(name):
    rng = np.random.RandomState(len(name))
    anchors = np.asarray(jrpn.make_anchors(4, 6, 16, (32, 64), (0.5, 1.0, 2.0)))
    gt = np.zeros((2, 5, 4), np.float32)
    mask = np.zeros((2, 5), np.float32)
    gt[:, :3] = anchors[rng.choice(len(anchors), (2, 3))] + rng.randn(2, 3, 4) * 4
    mask[:, :3] = 1.0
    if name == "ties":  # a GT twice and a GT on an anchor exactly: equal IoUs
        gt[:, 3] = gt[:, 0]
        gt[0, 4] = anchors[7]
        mask[:, 3:] = 1.0
    elif name == "empty":  # the second image has no GT at all
        mask[1] = 0.0
    return anchors.astype(np.float32), gt.astype(np.float32), mask


@pytest.mark.parametrize("name", ["plain", "ties", "empty"])
def test_match_anchors_to_gt_matches_jax(name):
    anchors, gt, mask = _targets_case(name)
    ours = trpn.match_anchors_to_gt(torch.from_numpy(anchors), torch.from_numpy(gt),
                                    torch.from_numpy(mask))
    for b in range(2):
        ref = jrpn.match_anchors_to_gt(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                       jnp.asarray(mask[b]))
        np.testing.assert_array_equal(ours.labels[b].numpy(), np.asarray(ref.labels))
        np.testing.assert_array_equal(ours.matched_gt[b].numpy(), np.asarray(ref.matched_gt))
    assert (ours.labels == 1).any() and (ours.labels == 0).any()


@pytest.mark.parametrize("priority", [None, "spread", "ties"])
@pytest.mark.parametrize("batch_size", [8, 40])
def test_sample_targets_matches_jax(priority, batch_size):
    rng = np.random.RandomState(batch_size)
    labels = rng.choice([-1.0, 0.0, 1.0], (3, 60), p=[0.2, 0.6, 0.2]).astype(np.float32)
    prio = None
    if priority is not None:
        prio = rng.randn(3, 60).astype(np.float32)
        if priority == "ties":  # few distinct values: the order is by index
            prio = np.round(prio)
    ours = trpn.sample_targets(torch.from_numpy(labels), batch_size, 0.25,
                               None if prio is None else torch.from_numpy(prio))
    assert ours.dtype == torch.float32
    for b in range(3):
        ref = jrpn.sample_targets(jnp.asarray(labels[b]), batch_size, 0.25,
                                  None if prio is None else jnp.asarray(prio[b]))
        np.testing.assert_array_equal(ours[b].numpy(), np.asarray(ref))


def test_rpn_loss_matches_jax():
    anchors, gt, mask = _targets_case("ties")
    rng = np.random.RandomState(3)
    logits = np.round(rng.randn(2, len(anchors)), 1).astype(np.float32)  # hardness ties
    deltas = (rng.randn(2, len(anchors), 4) * 0.2).astype(np.float32)
    targets = trpn.match_anchors_to_gt(torch.from_numpy(anchors), torch.from_numpy(gt),
                                       torch.from_numpy(mask))
    lt = torch.from_numpy(logits).requires_grad_(True)
    obj, box = trpn.rpn_loss(lt, torch.from_numpy(deltas), torch.from_numpy(anchors),
                             targets, 16, 0.5)
    for b in range(2):
        ref_t = jrpn.match_anchors_to_gt(jnp.asarray(anchors), jnp.asarray(gt[b]),
                                         jnp.asarray(mask[b]))
        ref = jrpn.rpn_loss(jnp.asarray(logits[b]), jnp.asarray(deltas[b]),
                            jnp.asarray(anchors), ref_t, 16, 0.5)
        np.testing.assert_allclose(obj[b].item(), float(ref[0]), rtol=1e-6)
        np.testing.assert_allclose(box[b].item(), float(ref[1]), rtol=1e-6)
    obj.sum().backward()  # the sample itself carries no gradient
    assert torch.isfinite(lt.grad).all()


# --------------------------------------------------- forward and SGD steps
@pytest.fixture(scope="module")
def train_runs(jax_model):  # noqa: F811
    """Three SGD steps from JAX's init, through make_detector_train_step and
    through the port's train step -> (JAX losses, port losses, JAX params,
    port state dict, the starting params)."""
    rng = np.random.RandomState(0)
    batches = [_scene_batch(rng) for _ in range(STEPS)]
    jcfg = jtrain.DetectorTrainConfig(base_lr=0.02, warmup_iters=2)
    tcfg = tinputs.DetectorTrainConfig(base_lr=0.02, warmup_iters=2)
    model, params = jax_model
    jmodel = JaxRCNN(cfg=TINY)
    opt = jtrain.build_detector_optimizer(jcfg)
    step = jtrain.make_detector_train_step(jmodel, opt)
    p = jax.tree_util.tree_map(jnp.array, params)
    state = opt.init(p)
    jax_losses = []
    for b in batches:
        p, state, losses = step(p, state, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append({k: float(v) for k, v in losses.items()})

    port = FasterRCNN(DetectionConfig(**TINY._asdict()))
    port.load_state_dict(tckpt.detector_state_dict_from_jax(params))
    optimizer, scheduler = ttrain.build_detector_optimizer(port.parameters(), tcfg)
    port_losses = []
    for b in batches:
        out = ttrain.detector_train_step(port, optimizer, scheduler,
                                         ttrain.batch_to_device(b, "cpu"))
        port_losses.append({k: float(v) for k, v in out.items()})
    return (jax_losses, port_losses, jax.tree_util.tree_map(np.asarray, p),
            port.state_dict(), params)


def test_training_forward_losses_match_jax(train_runs):
    jax_losses, port_losses = train_runs[:2]
    assert set(port_losses[0]) == set(jax_losses[0]) == {
        "loss", "loss_rpn_obj", "loss_rpn_box", "loss_cls", "loss_box"}
    for k, v in jax_losses[0].items():
        assert v > 0
        np.testing.assert_allclose(port_losses[0][k], v, rtol=1e-5, err_msg=k)


def test_sgd_steps_match_jax(train_runs):
    jax_losses, port_losses, jax_params, state_dict, start = train_runs
    for j, t in zip(jax_losses, port_losses):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    want = tckpt.detector_state_dict_from_jax(jax_params)
    for k, v in state_dict.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-4, msg=k)
    start = tckpt.detector_state_dict_from_jax(start)
    moved = max(float((state_dict[k] - start[k]).abs().max()) for k in start)
    assert moved > 1e-2  # the steps moved the parameters far beyond the tolerance


@pytest.mark.parametrize("warmup", [0, 3])
def test_optimizer_matches_optax(warmup):
    jcfg = jtrain.DetectorTrainConfig(base_lr=0.1, warmup_iters=warmup, weight_decay=0.01)
    tcfg = tinputs.DetectorTrainConfig(base_lr=0.1, warmup_iters=warmup, weight_decay=0.01)
    schedule = optax.join_schedules(
        [optax.linear_schedule(jcfg.base_lr / 3, jcfg.base_lr, jcfg.warmup_iters),
         optax.constant_schedule(jcfg.base_lr)], [jcfg.warmup_iters])
    for step in range(6):
        np.testing.assert_allclose(ttrain.learning_rate(step, tcfg), float(schedule(step)),
                                   rtol=1e-6)
    rng = np.random.RandomState(warmup)
    p0 = {"w": rng.randn(5, 3).astype(np.float32), "scale": rng.rand(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    opt = jtrain.build_detector_optimizer(jcfg)
    p = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(p)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    optimizer, scheduler = ttrain.build_detector_optimizer(list(params.values()), tcfg)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, updates)
        for k, t in params.items():
            t.grad = torch.from_numpy(g[k])
        optimizer.step()
        scheduler.step()
    for k, t in params.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- RoIAlign backward
def _grad_close(ours, ref, terms):
    bound = 1e-5 * np.abs(terms) + 1e-6
    assert (np.abs(ours - ref) <= bound).all(), float(np.abs(ours - ref).max())


@pytest.mark.parametrize("out,s", GEOMETRIES)
def test_plain_backward_matches_jax_grad(out, s):
    rng = np.random.RandomState(out + s)
    feat = rng.rand(20, 24, 8).astype(np.float32)
    cot = (rng.rand(len(BOXES), out, out, 8) * 2 - 1).astype(np.float32)

    def port_grad(c):
        f = torch.from_numpy(feat).requires_grad_(True)
        tra.roi_align(f, torch.from_numpy(BOXES), None, out, s).backward(torch.from_numpy(c))
        return f.grad.numpy()

    ours, terms = port_grad(cot), port_grad(np.abs(cot))
    # the backward's CPU dispatch is the vjp of the plain version
    direct = tra.roi_align_backward(torch.from_numpy(cot), torch.from_numpy(BOXES),
                                    torch.zeros(len(BOXES), dtype=torch.int32),
                                    (1, *feat.shape), torch.float32, out, s)
    _grad_close(direct[0].numpy(), ours, terms)
    for fn in (jra.roi_align_separable, jra.roi_align_xla):
        ref = jax.grad(lambda f: jnp.sum(fn(f, jnp.asarray(BOXES), out, s) * cot))(
            jnp.asarray(feat))
        _grad_close(ours, np.asarray(ref), terms)


# --------------------------------------------------- host code and the loop
def _records(rng, shapes):
    recs = []
    for i, (h, w) in enumerate(shapes):
        boxes = [[w * 0.1, h * 0.2, w * 0.6, h * 0.7], [w * 0.5, h * 0.1, w * 0.9, h * 0.4]]
        recs.append({"image": (rng.rand(h, w, 3) * 255).astype(np.uint8), "image_id": i,
                     "height": h, "width": w,
                     "annotations": [{"bbox": b, "category_id": int(rng.randint(0, 3)),
                                      "bbox_mode": "XYXY_ABS"} for b in boxes]})
    return recs


@pytest.mark.parametrize("policy", ["letterbox", "shortest_edge"])
def test_make_batch_and_group_by_orientation_equal(policy):
    rng = np.random.RandomState(5)
    recs = _records(rng, [(40, 70), (72, 50), (36, 60), (64, 48)])
    kw = dict(input_policy=policy, image_size=64, min_size=40, max_size=72, max_gt_boxes=3)
    jcfg, tcfg = jtrain.DetectorTrainConfig(**kw), tinputs.DetectorTrainConfig(**kw)
    assert tinputs.DetectorTrainConfig._fields == jtrain.DetectorTrainConfig._fields
    assert tinputs.DetectorTrainConfig() == tuple(jtrain.DetectorTrainConfig())
    groups = tinputs.group_by_orientation(recs, tcfg)
    ref_groups = jtrain.group_by_orientation(recs, jcfg)
    assert [g.tolist() for g in groups] == [g.tolist() for g in ref_groups]
    for g in groups:
        ours = tinputs.make_batch([recs[i] for i in g], tcfg)
        ref = jtrain.make_batch([recs[i] for i in g], jcfg)
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def _tiny_train_cfg(**kw):
    return tinputs.DetectorTrainConfig(
        ims_per_batch=2, base_lr=1e-3, max_iter=6, warmup_iters=2, image_size=96,
        max_gt_boxes=4, log_every=3, eval_every=3, keep_best=True, **kw)


TINY_TRAIN = DetectionConfig(num_classes=2, depth=26, anchor_sizes=(32, 64),
                             anchor_ratios=(1.0,), pre_nms_topk_train=100,
                             post_nms_topk_train=32, pre_nms_topk_test=100,
                             post_nms_topk_test=32, roi_batch_size=16, max_detections=8)


def _scene_record():
    img = np.zeros((96, 96, 3), np.float32)
    img[20:60, 10:50, 0] = 1.0
    return {"image": img, "height": 96, "width": 96, "image_id": 0,
            "annotations": [{"bbox": [10, 20, 50, 60], "category_id": 0,
                             "bbox_mode": "XYXY_ABS"}]}


def test_train_detector_eval_hook_and_best_checkpoint(tmp_path):
    """As tests/test_detector_input.py's test of the JAX trainer: the hook
    evaluates every 3 steps and keeps the best; the final checkpoint holds
    the parameters, SGD momentum, schedule and step, the ``_best`` sibling
    the best parameters, and both load into a detector that detects."""
    from tspn_tpu_torch.detection.eval import run_detector_eval

    rec = _scene_record()
    path = str(tmp_path / "detector.pt")
    model, history = ttrain.train_detector([rec], TINY_TRAIN, _tiny_train_cfg(), device="cpu",
                                           checkpoint_path=path, eval_records=[rec])
    assert [it for it, _ in history["eval"]] == [3, 6]
    assert len(history["losses"]) == 6 and len(history["step_seconds"]) == 6
    assert len(history["input_wait_s"]) == 6
    assert all(0.0 <= w <= s for w, s in zip(history["input_wait_s"], history["step_seconds"]))
    assert all(np.isfinite(v) for step in history["losses"] for v in step.values())
    best_it, best_map = max(history["eval"], key=lambda e: (e[1], -e[0]))
    final = tckpt.load_checkpoint(path)
    assert final["step"] == 6 and final["native"]
    momentum = final["optimizer"]["state"]
    assert len(momentum) == len(list(model.parameters()))
    assert all("momentum_buffer" in v for v in momentum.values())
    assert final["scheduler"]["last_epoch"] == 6
    best = tckpt.load_checkpoint(str(tmp_path / "detector_best.pt"))
    assert best["step"] == best_it and best["optimizer"] is None
    for k, v in model.state_dict().items():  # the returned model holds the best
        assert torch.equal(best["state_dict"][k], v), k
    fresh = FasterRCNN(TINY_TRAIN).eval()
    fresh.load_state_dict(tckpt.load_detector_checkpoint(str(tmp_path / "detector_best.pt")))
    mean_ap, _ = run_detector_eval(fresh, [rec], device="cpu", train_cfg=_tiny_train_cfg())
    assert mean_ap == pytest.approx(best_map)
    # the hook off: plain training, no best sibling
    _, history = ttrain.train_detector([rec], TINY_TRAIN, _tiny_train_cfg()._replace(
        eval_every=0, max_iter=2), device="cpu")
    assert history["eval"] == [] and len(history["losses"]) == 2


@pytest.mark.parametrize("policy,bf16", [("letterbox", True), ("shortest_edge", False)])
def test_train_detector_runs_bf16_and_shortest_edge(policy, bf16):
    """bf16 compute keeps f32 parameters; ResizeShortestEdge trains on its
    two orientation buckets (a landscape and a portrait record)."""
    recs = _records(np.random.RandomState(11), [(40, 70), (72, 50)])
    cfg = _tiny_train_cfg(mixed_precision=bf16, input_policy=policy, min_size=48,
                          max_size=80)._replace(max_iter=2, eval_every=0)
    model, history = ttrain.train_detector(recs, TINY_TRAIN, cfg, device="cpu")
    assert model.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(history["losses"]) == 2
    assert all(np.isfinite(v) for step in history["losses"] for v in step.values())


def test_batch_order_is_the_jax_trainers():
    """One RandomState(seed) draws the groups and images, as in JAX."""
    recs = _records(np.random.RandomState(9), [(40, 70), (72, 50), (36, 60)])
    cfg = tinputs.DetectorTrainConfig(input_policy="shortest_edge", min_size=40,
                                      max_size=72, ims_per_batch=2, max_iter=3)
    seen = []
    real = ttrain.make_batch
    try:
        ttrain.make_batch = lambda rs, c: seen.append([r["image_id"] for r in rs]) or \
            real(rs, c)
        ttrain.train_detector(recs, TINY_TRAIN, cfg._replace(max_iter=1), device="cpu")
    finally:
        ttrain.make_batch = real
    groups = jtrain.group_by_orientation(recs, jtrain.DetectorTrainConfig(**cfg._asdict()))
    rng = np.random.RandomState(0)
    weights = np.asarray([len(g) for g in groups], np.float64)
    group = groups[rng.choice(len(groups), p=weights / weights.sum())]
    want = group[rng.choice(len(group), size=2, replace=True)].tolist()
    assert seen[0] == want


def test_launch_runs_one_machine_and_refuses_more():
    assert ttrain.launch(lambda a: a + 1, args=(1,)) == 2
    with pytest.raises(NotImplementedError, match="queue 1"):
        ttrain.launch(lambda: None, num_machines=2, dist_url="tcp://localhost:1")


# ------------------------------------------------- copies and the CLI
def _write_dataset(root):
    """Two synthetic VidVRD videos of 3 frames (JAX's generator), with the
    frames written as JPEGs where the COCO records point."""
    from PIL import Image

    from tspn_tpu.data.synthetic import HEIGHT, WIDTH, generate_annotations

    generate_annotations(os.path.join(root, "vidvrd"), num_train=1, num_test=1,
                         frame_count=3, seed=3)
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        for path in os.listdir(os.path.join(root, "vidvrd", split)):
            vid = path[:-5]
            os.makedirs(os.path.join(root, "image", vid), exist_ok=True)
            for fid in range(3):
                arr = (rng.rand(HEIGHT, WIDTH, 3) * 255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(root, "image", vid, f"{fid + 1:05d}.jpg"))


def test_vocab_and_coco_format_copies_equal(tmp_path):
    from tspn_tpu.data import vocab as jvocab
    from tspn_tpu.detection import coco_format as jcoco
    from tspn_tpu_torch.data import vocab as tvocab
    from tspn_tpu_torch.detection import coco_format as tcoco

    for name in ("VIDVRD_OBJECTS", "VIDVRD_PREDICATES", "VIDOR_OBJECTS", "VIDOR_PREDICATES"):
        assert getattr(tvocab, name) == getattr(jvocab, name), name
    _write_dataset(str(tmp_path))
    root = str(tmp_path / "vidvrd")
    for split in ("train", "test"):
        ours = tcoco.vidvrd_to_coco_format(root, split, str(tmp_path / "image"))
        assert ours == jcoco.vidvrd_to_coco_format(root, split, str(tmp_path / "image"))
        assert ours and all(os.path.exists(r["file_name"]) for r in ours)
    tcoco.dump_coco_json(ours, str(tmp_path / "a.json"))
    jcoco.dump_coco_json(ours, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    with pytest.raises(AssertionError):
        tcoco.vidor_to_coco_format(root, "train")


def test_cli_trains_on_a_tiny_dataset(tmp_path):
    """``python -m tspn_tpu_torch.tools.train_detector`` at depth 26 on two
    synthetic videos, f32 and --bf16, evaluating on the test split; the
    checkpoint it writes reloads into a detector."""
    _write_dataset(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for extra in ([], ["--bf16"]):
        out = str(tmp_path / f"det{len(extra)}.pt")
        cmd = [sys.executable, "-m", "tspn_tpu_torch.tools.train_detector",
               "--data_dir", str(tmp_path), "--image_root", str(tmp_path / "image"),
               "--depth", "26", "--max_iter", "2", "--ims_per_batch", "1",
               "--image_size", "64", "--eval_split", "test", "--eval_every", "2",
               "--output", out, "--device", "cpu", *extra]
        proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "[eval @ 2] mAP" in proc.stdout
        sd = tckpt.load_detector_checkpoint(out)
        model = FasterRCNN(DetectionConfig(num_classes=35, depth=26))
        model.load_state_dict(sd)
    assert os.path.exists(str(tmp_path / "det1_best.pt"))


def _flags(path):
    with open(path) as f:
        return {a.split('"')[1] for a in f.read().split("add_argument(")[1:]}


def test_cli_needs_a_card_unless_told_otherwise(monkeypatch):
    """The JAX tool's flags plus ``--device``, which defaults to cuda and
    stops with a hint when there is no card, and ``--arch`` (the detector:
    R101-C4 by default, or X101-FPN)."""
    from tspn_tpu_torch.tools import train_detector as tool

    assert _flags(tool.__file__) - _flags(os.path.join(REPO, "tools", "train_detector.py")) \
        == {"--device", "--arch"}
    assert _flags(os.path.join(REPO, "tools", "train_detector.py")) <= _flags(tool.__file__)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tool.parse_args(["--data_dir", "x"])
    args = tool.parse_args(["--data_dir", "x", "--device", "cpu"])
    assert (args.device, args.dataset, args.ims_per_batch, args.arch) == (
        "cpu", "vidvrd", 4, "r-c4")
