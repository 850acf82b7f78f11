"""The port's detector inference (tspn_tpu_torch.detection) held against
the JAX package, stage by stage and end to end, on the CPU.

The model is TINY of tests/test_detection.py (depth 26, 3 classes) on an
80 x 128 image, so an H/W swap shows. JAX's own init is carried across
with detector_state_dict_from_jax; ``cls_score`` is redrawn at std 0.05
with a raised class-0 bias, so the score threshold keeps detections and
the scores spread.

Discrete stages (top-k, both NMS passes, the score cut) are fed the JAX
stage's input and must give the same indices; continuous stages agree
within 1e-4 of the output's magnitude (convolutions sum in another
order). End to end, detections match slot by slot, or, where a score
lies within 1e-5 of a neighbour's, by class, IoU > 0.99 and score.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.detection import eval as jeval
from tspn_tpu.detection import rpn as jrpn
from tspn_tpu.detection import train as jtrain
from tspn_tpu.detection.rcnn import DetectionConfig as JaxConfig
from tspn_tpu.detection.rcnn import FasterRCNN as JaxRCNN
from tspn_tpu.evaluation.common import voc_ap as jax_voc_ap
from tspn_tpu.ops import boxes as jboxes
from tspn_tpu.ops import nms as jnms
from tspn_tpu_torch.detection import eval as teval
from tspn_tpu_torch.detection import inputs as tinputs
from tspn_tpu_torch.detection import rpn as trpn
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.ops import boxes as tboxes
from tspn_tpu_torch.ops import nms as tnms
from tspn_tpu_torch.ops import roi_align as tra
from tspn_tpu_torch.runtime import checkpoint as tckpt

TINY = JaxConfig(
    num_classes=3, depth=26, anchor_sizes=(32, 64), anchor_ratios=(0.5, 1.0, 2.0),
    pre_nms_topk_train=200, post_nms_topk_train=64, pre_nms_topk_test=200,
    post_nms_topk_test=64, roi_batch_size=32, max_detections=16,
)
IMAGE_HW = (80, 128)
TIE = 1e-5


def _close(ours, ref, rel=1e-4):
    """|ours - ref| <= rel * max|ref| elementwise."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, (err, scale)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).rand(*IMAGE_HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model(image):
    """(flax FasterRCNN, its params as numpy) with JAX's own init."""
    model = JaxRCNN(cfg=TINY)
    init = jax.jit(lambda key, x: model.init(key, x, method=JaxRCNN.detect))
    params = _np(init(jax.random.PRNGKey(0), jnp.asarray(image))["params"])
    rng = np.random.RandomState(1)
    params["cls_score"]["kernel"] = rng.normal(
        0, 0.05, params["cls_score"]["kernel"].shape).astype(np.float32)
    params["cls_score"]["bias"][:] = [1.5, 0.0, -1.0, 0.0]
    return model, params


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = FasterRCNN(DetectionConfig(**TINY._asdict())).eval()
    model.load_state_dict(tckpt.detector_state_dict_from_jax(jax_model[1]))
    return model


def _jax_apply(jax_model, method, *args):
    model, params = jax_model
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return jax.tree_util.tree_map(np.asarray, fn(params, *[jnp.asarray(a) for a in args]))


@pytest.fixture(scope="module")
def jax_stages(jax_model, image):
    """The JAX detector's intermediate results on ``image``."""
    feats = _jax_apply(jax_model, JaxRCNN._features, image)
    logits, deltas = _jax_apply(jax_model, lambda m, f: m.rpn_head(f), feats)
    anchors = jrpn.make_anchors(feats.shape[0], feats.shape[1], TINY.stride,
                                TINY.anchor_sizes, TINY.anchor_ratios)
    props = jrpn.select_proposals(
        jnp.asarray(logits), jnp.asarray(deltas), anchors, IMAGE_HW,
        TINY.pre_nms_topk_test, TINY.post_nms_topk_test, TINY.rpn_nms_threshold)
    props = jax.tree_util.tree_map(np.asarray, props)
    cls_logits, box_deltas = _jax_apply(jax_model, JaxRCNN._roi_forward, feats, props.boxes)
    return dict(feats=feats, logits=logits, deltas=deltas, props=props,
                cls_logits=cls_logits, box_deltas=box_deltas)


# ------------------------------------------------------------------ box ops
def _random_boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    return np.concatenate([xy, xy + rng.rand(n, 2) * scale / 2 + 1], 1).astype(np.float32)


@pytest.mark.parametrize("op", ["encode", "decode", "clip", "hflip", "area"])
def test_box_ops_match_jax(op):
    rng = np.random.RandomState(2)
    a, b = _random_boxes(rng, 64), _random_boxes(rng, 64)
    b[:4] = a[:4] + np.array([-300, 50, 900, 2], np.float32)  # off the image
    deltas = (rng.randn(64, 4) * 2).astype(np.float32)
    deltas[:8, 2:] = np.array([[9.0, -9.0]] * 8)  # beyond BBOX_XFORM_CLIP
    calls = {
        "encode": lambda m, x: m.encode_boxes(x(b), x(a)),
        "decode": lambda m, x: m.decode_boxes(x(deltas), x(a)),
        "clip": lambda m, x: m.clip_boxes(x(b), 80.0, 128.0),
        "hflip": lambda m, x: m.hflip_boxes(x(b), 128.0),
        "area": lambda m, x: m.box_area(x(b)),
    }
    ref = np.asarray(calls[op](jboxes, jnp.asarray))
    ours = calls[op](tboxes, torch.from_numpy).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    assert tboxes.BBOX_XFORM_CLIP == jboxes.BBOX_XFORM_CLIP


def test_anchor_grid_equals_jax():
    args = (5, 8, 16, (32, 64), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(tboxes.anchor_grid(*args), jboxes.anchor_grid(*args))
    np.testing.assert_array_equal(trpn.make_anchors(*args).numpy(),
                                  np.asarray(jrpn.make_anchors(*args)))


# ---------------------------------------------------------------------- nms
def _nms_case(name):
    rng = np.random.RandomState(len(name))
    n = 60
    centers = rng.rand(n, 2) * 60
    boxes = np.concatenate([centers, centers + rng.rand(n, 2) * 30 + 5], 1)
    scores = rng.rand(n).astype(np.float32)
    valid, top_k = None, 20
    if name == "ties":  # duplicate scores: the order is by index
        scores = np.round(scores * 4) / 4
        boxes[10:20] = boxes[0]
    elif name == "valid":
        valid = rng.rand(n) > 0.3
    elif name == "capacity":  # fewer survivors than slots
        boxes[:] = boxes[0]
        top_k = 30
    elif name == "small_n":
        boxes, scores, top_k = boxes[:7], scores[:7], 16
    elif name == "dense":
        top_k = 50
    return boxes.astype(np.float32), scores, valid, top_k


NMS_CASES = ["ties", "valid", "capacity", "small_n", "dense"]


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_matches_jax(name):
    boxes, scores, valid, top_k = _nms_case(name)
    jv = None if valid is None else jnp.asarray(valid)
    ref_idx, ref_keep = (np.asarray(x) for x in jnms.nms(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, top_k, valid=jv))
    seq_idx, seq_keep = (np.asarray(x) for x in jnms.nms_sequential(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, top_k, valid=jv))
    np.testing.assert_array_equal(ref_idx, seq_idx)
    np.testing.assert_array_equal(ref_keep, seq_keep)
    tv = None if valid is None else torch.from_numpy(valid)
    for fn in (tnms.nms, tnms.nms_sequential):
        idx, keep = fn(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, top_k,
                       valid=tv)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(keep.numpy(), ref_keep)


def test_nms_batched_equals_each_image():
    """One batched call over images that finish after different numbers
    of steps equals JAX's nms image by image (an image that is done keeps
    its state, as under vmap)."""
    cases = [_nms_case(n) for n in ("ties", "valid", "dense")]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    valid = np.stack([np.ones(60, bool) if c[2] is None else c[2] for c in cases])
    valid[0, ::3] = False
    idx, keep = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 20,
                         valid=torch.from_numpy(valid))
    for b in range(3):
        ri, rk = jnms.nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.5, 20,
                          valid=jnp.asarray(valid[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(rk))


def test_box_iou_and_nms_tlwh_match_jax():
    boxes, scores, _, _ = _nms_case("dense")
    np.testing.assert_allclose(
        tnms.box_iou(torch.from_numpy(boxes[:9]), torch.from_numpy(boxes)).numpy(),
        np.asarray(jnms.box_iou(jnp.asarray(boxes[:9]), jnp.asarray(boxes))),
        rtol=1e-6, atol=1e-7)
    tlwh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], 1)
    ref = jnms.nms_tlwh(jnp.asarray(tlwh), jnp.asarray(scores), 0.4, 12)
    ours = tnms.nms_tlwh(torch.from_numpy(tlwh), torch.from_numpy(scores), 0.4, 12)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ------------------------------------------------------------- model stages
def test_backbone_matches_jax(port_model, jax_stages, image):
    with torch.no_grad():
        ours = port_model.features(torch.from_numpy(image)[None])[0]
    assert ours.shape == (5, 8, 1024)
    _close(ours.numpy(), jax_stages["feats"])


def test_res5_head_matches_jax(port_model, jax_model):
    x = np.random.RandomState(4).rand(3, 14, 14, 1024).astype(np.float32)
    ref = _jax_apply(jax_model, lambda m, f: m.res5(f), x)
    with torch.no_grad():
        ours = port_model.res5(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(ours.numpy(), ref)


def test_rpn_head_matches_jax_order(port_model, jax_stages):
    with torch.no_grad():
        logits, deltas = port_model.rpn_head(
            torch.tensor(jax_stages["feats"])[None].permute(0, 3, 1, 2))
    assert logits.shape == (1, 5 * 8 * 6) and deltas.shape == (1, 5 * 8 * 6, 4)
    _close(logits[0].numpy(), jax_stages["logits"])
    _close(deltas[0].numpy(), jax_stages["deltas"])


def test_select_proposals_matches_jax(jax_stages):
    s = jax_stages
    anchors = trpn.make_anchors(5, 8, TINY.stride, TINY.anchor_sizes, TINY.anchor_ratios)
    props = trpn.select_proposals(
        torch.tensor(s["logits"])[None], torch.tensor(s["deltas"])[None],
        anchors, IMAGE_HW, TINY.pre_nms_topk_test, TINY.post_nms_topk_test,
        TINY.rpn_nms_threshold)
    np.testing.assert_array_equal(props.mask[0].numpy(), s["props"].mask)
    assert s["props"].mask.sum() > 8
    np.testing.assert_allclose(props.boxes[0].numpy(), s["props"].boxes, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(props.scores[0].numpy(), s["props"].scores, rtol=1e-6,
                               atol=1e-7)


def test_roi_head_matches_jax(port_model, jax_stages):
    with torch.no_grad():
        cls_logits, deltas = port_model._roi_forward(
            torch.tensor(jax_stages["feats"])[None],
            torch.tensor(jax_stages["props"].boxes)[None])
    _close(cls_logits[0].numpy(), jax_stages["cls_logits"])
    _close(deltas[0].numpy(), jax_stages["box_deltas"])


def _assert_same_detections(ours: dict, ref: dict):
    """Slot by slot; where the slot differs, the reference's score must
    lie within TIE of a neighbour's, and the port must hold the same
    detection (class, IoU > 0.99, score within TIE) elsewhere, or an
    equally scored one in that slot."""
    np.testing.assert_array_equal(ours["mask"], ref["mask"])
    kept = np.flatnonzero(ref["mask"])
    assert len(kept) > 0
    rs, os_ = ref["scores"], ours["scores"]
    iou = np.asarray(jnms.box_iou(jnp.asarray(ref["boxes"]), jnp.asarray(ours["boxes"])))
    for k in kept:
        if (ours["classes"][k] == ref["classes"][k] and iou[k, k] > 0.99
                and abs(os_[k] - rs[k]) <= TIE):
            continue
        gaps = np.abs(rs[kept] - rs[k])
        assert np.sort(gaps)[1] <= TIE, f"slot {k} differs without a near-tie"
        found = [j for j in kept if ours["classes"][j] == ref["classes"][k]
                 and iou[k, j] > 0.99 and abs(os_[j] - rs[k]) <= TIE]
        assert found or abs(os_[k] - rs[k]) <= TIE, f"slot {k}: no match"


def test_detect_matches_jax(port_model, jax_model, image):
    ref = _jax_apply(jax_model, JaxRCNN.detect, image)
    ours = {k: v[0].numpy() for k, v in port_model.detect(
        torch.from_numpy(image)[None]).items()}
    assert ours["boxes"].shape == (TINY.max_detections, 4)
    _assert_same_detections(ours, ref)


def test_detect_tta_matches_jax(port_model, jax_model, image):
    ref = _jax_apply(jax_model, JaxRCNN.detect_tta, image)
    tra.reset_launches()
    ours = {k: v[0].numpy() for k, v in port_model.detect_tta(
        torch.from_numpy(image)[None]).items()}
    assert tra.LAUNCHES["roi_align"] == 0  # CPU: the plain version
    _assert_same_detections(ours, ref)


def test_roi_classeme_matches_jax(port_model, jax_model, image):
    boxes = _random_boxes(np.random.RandomState(5), 16, scale=70.0)
    ref = _jax_apply(jax_model, JaxRCNN.roi_classeme, image, boxes)
    ours = port_model.roi_classeme(torch.from_numpy(image)[None],
                                   torch.from_numpy(boxes)[None])
    assert ours.shape == (1, 16, TINY.num_classes + 1)
    _close(ours[0].numpy(), ref)


def test_detect_video_frames_matches_jax(jax_model):
    """T = 11 frames in batches of 4: the last batch is padded and sliced.
    16 proposals per image keep the CPU time down."""
    from tspn_tpu.pipeline import detect_video_frames as jax_detect_video_frames
    from tspn_tpu_torch.pipeline import detect_video_frames

    cfg = TINY._replace(post_nms_topk_test=16, max_detections=8)
    jm = JaxRCNN(cfg=cfg)
    frames = np.random.RandomState(6).rand(11, 64, 96, 3).astype(np.float32)
    ref = jax_detect_video_frames(jm, jax_model[1], frames, batch_size=4)
    model = FasterRCNN(DetectionConfig(**cfg._asdict())).eval()
    model.load_state_dict(tckpt.detector_state_dict_from_jax(jax_model[1]))
    ours = detect_video_frames(model, frames, device="cpu", batch_size=4)
    assert set(ours) == set(ref) and ours["boxes"].shape == (11, 8, 4)
    for t in range(11):
        _assert_same_detections({k: v[t] for k, v in ours.items()},
                                {k: v[t] for k, v in ref.items()})


def test_detector_refuses_bf16(jax_model, image):
    """Once a refusal, now the bf16 detector (``dtype=torch.bfloat16`` over
    the same f32 parameters) against JAX's ``dtype=jnp.bfloat16``: the
    same number kept, the same classes, sorted scores within two bf16
    ulps, and every detection that scores above the lowest kept score
    found again (same class, IoU > 0.95, score within two ulps). Those at
    the lowest score tie in bf16 for the last slots, so either may hold
    them."""
    ref = _jax_apply((JaxRCNN(cfg=TINY, dtype=jnp.bfloat16), jax_model[1]),
                     JaxRCNN.detect, image)
    ref = {k: np.asarray(v, np.float32) if k in ("boxes", "scores") else np.asarray(v)
           for k, v in ref.items()}
    model = FasterRCNN(DetectionConfig(**TINY._asdict()), dtype=torch.bfloat16).eval()
    model.load_state_dict(tckpt.detector_state_dict_from_jax(jax_model[1]))
    out = model.detect(torch.from_numpy(image)[None])
    assert out["scores"].dtype == torch.bfloat16 and out["boxes"].dtype == torch.float32
    ours = {k: v[0].float().numpy() if k == "scores" else v[0].numpy() for k, v in out.items()}
    np.testing.assert_array_equal(ours["mask"], ref["mask"])
    kept = np.flatnonzero(ref["mask"])
    assert len(kept) > 0
    two_ulps = 2.0 ** -7 * float(ref["scores"].max())
    np.testing.assert_allclose(np.sort(ours["scores"]), np.sort(ref["scores"]), atol=two_ulps)
    np.testing.assert_array_equal(np.sort(ours["classes"][kept]), np.sort(ref["classes"][kept]))
    iou = np.asarray(jnms.box_iou(jnp.asarray(ref["boxes"]), jnp.asarray(ours["boxes"])))
    lowest = ref["scores"][kept].min()
    for k in kept[ref["scores"][kept] > lowest]:
        assert any(ours["classes"][j] == ref["classes"][k] and iou[k, j] > 0.95
                   and abs(ours["scores"][j] - ref["scores"][k]) <= two_ulps
                   for j in kept), f"slot {k}: no match"


def test_seeded_init_is_flax_like():
    cfg = DetectionConfig(**TINY._asdict())
    a = FasterRCNN(cfg, generator=torch.Generator().manual_seed(3))
    b = FasterRCNN(cfg, generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    sd = a.state_dict()
    w = sd["backbone.res4.block0.conv2.weight"]  # lecun_normal, fan_in 256 * 9
    assert abs(float(w.std()) * np.sqrt(256 * 9) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(256 * 9) + 1e-6
    assert abs(float(sd["cls_score.weight"].std()) - 0.01) < 1e-3
    assert abs(float(sd["bbox_pred.weight"].std()) - 0.001) < 1e-4
    assert abs(float(sd["rpn_head.conv.weight"].std()) - 0.01) < 1e-3
    assert torch.equal(sd["backbone.stem_norm.scale"], torch.ones(64))
    assert not sd["rpn_head.objectness.bias"].any()


# ------------------------------------------------------------ weight maps
def _torchvision_state_dict(rng):
    """A depth-26 torchvision-style ResNet state dict, random BN stats."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)
                                ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, (mid, cout) in enumerate([(64, 256), (128, 512), (256, 1024),
                                         (512, 2048)], 1):
        p = f"layer{layer}.0"
        conv(f"{p}.conv1", mid, cin, 1)
        conv(f"{p}.conv2", mid, mid, 3)
        conv(f"{p}.conv3", cout, mid, 1)
        for j, c in ((1, mid), (2, mid), (3, cout)):
            bn(f"{p}.bn{j}", c)
        conv(f"{p}.downsample.0", cout, cin, 1)
        bn(f"{p}.downsample.1", cout)
        cin = cout
    return sd


def test_torchvision_converter_matches_jax(jax_model, image):
    from tspn_tpu.detection.torch_weights import convert_torch_resnet as jax_convert
    from tspn_tpu_torch.detection.torch_weights import (
        convert_torch_resnet,
        load_into_faster_rcnn,
    )

    sd = _torchvision_state_dict(np.random.RandomState(7))
    backbone, res5 = jax_convert(sd, depth=26)
    want = tckpt.detector_state_dict_from_jax({"backbone": backbone, "res5": res5})
    got = convert_torch_resnet({k: torch.from_numpy(v) for k, v in sd.items()}, depth=26)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    model = FasterRCNN(DetectionConfig(**TINY._asdict())).eval()
    load_into_faster_rcnn(model, sd, depth=26)
    params = dict(jax_model[1], backbone=_np(backbone), res5=_np(res5))
    ref = _jax_apply((jax_model[0], params), JaxRCNN._features, image)
    with torch.no_grad():
        _close(model.features(torch.from_numpy(image)[None])[0].numpy(), ref)


def test_detector_state_dict_maps_both_ways(jax_model, port_model):
    params = jax_model[1]
    sd = tckpt.detector_state_dict_from_jax(params)
    assert set(sd) == set(port_model.state_dict())
    assert sd["backbone.stem_conv.weight"].shape == (64, 3, 7, 7)
    assert sd["cls_score.weight"].shape == (TINY.num_classes + 1, 2048)
    back = tckpt.jax_params_from_detector_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    again = tckpt.detector_state_dict_from_jax(
        tckpt.jax_params_from_detector_state_dict(port_model.state_dict()))
    for k, v in port_model.state_dict().items():
        assert torch.equal(again[k], v), k
    with pytest.raises(ValueError):
        tckpt.detector_state_dict_from_jax({"classifier": {}})


def test_jax_detector_checkpoint_loads(jax_model, port_model, tmp_path):
    from tspn_tpu.runtime.checkpoint import save_checkpoint

    path = save_checkpoint(str(tmp_path / "detector.msgpack"), jax_model[1], step=7)
    sd = tckpt.load_detector_checkpoint(path)
    for k, v in port_model.state_dict().items():
        assert torch.equal(sd[k], v), k


# ------------------------------------------------------- eval and inputs
def _records_and_detections(seed, n_images=4, n_classes=3):
    rng = np.random.RandomState(seed)
    records, dets = [], {}
    for i in range(n_images):
        gt = _random_boxes(rng, 5, 60.0)
        cls = rng.randint(0, n_classes, 5)
        records.append({"image_id": i, "annotations": [
            {"bbox": b.tolist(), "category_id": int(c), "bbox_mode": "XYXY_ABS"}
            for b, c in zip(gt, cls)]})
        boxes = np.concatenate([gt + rng.randn(5, 4).astype(np.float32) * 3,
                                _random_boxes(rng, 7, 60.0)])
        dets[i] = {"boxes": boxes, "scores": rng.rand(12).astype(np.float32),
                   "classes": rng.randint(0, n_classes, 12),
                   "mask": rng.rand(12) > 0.2}
    return records, dets


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_detections_matches_jax(seed):
    records, dets = _records_and_detections(seed)
    for thr in (0.3, 0.5, 0.7):
        ours = teval.evaluate_detections(records, dets, thr)
        ref = jeval.evaluate_detections(records, dets, thr)
        assert ours == ref
    assert teval.evaluate_detections_coco(records, dets) == \
        jeval.evaluate_detections_coco(records, dets)


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(8)
    recall = np.sort(rng.rand(30))
    precision = rng.rand(30)
    assert teval.voc_ap(recall, precision, use_07) == jax_voc_ap(recall, precision, use_07)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (400, 1600), (81, 127)])
def test_input_policy_helpers_match_jax(hw):
    h, w = hw
    assert tinputs.shortest_edge_scale(h, w, 800, 1333) == \
        jtrain.shortest_edge_scale(h, w, 800, 1333)
    for policy in ("letterbox", "shortest_edge"):
        jcfg = jtrain.DetectorTrainConfig(input_policy=policy, min_size=64, max_size=106)
        tcfg = tinputs.DetectorTrainConfig(input_policy=policy, min_size=64, max_size=106)
        assert tinputs.input_bucket_shape(h, w, tcfg) == jtrain.input_bucket_shape(h, w, jcfg)
    rng = np.random.RandomState(h)
    img = rng.rand(h // 8, w // 8, 3).astype(np.float32)
    boxes = _random_boxes(rng, 3, 10.0)
    for ours, ref in ((tinputs.letterbox(img, boxes, 96), jtrain.letterbox(img, boxes, 96)),
                      (tinputs.resize_shortest_edge(img, boxes, 40, 70),
                       jtrain.resize_shortest_edge(img, boxes, 40, 70))):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tinputs._bilinear_resize(img, 7, 13),
                                  jtrain._bilinear_resize(img, 7, 13))


@pytest.mark.parametrize("kind", ["uint8", "unit_float", "byte_float", "png"])
def test_load_record_image_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(9)
    arr = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    if kind == "uint8":
        rec = {"image": arr}
    elif kind == "unit_float":
        rec = {"image": arr.astype(np.float32) / 255.0}
    elif kind == "byte_float":
        rec = {"image": arr.astype(np.float32)}
    else:
        from PIL import Image

        path = os.path.join(tmp_path, "frame.png")
        Image.fromarray(arr).save(path)
        rec = {"file_name": path}
    np.testing.assert_array_equal(tinputs.load_record_image(rec),
                                  jtrain.load_record_image(rec))


def test_run_detector_eval_matches_jax(jax_model):
    """Letterboxed records through both detectors and evaluators."""
    rng = np.random.RandomState(10)
    records = []
    for i, (h, w) in enumerate([(60, 100), (100, 70)]):
        gt = _random_boxes(rng, 3, 40.0)
        records.append({"image_id": i, "image": (rng.rand(h, w, 3) * 255).astype(np.uint8),
                        "annotations": [{"bbox": b.tolist(), "category_id": int(c),
                                         "bbox_mode": "XYXY_ABS"}
                                        for b, c in zip(gt, rng.randint(0, 3, 3))]})
    model = FasterRCNN(DetectionConfig(**TINY._asdict())).eval()
    model.load_state_dict(tckpt.detector_state_dict_from_jax(jax_model[1]))
    ref = jeval.run_detector_eval(
        jax_model[0], jax_model[1], records,
        train_cfg=jtrain.DetectorTrainConfig(image_size=96))
    ours = teval.run_detector_eval(
        model, records, device="cpu", train_cfg=tinputs.DetectorTrainConfig(image_size=96))
    assert ours[1].keys() == ref[1].keys()
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5, atol=1e-6)
