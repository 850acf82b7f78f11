"""The port's bf16 detector and K7's bf16 half held against the JAX
package on the CPU.

* The model: TINY of tests/test_torch_detection.py (depth 26, 3 classes,
  80 x 128 image) with JAX's init carried across, once as
  ``FasterRCNN(dtype=jnp.bfloat16)`` and once as the port's
  ``FasterRCNN(dtype=torch.bfloat16)``; parameters stay f32 in both. Each
  stage gets the same bf16 input (the JAX stage's output) and must agree
  within 2**-6 * max|JAX output|, two bf16 ulps at the output's scale:
  the frameworks round at other places (XLA fuses FrozenAffine's multiply
  and add and sums convolutions in another order), so the two are not
  bit-equal.
* K7 bf16's plain version (``roi_align_plain`` on the widened map,
  rounded once) against ``roi_align_pallas`` in interpret mode on bf16
  features: the TPU kernel rounds each entry of G to bf16 before its f32
  dot, so the two agree within |port - jax| <= 2**-8 * (G . |F|) + one
  bf16 ulp of the output per element (G . |F| is RoIAlign of |F|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tspn_tpu.detection.rcnn import FasterRCNN as JaxRCNN
from tspn_tpu.ops import roi_align as jra
from tspn_tpu_torch.detection.rcnn import DetectionConfig, FasterRCNN
from tspn_tpu_torch.ops import roi_align as tra
from tspn_tpu_torch.runtime import checkpoint as tckpt

from test_torch_detection import IMAGE_HW, TINY, jax_model, image  # noqa: F401
from test_torch_roi_align import BOXES, GEOMETRIES

BF16 = jnp.bfloat16
REL = 2.0 ** -6


def _f32(x):
    return np.asarray(x, np.float32)


def _apply16(jax_model, method, *args):
    """The JAX model in bf16 compute over the same f32 parameters."""
    model = JaxRCNN(cfg=TINY, dtype=BF16)
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return jax.tree_util.tree_map(np.asarray, fn(jax_model[1], *args))


@pytest.fixture(scope="module")
def port16(jax_model):  # noqa: F811
    model = FasterRCNN(DetectionConfig(**TINY._asdict()), dtype=torch.bfloat16).eval()
    model.load_state_dict(tckpt.detector_state_dict_from_jax(jax_model[1]))
    return model


@pytest.fixture(scope="module")
def feats16(jax_model, image):  # noqa: F811
    return _apply16(jax_model, JaxRCNN._features, jnp.asarray(image))


def _close16(ours: torch.Tensor, ref: np.ndarray):
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape
    ref = _f32(ref)
    err = float(np.abs(ours.float().numpy() - ref).max())
    assert err <= REL * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def test_bf16_parameters_are_the_f32_tree(port16, jax_model):  # noqa: F811
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    assert set(port16.state_dict()) == set(tckpt.detector_state_dict_from_jax(jax_model[1]))


def test_bf16_backbone_matches_jax(port16, feats16, image):  # noqa: F811
    with torch.no_grad():
        ours = port16.features(torch.from_numpy(image)[None])[0]
    assert feats16.dtype == BF16
    _close16(ours, feats16)


def test_bf16_rpn_head_matches_jax(port16, jax_model, feats16):  # noqa: F811
    logits, deltas = _apply16(jax_model, lambda m, f: m.rpn_head(f), jnp.asarray(feats16))
    with torch.no_grad():
        ours_l, ours_d = port16.rpn_head(
            torch.from_numpy(_f32(feats16)).bfloat16()[None].permute(0, 3, 1, 2))
    _close16(ours_l[0], logits)
    _close16(ours_d[0], deltas)


def test_bf16_roi_head_matches_jax(port16, jax_model, feats16):  # noqa: F811
    """The JAX RoI head pools a bf16 map through roi_align_xla (f32 out,
    cast to bf16 by res5's first conv); the port's plain K7 bf16 rounds
    the pooled map once: the same value."""
    boxes = np.array([[10, 10, 60, 50], [0, 0, 128, 80], [30, 20, 40, 30],
                      [5, 40, 100, 79], [-8, -4, 20, 30]], np.float32)
    cls_logits, deltas = _apply16(jax_model, JaxRCNN._roi_forward, jnp.asarray(feats16),
                                  jnp.asarray(boxes))
    with torch.no_grad():
        ours_c, ours_d = port16._roi_forward(
            torch.from_numpy(_f32(feats16)).bfloat16()[None], torch.from_numpy(boxes)[None])
    _close16(ours_c[0], cls_logits)
    _close16(ours_d[0], deltas)


def test_bf16_proposals_are_f32_boxes(port16, image):  # noqa: F811
    """bf16 deltas decoded against f32 anchors give f32 boxes, as in JAX."""
    from tspn_tpu_torch.detection.rpn import make_anchors, select_proposals

    with torch.no_grad():
        feats = port16.features(torch.from_numpy(image)[None])
        logits, deltas = port16._rpn(feats)
    anchors = make_anchors(feats.shape[1], feats.shape[2], TINY.stride, TINY.anchor_sizes,
                           TINY.anchor_ratios)
    props = select_proposals(logits, deltas, anchors, IMAGE_HW, 200, 64)
    assert logits.dtype == torch.bfloat16 and props.boxes.dtype == torch.float32
    assert props.scores.dtype == torch.bfloat16 and props.mask.sum() > 8


def test_bf16_serving_entry_points_run(port16, image):  # noqa: F811
    from tspn_tpu_torch.pipeline import detect_video_frames

    images = torch.from_numpy(image)[None]
    tta = port16.detect_tta(images)
    assert tta["scores"].dtype == torch.bfloat16 and tta["mask"].any()
    classeme = port16.roi_classeme(images, torch.tensor([[[4.0, 4.0, 60.0, 50.0]]]))
    assert classeme.dtype == torch.bfloat16 and classeme.shape == (1, 1, TINY.num_classes + 1)
    frames = np.random.RandomState(6).rand(3, 64, 96, 3).astype(np.float32)
    dets = detect_video_frames(port16, frames, device="cpu", batch_size=2)
    assert dets["scores"].dtype == np.float32 and dets["mask"].shape == (3, TINY.max_detections)
    assert dets["mask"].any(axis=1).all()


@pytest.mark.parametrize("out,s", GEOMETRIES)
def test_plain_bf16_within_the_g_rounding_of_roi_align_pallas(out, s):
    rng = np.random.RandomState(out * 10 + s)
    feat = rng.rand(20, 24, 8).astype(np.float32) * 4 - 1
    f16 = jnp.asarray(feat, BF16)
    ref = _f32(jra.roi_align_pallas(f16, jnp.asarray(BOXES), out, s))
    assert jra.roi_align_pallas(f16, jnp.asarray(BOXES), out, s).dtype == BF16
    fb = torch.from_numpy(_f32(f16)).bfloat16()
    ours = tra.roi_align(fb, torch.from_numpy(BOXES), None, out, s)
    assert ours.dtype == torch.bfloat16
    terms = tra.roi_align_plain(fb.float().abs(), torch.from_numpy(BOXES), None, out, s)
    _, e = np.frexp(np.abs(ref))
    ulp = np.where(ref == 0, 0.0, np.ldexp(1.0, e - 8))
    bound = 2.0 ** -8 * terms.numpy() + ulp
    err = np.abs(ours.float().numpy() - ref)
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())
