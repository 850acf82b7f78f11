"""The port's copies of the JAX package's host code, held against their
originals on the same inputs.

* Config (tspn_tpu_torch/config): the defaults, and the merge of every
  tracked configs/*.yaml and of five saved-run configs (written into
  tmp_path by the writer training uses, as the git-ignored
  configs/*_config.yaml of a working tree are), equal key for key, dumps
  included; merge_from_list and the type coercion behave alike.
* Paths (data/segments.py): the artifact root, file names, segment
  signatures and the 30/15 tiling.
* Annotations (data/annotations.py) on tests/fixtures/golden_vidvrd:
  vocabularies, indexes and instances; trajectories (data/trajectory.py)
  and greedy association (association.py) on the fixture's traj_cls
  artifacts with seeded segment predictions: the same serialized video
  relations.
* Logging helpers (runtime/logging_utils.py).
* SegmentDataset (data/vrdataset.py) on the synthetic set of the
  conftest, train and test phases, host-normalized and fused (device
  layout) rows: the same records, field for field, bit for bit; and
  ConsolidatedSegmentDataset / load_consolidated (data/preprocess.py) on
  f32, q8 and q8f stores written by the JAX package.
"""

import glob
import os

import numpy as np
import pytest
import torch

from tspn_tpu import association as jassoc
from tspn_tpu import data as jdata
from tspn_tpu.config import config as jconfig
from tspn_tpu.data import annotations as jann
from tspn_tpu.data import preprocess as jpre
from tspn_tpu.data import segments as jseg
from tspn_tpu.data import trajectory as jtraj
from tspn_tpu.data import vrdataset as jvr
from tspn_tpu.runtime import logging_utils as jlog
from tspn_tpu_torch import association as tassoc
from tspn_tpu_torch.config import config as tconfig
from tspn_tpu_torch.data import annotations as tann
from tspn_tpu_torch.data import preprocess as tpre
from tspn_tpu_torch.data import segments as tseg
from tspn_tpu_torch.data import trajectory as ttraj
from tspn_tpu_torch.data import vrdataset as tvr
from tspn_tpu_torch.runtime import logging_utils as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "golden_vidvrd")
# the tracked configs: training writes configs/<name>_config.yaml, which
# git ignores, so a working tree may hold more than a checkout
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 if not p.endswith("_config.yaml"))
# saved-run configs, as training's cfg.dump_to_file writes them: the
# tracked base and the overrides of the runs (README recipe, the tests'
# plateau and resume runs, the PPN recipe)
SAVED_RUNS = {
    "baseline_config.yaml": ("baseline.yaml", [
        "SOLVER.MAX_ITER", "150", "SOLVER.SCHEDULER.MILESTONES", "[80, 120]",
        "SOLVER.SCHEDULER.WARMUP_ITERS", "30", "PREDICT.PREDICATE_NUM", "8",
        "ETC.SAVE_FREQ", "150", "ETC.MODEL_DUMP_FILE", "baseline_weights_iter_150.pt"]),
    "baseline_vidor_config.yaml": ("vidor.yaml", [
        "SOLVER.MAX_ITER", "60", "SOLVER.SCHEDULER.MILESTONES", "[40, 50]",
        "SOLVER.SCHEDULER.WARMUP_ITERS", "10", "DATASET.TEST_BATCH_SIZE", "4",
        "PREDICT.PREDICATE_NUM", "16", "ETC.DISPLAY_FREQ", "30", "ETC.SAVE_FREQ", "60",
        "ETC.MODEL_DUMP_FILE", "baseline_vidor_weights_iter_60.pt",
        "BUCKETS.SEGMENTS_PER_STEP", "4"]),
    "plateau_test_config.yaml": ("baseline.yaml", [
        "MODEL.NAME", "plateau_test", "SOLVER.MAX_ITER", "6",
        "SOLVER.SCHEDULER.TYPE", "plateau", "DATASET.TRAIN_BATCH_SIZE", "1024",
        "DATASET.LOGIT_ONLY", "False", "PREDICT.PREDICATE_NUM", "19",
        "RELPN.PPN.POSITIVE_FRACTION", "0.5", "ETC.DISPLAY_FREQ", "100",
        "ETC.SAVE_FREQ", "100", "ETC.MODEL_DUMP_FILE", "plateau_test_weights_iter_6.pt",
        "BUCKETS.SEGMENTS_PER_STEP", "2"]),
    "resume_test_config.yaml": ("baseline.yaml", [
        "MODEL.NAME", "resume_test", "SOLVER.MAX_ITER", "10",
        "SOLVER.SCHEDULER.MILESTONES", "[6, 8]", "SOLVER.SCHEDULER.WARMUP_ITERS", "2",
        "DATASET.TRAIN_BATCH_SIZE", "1024", "DATASET.LOGIT_ONLY", "False",
        "PREDICT.PREDICATE_NUM", "19", "RELPN.PPN.POSITIVE_FRACTION", "0.5",
        "ETC.DISPLAY_FREQ", "100", "ETC.SAVE_FREQ", "5",
        "ETC.MODEL_DUMP_FILE", "resume_test_weights_iter_10.pt", "BUCKETS.SEGMENTS_PER_STEP", "2"]),
    "tspn_config.yaml": ("tspn.yaml", [
        "SOLVER.MAX_ITER", "80", "SOLVER.SCHEDULER.MILESTONES", "[50, 70]",
        "SOLVER.SCHEDULER.WARMUP_ITERS", "15", "DATASET.TEST_BATCH_SIZE", "4",
        "PREDICT.PREDICATE_NUM", "6", "RELPN.USE_DPN", "False", "ETC.DISPLAY_FREQ", "40",
        "ETC.SAVE_FREQ", "80", "ETC.MODEL_DUMP_FILE", "tspn_weights_iter_80.pt",
        "BUCKETS.SEGMENTS_PER_STEP", "4"]),
}


@pytest.fixture
def output_dir():
    """Point both packages' artifact roots at a directory; restore after."""
    before = (jseg.get_output_dir(), tseg.get_output_dir())

    def point(path):
        jseg.set_output_dir(path)
        tseg.set_output_dir(path)

    yield point
    jseg.set_output_dir(before[0])
    tseg.set_output_dir(before[1])


def test_config_defaults_equal():
    j, t = jconfig.get_default_config(), tconfig.get_default_config()
    assert t.to_dict() == j.to_dict()
    assert t.dump() == j.dump()


@pytest.mark.parametrize("name", sorted(CONFIGS + list(SAVED_RUNS)))
def test_config_merge_equal(name, tmp_path):
    path = os.path.join(REPO, "configs", name)
    if name in SAVED_RUNS:  # a saved-run config, written as training writes it
        base, opts = SAVED_RUNS[name]
        cfg = jconfig.get_default_config()
        cfg.merge_from_file(os.path.join(REPO, "configs", base))
        cfg.merge_from_list(opts)
        path = str(tmp_path / name)
        cfg.dump_to_file(path)
    j, t = jconfig.get_default_config(), tconfig.get_default_config()
    j.merge_from_file(path)
    t.merge_from_file(path)
    assert t.to_dict() == j.to_dict()
    opts = ["SOLVER.BASE_LR", "0.5", "BUCKETS.NUM_TRACKLETS", "[4, 8]",
            "RELPN.PPN.PRUNE_AT_INFERENCE", "true"]
    j.merge_from_list(opts)
    t.merge_from_list(opts)
    assert t.to_dict() == j.to_dict() and t.clone() == t
    for bad in (["RELPN.USE_PPN", "3"], ["PREDICT.NOPE", "1"], ["ETC.SAVE_FREQ", "1.5"]):
        with pytest.raises(Exception) as je:
            jconfig.get_default_config().merge_from_list(bad)
        with pytest.raises(je.type):
            tconfig.get_default_config().merge_from_list(bad)


def test_paths_equal(output_dir, tmp_path):
    output_dir(str(tmp_path / "out"))
    assert tseg.get_output_dir() == jseg.get_output_dir()
    assert tseg.get_model_path() == jseg.get_model_path()
    for vid, fs, fe in (("ILSVRC2015_train_00005003", 0, 30), ("a-b-c", 1215, 1245)):
        assert tseg.get_segment_signature(vid, fs, fe) == jseg.get_segment_signature(vid, fs, fe)
        assert (tseg.get_relation_feature_file(vid, fs, fe)
                == jseg.get_relation_feature_file(vid, fs, fe))
        for gt in (False, True):
            assert (tseg.get_traj_proposal_file(vid, fs, fe, gt=gt)
                    == jseg.get_traj_proposal_file(vid, fs, fe, gt=gt))
    for span in ((0, 30), (0, 29), (0, 100), (15, 240), (7, 8)):
        assert tseg.segment_video(*span) == jseg.segment_video(*span)
    assert (tseg.SEGMENT_LENGTH, tseg.SEGMENT_STRIDE) == (jseg.SEGMENT_LENGTH,
                                                          jseg.SEGMENT_STRIDE)


def _golden(cls):
    data = os.path.join(FIXTURE, "vidvrd")
    return cls(data, os.path.join(data, "videos"), ["train", "test"])


def test_annotations_equal():
    assert (tann.BaseVidVRD, tann.BaseVidOR) == (tann.VidVRD, tann.VidOR)
    assert tann.VidOR.ACTIONS == jann.VidOR.ACTIONS
    j, t = _golden(jdata.BaseVidVRD), _golden(tann.BaseVidVRD)
    assert dict(t.split_index) == dict(j.split_index)
    assert (t.soid2so, t.pid2pred) == (j.soid2so, j.pid2pred)
    assert t.infer_test_split() == j.infer_test_split() == "test"
    assert t.get_triplets("train") == j.get_triplets("train")
    for vid in j.annos:
        assert t.get_relation_insts(vid) == j.get_relation_insts(vid)
        assert t.get_object_insts(vid) == j.get_object_insts(vid)
        assert t.get_video_path(vid) == j.get_video_path(vid)
    with pytest.raises(KeyError):
        t.get_index("validation")


def _segments_with_proposals():
    out = []
    for path in sorted(glob.glob(os.path.join(FIXTURE, "output", "features", "traj_cls",
                                              "*", "*-traj_cls.json"))):
        vid, fstart, fend = os.path.basename(path)[: -len("-traj_cls.json")].rsplit("-", 2)
        out.append((vid, int(fstart), int(fend)))
    return out


def test_trajectory_and_association_equal(output_dir):
    output_dir(os.path.join(FIXTURE, "output"))
    segments = _segments_with_proposals()
    assert segments
    rng = np.random.RandomState(0)
    dataset = _golden(jann.VidVRD)
    short_term = []
    for index in segments:
        jt = jtraj.load_trajectory_proposals(*index)
        tt = ttraj.load_trajectory_proposals(*index)
        assert [a.serialize() for a in tt] == [b.serialize() for b in jt]
        assert (ttraj.load_trajectory_proposals(*index, logit_only=True)
                == jtraj.load_trajectory_proposals(*index, logit_only=True))
        n = len(jt)
        boxes = np.stack([t.rois for t in jt])
        np.testing.assert_array_equal(ttraj.cubic_iou(boxes, boxes),
                                      jtraj.cubic_iou(boxes, boxes))
        preds = []
        for _ in range(12 if n > 1 else 0):
            s, o = rng.choice(n, 2, replace=False)
            trip = (rng.randint(dataset.get_object_num()), rng.randint(dataset.get_predicate_num()),
                    rng.randint(dataset.get_object_num()))
            preds.append((np.float32(rng.rand()), np.array(trip), np.array([s, o])))
        short_term.append((index, (preds, None, None)))
    head, tail = jt[0], jt[0].copy()
    tail.pstart, tail.pend = head.pstart + 15, head.pend + 15
    merged_j = jtraj.merge_trajectories(head, tail)
    merged_t = ttraj.merge_trajectories(ttraj.Trajectory(**head.serialize()),
                                        ttraj.Trajectory(**tail.serialize()))
    assert merged_t.serialize() == merged_j.serialize()
    assert ttraj.overlap_traj_iou(head, tail) == jtraj.overlap_traj_iou(head, tail)
    by_vid = {}
    for index, rel in short_term:
        by_vid.setdefault(index[0], []).append((index, rel))
    for vid, rels in by_vid.items():
        ref = jassoc.greedy_relational_association(dataset, rels, max_traj_num_in_clip=100)
        got = tassoc.greedy_relational_association(dataset, rels, max_traj_num_in_clip=100)
        assert got == ref and ref


def test_logging_utils_equal():
    for args in ((0.5, 10, 100), (3.2, 0, 1), (100.0, 7, 5000)):
        assert tlog.eta_string(*args) == jlog.eta_string(*args)
    jm, tm = jlog.MetricLogger(), tlog.MetricLogger()
    for v in (0.3, float("nan"), 0.1, 0.7, 0.2):
        jm.update(loss=v, lr=v / 10)
        tm.update(loss=v, lr=v / 10)
    assert str(tm) == str(jm)
    assert tm.loss.global_avg == jm.loss.global_avg and tm.loss.avg == jm.loss.avg


def _assert_records_equal(a, b):
    assert a.index == b.index and a.num_proposals == b.num_proposals
    for field in ("feats", "pairs", "labels", "cls_logits", "iou", "trackid",
                  "q8_scales", "trk_feats", "trk_scales"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("phase", ["train", "test"])
def test_segment_dataset_records_equal(phase, fused, cfg, synthetic_dataset, output_dir):
    output_dir(jseg.get_output_dir())
    cfg.MODEL.FUSED_CLASSIFIER = fused
    tcfg = tconfig.get_default_config()
    tcfg.merge_from_dict(cfg.to_dict())
    jds = jvr.SegmentDataset(cfg, synthetic_dataset, phase=phase)
    port_annotations = tann.VidVRD(synthetic_dataset.anno_rpath,
                                   synthetic_dataset.video_rpath, ["train", "test"])
    tds = tvr.SegmentDataset(tcfg, port_annotations, phase=phase)
    assert tds.index == jds.index and len(tds) > 0
    assert tvr.effective_feature_dim(tcfg) == jvr.effective_feature_dim(cfg)
    # the leaf dtype of each MODEL.DTYPE: torch's for the JAX package's
    # numpy / ml_dtypes one
    for dtype, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        jcfg, pcfg = cfg.clone(), tcfg.clone()
        jcfg.MODEL.DTYPE = pcfg.MODEL.DTYPE = dtype
        assert np.dtype(jvr.effective_feats_dtype(jcfg)).name == dtype
        assert tvr.effective_feats_dtype(pcfg) == want
    for i in range(len(jds)):
        assert tds.num_proposals_of(i) == jds.num_proposals_of(i)
        for with_labels in (True, False):
            _assert_records_equal(jds.load_segment(i, with_labels=with_labels),
                                  tds.load_segment(i, with_labels=with_labels))


@pytest.mark.parametrize("mode", ["f32", "q8", "q8f"])
def test_consolidated_records_equal(mode, cfg, synthetic_dataset, tmp_path, output_dir):
    path = jpre.consolidate_split(cfg, synthetic_dataset, "test",
                                  str(tmp_path / f"{mode}.hdf5"),
                                  quantize="" if mode == "f32" else mode)
    tcfg = tconfig.get_default_config()
    jds, tds = jpre.ConsolidatedSegmentDataset(cfg, path), tpre.ConsolidatedSegmentDataset(tcfg, path)
    assert (tds.quantized, tds.factored, tds.index) == (jds.quantized, jds.factored, jds.index)
    assert tds.feature_width() == jds.feature_width() and len(tds) > 0
    for i in range(len(jds)):
        assert tds.num_proposals_of(i) == jds.num_proposals_of(i)
        for with_labels in (True, False):
            _assert_records_equal(jds.load_segment(i, with_labels=with_labels),
                                  tds.load_segment(i, with_labels=with_labels))
    ja, ta = jpre.load_consolidated(path), tpre.load_consolidated(path)
    assert set(ta) == set(ja) and ta["mode"] == ja["mode"] == mode
    assert ta["segments"] == ja["segments"]
    for k in set(ja) - {"mode", "segments"}:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    output_dir(str(tmp_path))
    assert tpre.consolidated_path("test") == jpre.consolidated_path("test")
