"""The PyTorch port's command line and import surface.

* ``base.py --detect`` (JAX) and ``python -m tspn_tpu_torch.base --detect
  --device cpu`` serve one JAX checkpoint on the synthetic set, per-file
  f32 and from a q8f store; relation mAP and R@50 / R@100 agree within
  1e-4 (tspn_tpu.evaluation). The same holds for a fused-classifier
  checkpoint that ``base.py --train`` wrote, served per-file f32 (the
  fused kernel's plain version) and from the q8f store (its weights
  carried back to the storage layout).
* The port's ``--train --detect`` writes a checkpoint and a valid
  prediction JSON, and ``--train --resume`` continues at the
  checkpoint's step.
* The device path of the port imports none of jax, flax, h5py, yaml,
  msgpack or tspn_tpu: a subprocess whose import system refuses them
  imports every module of tspn_tpu_torch and chip_smoke.
* chip_smoke.py exits nonzero and prints no result without a CUDA
  device, and in a directory without the package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP = "baseline_weights_iter_1.pt"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _write_config(path, consolidated, num_predicates, dump=DUMP, **overrides):
    from tspn_tpu.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_file(os.path.join(REPO, "configs", "baseline.yaml"))
    # a synthetic set observes a subset of the vocabulary: serialization
    # needs PREDICATE_NUM to match it
    cfg.PREDICT.PREDICATE_NUM = num_predicates
    cfg.PREDICT.CONSOLIDATED = consolidated
    cfg.ETC.MODEL_DUMP_FILE = dump
    cfg.merge_from_dict(overrides)
    with open(path, "w") as f:
        f.write(cfg.dump())
    return cfg


@pytest.fixture(scope="module")
def served_workdir(tmp_path_factory):
    """Synthetic VidVRD set, its artifacts and q8f store (base.py
    --preprocess), and a JAX checkpoint whose classifier reads the
    predicate signal the synthetic relative block carries."""
    import jax

    import base as jax_base
    from tspn_tpu.data.annotations import VidVRD
    from tspn_tpu.data.feature_store import FeatureLayout
    from tspn_tpu.data.segments import get_model_path, get_output_dir, set_output_dir
    from tspn_tpu.data.synthetic import generate_annotations
    from tspn_tpu.models.tspn import TSPNModel
    from tspn_tpu.runtime.checkpoint import save_checkpoint

    work = tmp_path_factory.mktemp("torch_cli")
    generate_annotations(str(work / "data" / "vidvrd"), num_train=2, num_test=2,
                         seed=11, num_categories=5, num_predicate_types=8)
    data = work / "data" / "vidvrd"
    num_predicates = VidVRD(str(data), str(data / "videos"),
                            ["train", "test"]).get_predicate_num()
    _write_config(work / "f32.yaml", "", num_predicates)
    _write_config(work / "q8f.yaml", "q8f", num_predicates)
    cwd, prev_out, argv = os.getcwd(), get_output_dir(), sys.argv
    os.chdir(work)
    try:
        sys.argv = ["base.py", "--config", "q8f.yaml", "--data_dir", "data",
                    "--dataset", "vidvrd", "--preprocess"]
        jax_base.main()
        layout = FeatureLayout()
        model = TSPNModel(num_predicates=num_predicates, use_ppn=False, use_dpn=False)
        params = model.init(
            jax.random.PRNGKey(0), {"feats": np.zeros((1, 2, layout.dim), np.float32)}
        )["params"]
        params = jax.tree_util.tree_map(np.array, params)
        kernel = params["classifier"]["rel_predictor"]["kernel"]
        for p in range(num_predicates):
            kernel[layout.rel_start + p, p] += 2.0
        save_checkpoint(os.path.join(get_model_path(), DUMP), params, step=1)
    finally:
        sys.argv = argv
        os.chdir(cwd)
        set_output_dir(prev_out)
    return work


def _metrics(work, payload):
    from tspn_tpu.data.annotations import VidVRD
    from tspn_tpu.evaluation import eval_visual_relation

    dataset = VidVRD(str(work / "data" / "vidvrd"),
                     str(work / "data" / "vidvrd" / "videos"), ["train", "test"])
    gt = {vid: dataset.get_relation_insts(vid) for vid in dataset.get_index("test")}
    mean_ap, rec_at_n, _prec = eval_visual_relation(gt, payload["results"])
    return np.array([mean_ap, rec_at_n[50], rec_at_n[100]])


def _run_jax_base(work, args):
    import base as jax_base
    from tspn_tpu.data.segments import get_output_dir, set_output_dir

    cwd, prev_out, argv = os.getcwd(), get_output_dir(), sys.argv
    os.chdir(work)
    try:
        sys.argv = ["base.py", *args]
        jax_base.main()
    finally:
        sys.argv = argv
        os.chdir(cwd)
        set_output_dir(prev_out)


def _run_port_base(work, args):
    proc = subprocess.run(
        [sys.executable, "-m", "tspn_tpu_torch.base", *args, "--device", "cpu"],
        cwd=work, env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _prediction_path(work):
    return work / "vidvrd-baseline-output" / "models" / "baseline_relation_prediction.json"


def _assert_port_detect_matches_jax(work, config, informative=True):
    out = _prediction_path(work)
    args = ["--config", config, "--data_dir", "data", "--dataset", "vidvrd",
            "--detect"]
    _run_jax_base(work, args)
    with open(out) as f:
        ref = json.load(f)
    os.remove(out)

    _run_port_base(work, args)
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    assert got["version"] == "VERSION 1.0"
    assert set(got["results"]) == set(ref["results"])
    m_ref, m_got = _metrics(work, ref), _metrics(work, got)
    if informative:
        assert m_ref[0] > 0.3, m_ref  # the checkpoint is informative
    np.testing.assert_allclose(m_got, m_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["f32", "q8f"])
def test_detect_matches_jax_cli(mode, served_workdir):
    _assert_port_detect_matches_jax(served_workdir, f"{mode}.yaml")


FUSED_ITERS = 30


def _train_overrides(name, max_iter):
    return {
        "MODEL": {"NAME": name, "FUSED_CLASSIFIER": True},
        "SOLVER": {"MAX_ITER": max_iter,
                   "SCHEDULER": {"MILESTONES": [20, 25], "WARMUP_ITERS": 5}},
        "BUCKETS": {"SEGMENTS_PER_STEP": 2},
        "MESH": {"NUM_DEVICES": 1},
        "ETC": {"SAVE_FREQ": 1000, "DISPLAY_FREQ": 10},
    }


@pytest.fixture(scope="module")
def fused_trained(served_workdir):
    """A fused-classifier checkpoint written by ``base.py --train``, and
    its configs for per-file f32 and q8f serving."""
    from tspn_tpu.data.annotations import VidVRD

    work = served_workdir
    data = work / "data" / "vidvrd"
    num_predicates = VidVRD(str(data), str(data / "videos"),
                            ["train", "test"]).get_predicate_num()
    dump = f"jaxfused_weights_iter_{FUSED_ITERS}.pt"
    for mode in ("f32", "q8f"):
        _write_config(work / f"fused_{mode}.yaml", "q8f" if mode == "q8f" else "",
                      num_predicates, dump=dump,
                      **_train_overrides("jaxfused", FUSED_ITERS))
    _run_jax_base(work, ["--config", "fused_f32.yaml", "--data_dir", "data",
                         "--dataset", "vidvrd", "--train"])
    assert (work / "vidvrd-baseline-output" / "models" / dump).exists()
    return work, num_predicates


@pytest.mark.parametrize("mode", ["f32", "q8f"])
def test_detect_fused_checkpoint_matches_jax_cli(mode, fused_trained):
    work, _num_predicates = fused_trained
    _assert_port_detect_matches_jax(work, f"fused_{mode}.yaml", informative=False)


def test_port_train_detect_and_resume(fused_trained):
    from tspn_tpu_torch.runtime.checkpoint import load_checkpoint

    work, num_predicates = fused_trained
    models = work / "vidvrd-baseline-output" / "models"
    for iters in (4, 6):
        _write_config(work / f"port_train_{iters}.yaml", "", num_predicates,
                      dump=f"porttrain_weights_iter_{iters}.pt",
                      **_train_overrides("porttrain", iters))
    args = ["--data_dir", "data", "--dataset", "vidvrd"]
    _run_port_base(work, ["--config", "port_train_4.yaml", *args, "--train",
                          "--detect"])
    assert load_checkpoint(str(models / "porttrain_weights_iter_4.pt"))["step"] == 4
    out = _prediction_path(work)
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    assert got["version"] == "VERSION 1.0" and got["results"]
    for entries in got["results"].values():
        for e in entries:
            assert set(e) == {"triplet", "score", "duration", "sub_traj", "obj_traj"}
            assert 0.0 <= e["score"] <= 1.0

    proc = _run_port_base(work, ["--config", "port_train_6.yaml", *args, "--train",
                                 "--resume"])
    assert "at iter 4" in proc.stdout + proc.stderr
    resumed = load_checkpoint(str(models / "porttrain_weights_iter_6.pt"))
    assert resumed["step"] == 6 and resumed["optimizer"] is not None


def test_cli_refuses_unported_stages(capsys):
    from tspn_tpu_torch import base

    assert base.main(["--preprocess", "--config", "x.yaml"]) == 2
    assert "base.py" in capsys.readouterr().err
    for stage in ("--train", "--detect"):
        with pytest.raises(SystemExit):
            base.main([stage, "--data_dir", "d", "--dataset", "vidvrd"])
        assert "--device" in capsys.readouterr().err
    assert base.main([]) == 0
    assert "--detect" in capsys.readouterr().out


REFUSE = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "flax", "h5py", "yaml", "msgpack", "tspn_tpu"}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused " + name)
        return None
sys.meta_path.insert(0, Refuse())
import tspn_tpu_torch.runtime.predict, tspn_tpu_torch.data.synthetic
import tspn_tpu_torch.runtime.train, tspn_tpu_torch.solver.optim
import tspn_tpu_torch.parallel.train_step, tspn_tpu_torch.models.tspn
import tspn_tpu_torch.runtime.checkpoint, tspn_tpu_torch.base
import tspn_tpu_torch
for info in pkgutil.walk_packages(tspn_tpu_torch.__path__, "tspn_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imports ok")
"""


def test_device_path_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", REFUSE], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imports ok" in proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(where, tmp_path):
    import torch

    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
