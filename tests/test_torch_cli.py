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
  checkpoint's step. With a config like configs/tspn_config.yaml (the
  PPN on, span mode off) plus PRUNE_AT_INFERENCE, ``--train`` trains the
  PPN head too and ``--detect`` serves the q8f store PPN-pruned. With
  ``MODEL.DTYPE: bfloat16`` (unfused and fused) ``--train --detect`` runs
  and the checkpoint keeps f32 parameters.
* ``--train`` and ``--detect`` run on ``cuda`` unless ``--device`` names
  another device; without a card that default stops with a hint.
* No file of the port, and not chip_smoke.py, imports ``tspn_tpu``: a
  static walk of every import statement (and ``import_module`` call) at
  any depth. Besides, the device path imports none of jax, flax,
  ml_dtypes, h5py, yaml, msgpack or tspn_tpu: a subprocess whose import system refuses
  them imports every module of tspn_tpu_torch and chip_smoke.
* chip_smoke.py exits nonzero and prints no result without a CUDA
  device, and in a directory without the package.
"""

from __future__ import annotations

import ast
import glob
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


def test_port_train_detect_tspn_config(served_workdir):
    """--train then --detect with the PPN on (configs/tspn_config.yaml's
    RELPN, span mode off) and PPN pruning at inference, on the CPU."""
    from tspn_tpu.data.annotations import VidVRD
    from tspn_tpu_torch.runtime.checkpoint import load_checkpoint

    work = served_workdir
    data = work / "data" / "vidvrd"
    num_predicates = VidVRD(str(data), str(data / "videos"),
                            ["train", "test"]).get_predicate_num()
    overrides = _train_overrides("porttspn", 4)
    overrides["MODEL"]["FUSED_CLASSIFIER"] = False
    overrides["RELPN"] = {"USE_PPN": True, "USE_DPN": False,
                          "PPN": {"PRUNE_AT_INFERENCE": True, "NUM_PAIR_PROPOSALS": 8}}
    _write_config(work / "port_tspn.yaml", "q8f", num_predicates,
                  dump="porttspn_weights_iter_4.pt", **overrides)
    _run_port_base(work, ["--config", "port_tspn.yaml", "--data_dir", "data",
                          "--dataset", "vidvrd", "--train", "--detect"])
    ckpt = load_checkpoint(str(work / "vidvrd-baseline-output" / "models"
                               / "porttspn_weights_iter_4.pt"))
    assert ckpt["step"] == 4
    assert {k for k in ckpt["state_dict"] if k.startswith("ppn_head.")} == {
        f"ppn_head.{role}_fc{i}.{p}" for role in ("sub", "obj") for i in (1, 2)
        for p in ("weight", "bias")}
    out = _prediction_path(work)
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    assert got["version"] == "VERSION 1.0" and got["results"]
    for entries in got["results"].values():
        for e in entries:
            assert 0.0 <= e["score"] <= 1.0 and len(e["triplet"]) == 3


@pytest.mark.parametrize("fused", [False, True])
def test_port_train_detect_bf16(fused, served_workdir):
    """--train then --detect with MODEL.DTYPE bfloat16 on the CPU: the
    checkpoint's parameters stay f32, and the prediction JSON is valid
    (the fused classifier serves through K3's bf16 plain version)."""
    from tspn_tpu.data.annotations import VidVRD
    from tspn_tpu_torch.runtime.checkpoint import load_checkpoint

    work = served_workdir
    data = work / "data" / "vidvrd"
    num_predicates = VidVRD(str(data), str(data / "videos"),
                            ["train", "test"]).get_predicate_num()
    name = f"portbf16{int(fused)}"
    overrides = _train_overrides(name, 4)
    overrides["MODEL"].update({"FUSED_CLASSIFIER": fused, "DTYPE": "bfloat16"})
    _write_config(work / f"{name}.yaml", "", num_predicates,
                  dump=f"{name}_weights_iter_4.pt", **overrides)
    _run_port_base(work, ["--config", f"{name}.yaml", "--data_dir", "data",
                          "--dataset", "vidvrd", "--train", "--detect"])
    ckpt = load_checkpoint(str(work / "vidvrd-baseline-output" / "models"
                               / f"{name}_weights_iter_4.pt"))
    assert ckpt["step"] == 4
    assert all(str(v.dtype) == "torch.float32" for v in ckpt["state_dict"].values())
    out = _prediction_path(work)
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    assert got["version"] == "VERSION 1.0" and got["results"]
    for entries in got["results"].values():
        for e in entries:
            assert 0.0 <= e["score"] <= 1.0 and len(e["triplet"]) == 3


def test_cli_refuses_unported_stages(capsys):
    import torch

    from tspn_tpu_torch import base

    assert base.main(["--preprocess", "--config", "x.yaml"]) == 2
    assert "base.py" in capsys.readouterr().err
    assert base.build_parser().parse_args(["--detect"]).device == "cuda"
    if not torch.cuda.is_available():
        for stage in ("--train", "--detect"):
            with pytest.raises(SystemExit):
                base.main([stage, "--data_dir", "d", "--dataset", "vidvrd"])
            assert "--device cpu" in capsys.readouterr().err
    assert base.main([]) == 0
    assert "--detect" in capsys.readouterr().out


def _tspn_tpu_imports(source: str, name: str = "<source>") -> list:
    """(line, module) of every import of tspn_tpu (not tspn_tpu_torch) in
    ``source``, at any depth: import statements, absolute from-imports,
    and import_module / __import__ calls with a literal name."""
    found = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            modules = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            modules = [node.args[0].value]
        else:
            continue
        found += [(node.lineno, m) for m in modules if m.split(".")[0] == "tspn_tpu"]
    return found


@pytest.mark.parametrize("snippet,hits", [
    ("def f():\n    from tspn_tpu.data import segments\n", 1),
    ("class A:\n    def g(self):\n        import tspn_tpu.config as c\n", 1),
    ("import importlib\nimportlib.import_module('tspn_tpu.association')\n", 1),
    ("import tspn_tpu\n", 1),
    ("from tspn_tpu_torch.data import segments\nimport tspn_tpu_torch\n", 0),
    ("from . import layout\n", 0),
])
def test_static_import_check_finds_nested_imports(snippet, hits):
    assert len(_tspn_tpu_imports(snippet)) == hits


def test_port_imports_nothing_of_tspn_tpu():
    files = sorted(glob.glob(os.path.join(REPO, "tspn_tpu_torch", "**", "*.py"),
                             recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 25
    found = []
    for path in files:
        with open(path) as f:
            found += [(os.path.relpath(path, REPO), *hit)
                      for hit in _tspn_tpu_imports(f.read(), path)]
    assert not found, found


REFUSE = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "flax", "ml_dtypes", "h5py", "yaml", "msgpack", "tspn_tpu"}
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
import tspn_tpu_torch.config, tspn_tpu_torch.data.segments
import tspn_tpu_torch.data.annotations, tspn_tpu_torch.data.trajectory
import tspn_tpu_torch.association, tspn_tpu_torch.runtime.logging_utils
import tspn_tpu_torch.data.vrdataset, tspn_tpu_torch.data.preprocess
import tspn_tpu_torch.models.ppn
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
