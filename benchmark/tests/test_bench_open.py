"""The harness takes a new architecture as files alone. A checkout of the
benchmark as it is, with the toy architecture's files (``toy/``: its
module, reference, configuration, traffic, limits and a metric reader)
copied in and its entries (``toy/entries.json``) added to BENCHMARK.json,
runs the toy's training and detection cells through ``harness.run_cell``
on the CPU, traced, with the toy's reference in the program's place. No
file of the harness names the toy."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.archs import rc4

TOY = Path(__file__).resolve().parent / "toy"
CELLS = ("toy.train", "toy.detect")

# run in the checkout: each toy cell once, and what metric_context gave its readers
RUN = r"""
import json, time
import torch
from benchmark import control, harness

torch.set_num_threads(2)
seen = {}
context = harness.metric_context


def spy(c, out, dt):
    ctx = context(c, out, dt)
    seen[c.name] = {"shapes": out["shapes"], "units": ctx.units, "steps": ctx.steps,
                    "work": ctx.work, "config_arch": ctx.config["arch"]}
    return ctx


harness.metric_context = spy
bench = harness.load_json(harness.REPO / "BENCHMARK.json")
runs = {"root": str(harness.REPO)}
for name in %r:
    c = harness.cell(bench, name)
    factory = control.control_factory(c.traffic["kind"], c.config["compute_dtype"])
    result, _log = harness.run_cell(c, 2 ** 31 + 17, 0.3, True, torch.device("cpu"),
                                    time.perf_counter(), factory)
    runs[name] = {"result": result, **seen[name]}
print(json.dumps(runs))
""" % (CELLS,)


def toy_module():
    spec = importlib.util.spec_from_file_location("toy_arch", TOY / "archs" / "toy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def toy_config():
    return harness.load_json(TOY / "configs" / "toy.json")


def scaled(per, units, steps):
    return {**{k: v * units for k, v in per["unit"].items()},
            **{k: v * steps for k, v in per["step"].items()}}


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.ROOT, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in TOY.rglob("*"):
        if path.is_file() and path.name != "entries.json" and "__pycache__" not in path.parts:
            dest = root / "benchmark" / path.relative_to(TOY)
            assert not dest.exists(), f"{dest} would replace a file of the harness"
            shutil.copy(path, dest)
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    entries = harness.load_json(TOY / "entries.json")
    for group in ("configs", "workloads", "per_layer"):
        bench[group] += entries[group]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += entries["end_to_end_workloads"].get(m["name"], [])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert Path(runs.pop("root")) == root
    return runs


@pytest.mark.parametrize("name", CELLS)
def test_toy_cell_runs_correct(toy_runs, name):
    r = toy_runs[name]["result"]
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["compared"]
    assert toy_runs[name]["config_arch"] == "toy"


@pytest.mark.parametrize("name", CELLS)
def test_metric_context_carries_the_toys_work(toy_runs, name):
    run = toy_runs[name]
    train = name.endswith(".train")
    units, steps = run["units"], run["steps"]
    assert units > 0 and steps > 0
    work = scaled(toy_module().work(toy_config(), run["shapes"], train), units, steps)
    assert run["work"] == work and "fc_flops" in work
    assert work != scaled(rc4.work(toy_config(), run["shapes"], train), units, steps)
    share = run["result"]["metrics"][f"fc_head_share.{name.split('.')[1]}"]["value"]
    assert share == pytest.approx(100.0 * work["fc_flops"] / work["model_flops"], rel=1e-12)


def test_the_toy_differs_from_c4():
    toy, config = toy_module(), toy_config()
    names = [p.name for p in toy.param_specs(config)]
    c4 = [p.name for p in rc4.param_specs(config)]
    assert "box_head.fc1.weight" in names and not any(n.startswith("res5.") for n in names)
    assert any(n.startswith("res5.") for n in c4)
    ref = (TOY / "reference" / "toy.py").read_text()
    assert "def box_head" in ref and "box_head.fc1" in ref


def test_no_harness_file_names_the_toy():
    files = [harness.REPO / "BENCHMARK.json"] + [
        p for p in harness.ROOT.rglob("*")
        if p.is_file() and p.suffix in (".py", ".json")
        and p.relative_to(harness.ROOT).parts[0] != "tests"]
    assert len(files) > 20
    for path in files:
        assert not re.search(r"\btoy\b", path.read_text(), re.IGNORECASE), path
