"""BENCHMARK.json against the benchmark's contract: names, units, counts
and limits, and every file a cell needs found by its name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# a changed key may never be a width
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head_size|"
                    r"expansion|experts_per_tok|width|channels)", re.IGNORECASE)
CELLS = [w["name"] for w in BENCH["workloads"]]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_paths_and_command():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_names_units_and_lines():
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"])
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
    for m in BENCH["per_layer"]:
        assert line_ok(m["layer"])
    for c in BENCH["configs"]:
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_cells_report_what_they_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layers and all(w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
                              for m in layers)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_configs_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        # ``reduced`` names each key whose value differs from the source,
        # the file holds it, and none is a width
        assert list(conf["source_values"]) == c["reduced"]
        for key in c["reduced"]:
            assert key in conf and conf[key] != conf["source_values"][key]
            assert not WIDTHS.search(key)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    c = harness.cell(BENCH, workload)
    assert (harness.ROOT / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")
    file_names = [str(p.relative_to(REPO)) for p in Path(harness.ROOT).rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts]
    assert all(PATH.match(f) for f in file_names)
