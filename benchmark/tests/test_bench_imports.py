"""What the benchmark may import: no module of it imports JAX, its
libraries or the JAX package (top-level names compared whole, since the
port's name begins with the JAX package's), and the plain reference
imports nothing of the port, also through the benchmark's modules it
uses."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BANNED = {"jax", "jaxlib", "flax", "tspn_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path):
    """Every module name a file imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    tops = {n.split(".", 1)[0] for n in imported(path)}
    assert not tops & BANNED, f"{path} imports {tops & BANNED}"


def _closure(start: Path):
    """The benchmark modules ``start`` reaches by import, and the foreign
    top-level names they import."""
    seen, foreign, todo = set(), set(), [start]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path):
            if name.split(".", 1)[0] == "benchmark":
                rel = Path(*name.split(".")[1:])
                for cand in (ROOT / rel.with_suffix(".py"), ROOT / rel / "__init__.py"):
                    if cand.exists():
                        todo.append(cand)
            else:
                foreign.add(name.split(".", 1)[0])
    return seen, foreign


@pytest.mark.parametrize("name", ["detector.py", "trainer.py", "ops.py"])
def test_reference_imports_nothing_of_the_port(name):
    _seen, foreign = _closure(ROOT / "reference" / name)
    assert foreign <= {"__future__", "math", "typing", "numpy", "torch"}, foreign


def test_jax_modules_compares_whole_top_level_names():
    names = ["tspn_tpu_torch", "tspn_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert harness.jax_modules(names) == []
    assert harness.jax_modules(names + ["jax.numpy", "tspn_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "tspn_tpu.ops"]
