"""What the benchmark may import: no module of it imports JAX, its
libraries or the JAX package (top-level names compared whole, since the
port's name begins with the JAX package's), and neither the plain
reference nor an architecture module imports anything of the port, also
through the benchmark's modules it uses. Each file is found by a glob, so
a new one is checked with no edit here."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BANNED = {"jax", "jaxlib", "flax", "tspn_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path):
    """Every module name a file imports, at any depth (``from m import n``
gives ``m`` and ``m.n``, which may be a module)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    tops = {n.split(".", 1)[0] for n in imported(path)}
    assert not tops & BANNED, f"{path} imports {tops & BANNED}"


def _closure(start: Path):
    """The benchmark files ``start`` reaches by import, with the packages
    each import runs on its way, and the foreign top-level names each of
    them imports: {path: names}."""
    foreign, todo = {}, [start]
    while todo:
        path = todo.pop()
        if path in foreign:
            continue
        foreign[path] = set()
        for name in imported(path):
            top, *parts = name.split(".")
            if top != "benchmark":
                foreign[path].add(top)
                continue
            todo += [c for k in range(len(parts) + 1)
                     for c in (ROOT.joinpath(*parts[:k], "__init__.py"),
                               ROOT.joinpath(*parts[:k - 1], f"{parts[k - 1]}.py") if k else None)
                     if c is not None and c.exists()]
    return foreign


PLAIN = sorted((ROOT / "reference").rglob("*.py")) + sorted((ROOT / "archs").rglob("*.py"))
ALLOWED = {"__future__", "math", "typing", "numpy", "torch"}
# ``archs.of`` imports ``benchmark.archs.<arch>`` by name, and each module
# it can reach so is a file of PLAIN, checked on its own
LOADER = ROOT / "archs" / "__init__.py"


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_port(path):
    for seen, foreign in _closure(path).items():
        extra = {"importlib"} if seen == LOADER else set()
        assert foreign <= ALLOWED | extra, (str(seen.relative_to(ROOT)), foreign)


def test_the_architecture_loader_imports_only_under_benchmark_archs():
    assert {n.split(".", 1)[0] for n in imported(LOADER)} == {"__future__", "importlib"}
    tree = ast.parse(LOADER.read_text())
    assert not any(isinstance(n, ast.Name) and n.id == "__import__" for n in ast.walk(tree))
    uses = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "importlib"]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and n.func in uses]
    assert uses and len(calls) == len(uses)
    for call in calls:
        assert call.func.attr == "import_module" and len(call.args) == 1 and not call.keywords
        head = call.args[0].values[:2] if isinstance(call.args[0], ast.JoinedStr) else []
        assert ast.unparse(head[0]) == "{__name__}" and head[1].value.startswith("."), \
            ast.unparse(call)


def test_the_checks_cover_every_reference_and_architecture():
    assert {"reference/rc4.py", "reference/rcnn.py", "archs/rc4.py", "archs/__init__.py"} <= {
        str(p.relative_to(ROOT)) for p in PLAIN}
    assert set(PLAIN) <= set(SOURCES)
    assert LOADER in _closure(ROOT / "reference" / "rc4.py")


def test_jax_modules_compares_whole_top_level_names():
    names = ["tspn_tpu_torch", "tspn_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert harness.jax_modules(names) == []
    assert harness.jax_modules(names + ["jax.numpy", "tspn_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "tspn_tpu.ops"]
