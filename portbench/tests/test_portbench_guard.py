"""The import guard compares whole top-level names, and nothing the
benchmark runs imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

from portbench import guard

HERE = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("voxelized_geometry_tools_tpu", True),
    ("voxelized_geometry_tools_tpu.ops.edt", True),
    ("voxelized_geometry_tools_tpu_torch", False),
    ("voxelized_geometry_tools_tpu_torch.ops.edt", False),
    ("jaxtyping", False), ("torch", False),
])
def test_top_level_names_compared_whole(name, bad):
    assert (guard.forbidden([name]) != []) == bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert guard.forbidden(_imports(path)) == []


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    mods = {guard.top_level(m) for m in _imports(path)}
    assert mods <= {"__future__", "typing", "numpy", "torch"}, mods


def test_nothing_reads_the_jax_benchmarks():
    for p in _sources():
        text = p.read_text()
        for name in ("bench.py", "benchmarks/", "BASELINE", "BENCH_r"):
            assert name not in text, (p, name)
