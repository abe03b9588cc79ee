"""No module of the benchmark imports JAX, Flax or the JAX package (the
top-level name compared whole: the port's `repro_torch` begins with
`repro`), and the references import nothing of the program."""

import ast
from pathlib import Path

import pytest

from perfbench import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names():
    import sys

    sys.modules.setdefault("repro_torch_probe_module", sys)
    try:
        assert "repro_torch_probe_module" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_probe_module", None)
