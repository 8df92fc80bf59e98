"""No module under portbench/ imports jax, jaxlib, flax or the JAX
package physics_tpu, and the reference imports nothing of the program,
compared by whole top-level module name (physics_tpu_torch is not
physics_tpu): an AST scan of every import."""

import ast

import pytest

from portbench.tests.tiny import ROOT

FILES = sorted((ROOT / "portbench").rglob("*.py"))


def modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def imported(path):
    return {m.split(".")[0] for m in modules(path)}


def test_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax",
                                      "physics_tpu"}


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench/reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "physics_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "types", "typing",
                     "numpy", "torch", "portbench"}
    # within the benchmark, only the reference itself
    assert all(m.startswith("portbench.reference")
               for m in modules(path) if m.startswith("portbench"))
