"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the plain reference imports nothing of the port."""

import ast
import sys

import pytest
from conftest import BENCH

from benchmark.lib import harness

FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "pyaudiorestoration_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & {"pyaudiorestoration_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyaudiorestoration_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pyaudiorestoration_tpu.utils", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax", "pyaudiorestoration_tpu"]
