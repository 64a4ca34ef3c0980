"""No module of perfbench/ imports JAX, Flax or the JAX package, and the
reference imports nothing of the program.  Names are compared as whole
top-level names: the port's name begins with the JAX package's letters."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from perfbench import spec
from perfbench.run import FORBIDDEN, forbidden_modules

PROGRAM = "sienerf_torch"


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.PACKAGE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.PACKAGE / "reference").rglob("*.py"):
        assert PROGRAM not in _top_level_imports(path), path
        assert "perfbench.kinds" not in path.read_text()


def test_the_check_compares_whole_top_level_names(monkeypatch):
    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "sienerf_tpu_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "sienerf_tpu.ops", sys)
    assert "sienerf_tpu" in forbidden_modules()
