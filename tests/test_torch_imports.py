"""The port stands alone: no module of sienerf_torch/, and not
chip_smoke.py, imports JAX or the JAX package (`jax`, `jaxlib`,
`sienerf_tpu`), at the top or inside a function.  Only the tests import
both."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "sienerf_tpu")
SOURCES = sorted((ROOT / "sienerf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append((node.lineno, str(node.args[0].value)))
    return out


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_every_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nimport jax.numpy as jnp\nfrom sienerf_tpu.io import exr\n"
                 "def g():\n    from jaxlib import xla_client\n    __import__('jax')\n"
                 "from . import sibling\n")
    assert [n for _, n in _imports(f) if _forbidden(n)] == [
        "jax.numpy", "sienerf_tpu.io", "jaxlib", "jax"]
    assert len(SOURCES) > 40
