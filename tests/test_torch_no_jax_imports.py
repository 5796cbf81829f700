"""No module of the port (``tcsfm_torch/``), nor ``chip_smoke.py``, imports
JAX or the JAX package ``tcsfm``: the card's machine has no JAX. Nor
``msgpack``, which it does not have either (the checkpoints' codec is the
port's own, ``tcsfm_torch/train/checkpoint.py``).

An AST walk of every source file, since ``tests/conftest.py`` imports JAX
and so ``sys.modules`` cannot tell. It reads ``import`` and ``from ...
import`` statements at any depth (inside functions too), and calls of
``importlib.import_module``/``__import__`` with a literal name.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tcsfm", "msgpack")
SOURCES = sorted(ROOT.joinpath("tcsfm_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_the_walk_sees_every_form():
    src = ("import jax\nfrom tcsfm.config import Config\n"
           "def f():\n    import tcsfm.solver.pft as p\n"
           "    importlib.import_module('flax.core')\n"
           "from tcsfm_torch import infer\nimport torch\n")
    assert [n for n in imported_names(ast.parse(src)) if forbidden(n)] == [
        "jax", "tcsfm.config", "tcsfm.solver.pft", "flax.core"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    names = list(imported_names(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
