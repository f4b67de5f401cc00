"""No module of perfbench/ imports JAX or the JAX package, and the plain reference imports nothing of
the program: each import's top-level name (the part before the first dot) compared whole, so that
``vo_tpu_torch`` is not taken for ``vo_tpu``."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "vo_tpu"}


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules() if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "dataclasses", "json", "math", "typing", "numpy", "torch"}


def test_names_compared_whole():
    assert "vo_tpu_torch".split(".")[0] not in FORBIDDEN
