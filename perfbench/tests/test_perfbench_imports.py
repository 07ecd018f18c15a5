"""What the harness may import: the reference nothing of the served
package or of JAX, and no file of the harness JAX or the JAX package
(top-level module names compared whole: ``dvd_tpu_torch`` begins with
``dvd_tpu``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = set(top_imports(path)) & {"dvd_tpu_torch", "dvd_tpu", "jax",
                                    "jaxlib", "flax"}
    assert not bad, (path, bad)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    bad = set(top_imports(path)) & {"dvd_tpu", "jax", "jaxlib", "flax"}
    assert not bad, (path, bad)


def test_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    from perfbench import harness

    monkeypatch.setitem(sys.modules, "dvd_tpu_torch_like", types.ModuleType("x"))
    assert harness.loaded_forbidden() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib.fake" in harness.loaded_forbidden()
