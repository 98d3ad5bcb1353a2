"""Nothing under perfbench/ imports JAX or the JAX package, by the
top-level name of each imported module compared whole (the port's name
begins with the JAX package's and passes); the reference imports nothing
of the program either."""

import ast
import sys
from pathlib import Path

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "flute_tpu"}
SOURCES = sorted(tiny.HOME.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_sources_are_found():
    assert tiny.HOME / "run.py" in SOURCES and len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(tiny.HOME)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((tiny.HOME / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "flute_tpu_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules.pop("flute_tpu", None)
        before = run.forbidden_modules()
        sys.modules["flute_tpu_torch_probe.x"] = object()
        assert run.forbidden_modules() == before
        sys.modules["flute_tpu.probe"] = object()
        assert "flute_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
