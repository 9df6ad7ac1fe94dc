"""Nothing the runner imports, nor the reference, has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``ccd_tpu`` (compared whole: the port's
``ccd_tpu_torch`` begins with it), and the reference imports nothing of
the program."""

import ast
import os

import pytest

from portbench import harness

BENCH = harness.HERE


def imported_top_levels(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted(sources(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "ccd_tpu_torch" not in imported_top_levels(path)


def test_banned_names_compared_whole():
    import sys
    sys.modules.setdefault("ccd_tpu_torch_lookalike", sys)
    try:
        assert "ccd_tpu_torch_lookalike" not in harness.banned_modules()
    finally:
        del sys.modules["ccd_tpu_torch_lookalike"]
