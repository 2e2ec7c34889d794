"""Nothing under detbench/ imports JAX or the JAX package, and the reference
imports nothing of the port. Top-level module names are compared whole:
``basedet_tpu_torch`` is not ``basedet_tpu``."""
from __future__ import annotations

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "basedet_tpu"}


def imported_top_levels(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not set(imported_top_levels(path)) & FORBIDDEN, path


def test_the_reference_takes_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "basedet_tpu_torch" not in set(imported_top_levels(path)), path


def test_the_check_compares_whole_names():
    import sys

    import run

    sys.modules.setdefault("basedet_tpu_torch_probe", sys)
    assert "basedet_tpu" not in run.forbidden_modules()
    sys.modules["jaxlib_probe.sub"] = sys
    try:
        assert "jaxlib" not in run.forbidden_modules()
    finally:
        del sys.modules["jaxlib_probe.sub"], sys.modules["basedet_tpu_torch_probe"]
