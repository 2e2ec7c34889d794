"""``setup.py`` for the port, read with ``ast`` (nothing is installed): every
console script of ``basedet_tpu_torch`` names a module whose ``main`` is
callable, the JAX package's scripts are all still there, and every source
that the port compiles at run time (``ops/_build.py``'s CUDA kernels, the
headers they include, ``native/build.py``'s host library) matches a
``package_data`` glob, so that an installed port can build them."""
import ast
import fnmatch
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "basedet_tpu_torch"
PORT_TOOLS = ("train", "test", "profile", "trace", "dump_cfg", "benchmark", "analyze")


def _setup_kwargs():
    tree = ast.parse((REPO / "setup.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "setup")
    return {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords
            if kw.arg in ("package_data", "entry_points", "name")}


def _scripts():
    lines = _setup_kwargs()["entry_points"]["console_scripts"]
    return dict(tuple(part.strip() for part in line.split("=")) for line in lines)


def test_port_console_scripts_resolve_to_callable_mains():
    scripts = _scripts()
    port = {name: target for name, target in scripts.items() if target.startswith("basedet_tpu_torch.")}
    assert sorted(port) == sorted(f"basedet_torch_{tool}" for tool in PORT_TOOLS)
    for name, target in port.items():
        module, func = target.split(":")
        assert func == "main", name
        assert callable(getattr(importlib.import_module(module), func)), name


def test_jax_console_scripts_stay():
    scripts = _scripts()
    assert {f"basedet_{tool}": f"basedet_tpu.tools.{module}:main" for tool, module in (
        ("train", "det_train"), ("test", "det_test"), ("profile", "profile_net"), ("trace", "trace_net"),
        ("dump_cfg", "dump_cfg"), ("benchmark", "benchmark"), ("analyze", "analyze_net"))}.items() <= scripts.items()


def _compiled_sources():
    from basedet_tpu_torch.native import build as native_build
    from basedet_tpu_torch.ops import (fused_bn_kernel, iou_kernel, matching_kernel, nms_kernel, roi_align_kernel,
                                       scatter_rows_kernel)

    sources = [m.SOURCE for m in (nms_kernel, matching_kernel, roi_align_kernel, fused_bn_kernel,
                                  scatter_rows_kernel, iou_kernel)] + [native_build._SRC]
    included = [src.parent / name for src in sources
                for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M)]
    return sources + included


@pytest.mark.parametrize("source", _compiled_sources(), ids=lambda p: p.name)
def test_compiled_sources_are_package_data(source):
    assert source.exists()
    rel = source.resolve().relative_to(PORT).as_posix()
    globs = _setup_kwargs()["package_data"]["basedet_tpu_torch"]
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
