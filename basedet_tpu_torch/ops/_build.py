"""Building the port's CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Each source in ``basedet_tpu_torch/csrc/`` is compiled at first use into
``basedet_tpu_torch/_build/libbasedet_<stem>_<hash>.so``. The hash covers the
source and the flags, so an edit rebuilds; delete ``_build/`` to force a
rebuild. Nothing here runs at import: the machine that runs the CPU tests has
no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    for root in (CUDA_HOME, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def library_path(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"libbasedet_{source.stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: Path, flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, str]:
    """Compile ``source`` into a shared library unless it is already built.
    Returns the library's path and the compiler's output (ptxas register and
    shared-memory report), empty when nothing was compiled. Safe to call for
    several sources at once from threads: each writes its own file."""
    out = library_path(source, flags)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, compiled first if need be."""
    return ctypes.CDLL(str(build_library(source)[0]))
