"""Building the host library: ``native_ops.cpp`` compiled with
``c++ -O3 -fPIC -shared -fopenmp -std=c++17`` at its first use (never at
import) into ``basedet_tpu_torch/_build/native_ops-<hash>.so``, the hash over
the source and the flags, and loaded with ``ctypes``.

The compiler writes a temporary file that ``os.replace`` renames, so that
processes building at once (DataLoader workers, test workers) never load a
half-written library. A build that fails raises: nothing falls back to the
plain versions, which the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "native_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"native_ops-{digest}.so"


def _compiler() -> str:
    """``c++`` (else ``g++``) from ``PATH``. ``$CXX`` is not read: an
    environment may point it at a GCC built without OpenMP's spec file,
    which ``-fopenmp`` needs."""
    for name in ("c++", "g++"):
        if shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler (c++ or g++) found: basedet_tpu_torch/native needs one at first use")


def build() -> Path:
    """The library's path, compiled first where it is not built yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    pp = ctypes.POINTER(ctypes.c_void_p)
    u8p, i8p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    common = [pp, i32p, i64, i64, i64, i64]
    lib.pack_batch_u8.argtypes = common + [ctypes.c_uint8, u8p, u8p, ctypes.c_int]
    lib.pack_batch_f32.argtypes = common + [ctypes.c_float, f32p, u8p, ctypes.c_int]
    lib.native_num_threads.argtypes = []
    lib.match_dets.argtypes = [f64p, i32p, i32p, i64, i64, f64p, i64, i64p, i64p, i32p]
    lib.coco_match_area.argtypes = [i64, i64p, i64p, i64p, i64p, i64p, f64p, f64p, f64p, i32p,
                                    ctypes.c_double, ctypes.c_double, f64p, i64, i8p, i8p, i64p]
    for fn in (lib.pack_batch_u8, lib.pack_batch_f32, lib.native_num_threads, lib.match_dets, lib.coco_match_area):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The bound library, compiled first if need be; raises where it cannot
    be built or loaded."""
    return _bind(ctypes.CDLL(str(build())))


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned {rc}")
