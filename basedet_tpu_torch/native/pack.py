"""The batch pack through the host library (``pack_batch_u8`` /
``pack_batch_f32``): variable-size HWC images into a (B, H, W, C) canvas,
each at its top left, the rest ``pad``, with the valid-pixel mask in the same
pass. ``data/collators/pack.py::pack_numpy`` is its plain version."""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from basedet_tpu_torch.native.build import check, load

_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)


def _threads() -> int:
    """All the library's threads in the main process; one in a DataLoader
    worker, whose OpenMP runtime was forked from the parent's."""
    return 1 if torch.utils.data.get_worker_info() is not None else max(1, load().native_num_threads())


def pack_into(images: List[np.ndarray], pad: float, out: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
    """Fill ``out`` (B, H, W, C), uint8 or float32 and C-contiguous, with
    ``images`` (each cast to its dtype) and ``mask`` (B, H, W) uint8, where
    given, with 1 on each image's pixels and 0 elsewhere."""
    lib = load()
    B, H, W, C = out.shape
    if not out.flags.c_contiguous or (mask is not None and (mask.shape != (B, H, W) or not mask.flags.c_contiguous)):
        raise ValueError("pack_into needs C-contiguous canvases of matching shapes")
    src = [np.ascontiguousarray(i, dtype=out.dtype) for i in images]
    if len(src) != B or any(i.ndim != 3 or i.shape[2] != C or i.shape[0] > H or i.shape[1] > W for i in src):
        raise ValueError(f"images {[i.shape for i in src]} do not fit a canvas of {out.shape}")
    hw = np.asarray([i.shape[:2] for i in src], np.int32).reshape(B, 2)
    ptrs = (ctypes.c_void_p * max(B, 1))(*[i.ctypes.data for i in src])
    mask_ptr = mask.ctypes.data_as(_U8P) if mask is not None else ctypes.cast(None, _U8P)
    hw_ptr = hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if out.dtype == np.uint8:
        rc = lib.pack_batch_u8(ptrs, hw_ptr, B, H, W, C, int(pad), out.ctypes.data_as(_U8P), mask_ptr, _threads())
    elif out.dtype == np.float32:
        rc = lib.pack_batch_f32(ptrs, hw_ptr, B, H, W, C, float(pad), out.ctypes.data_as(_F32P), mask_ptr,
                                _threads())
    else:
        raise ValueError(f"the pack takes uint8 or float32 canvases, not {out.dtype}")
    check(rc, "pack_batch")
