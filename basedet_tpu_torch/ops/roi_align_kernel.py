"""Multilevel RoIAlign forward: the CUDA kernel in ``csrc/roi_align.cu``, its
wrapper, and the dispatch ``pool_rois_multilevel``.

Replaces the JAX package's two Pallas forwards of one function,
``basedet_tpu/ops/roi_align_window.py::_fwd_kernel_win`` and
``basedet_tpu/ops/roi_align_pallas.py::_fwd_kernel``. The plain version is
``ops/roi_align.py::multilevel_roi_align_plain``.

On the card the kernel is bound by bytes: at Faster R-CNN's eval shape (one
image, 1000 RoIs, 256 channels) the output alone is 50.2 MB and P2-P5 are
91.4 MB, of which proposal-like RoIs touch about four fifths. The wrapper copies each level to channels-last, so that the
kernel's consecutive threads read and write consecutive channels; that copy
is part of the wrapper's time. One launch pools every level and image. No
gradient: the wrapper refuses features that require one (the backward comes
with training).

The kernel is built from the repository's source at first use and bound with
``ctypes`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment

SOURCE = CSRC / "roi_align.cu"
MAX_LEVELS = 4


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_roi_align_fwd
    i32p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i32p, i32p, i32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(features, rois, levels, strides) -> None:
    if not 1 <= len(features) <= MAX_LEVELS or len(strides) != len(features):
        raise ValueError(f"need 1-{MAX_LEVELS} levels with one stride each, got "
                         f"{len(features)} levels and strides {tuple(strides)}")
    B, C = features[0].shape[:2]
    for f in features:
        if f.dim() != 4 or f.shape[:2] != (B, C) or f.dtype != torch.float32:
            raise ValueError(f"features must be f32 (B, C, H, W) with one B and C, got "
                             f"{[(tuple(x.shape), x.dtype) for x in features]}")
        if f.device != rois.device:
            raise ValueError("features and rois lie on different devices")
        if f.requires_grad:
            raise NotImplementedError("RoIAlign's backward is not ported yet: features require grad")
    if rois.dim() != 3 or rois.shape[0] != B or rois.shape[2] != 4 or rois.dtype != torch.float32:
        raise ValueError(f"rois must be f32 (B, R, 4), got {rois.dtype} {tuple(rois.shape)}")
    if levels.shape != rois.shape[:2] or levels.dtype != torch.int32 or levels.device != rois.device:
        raise ValueError(f"levels must be int32 {tuple(rois.shape[:2])} beside the rois, got "
                         f"{levels.dtype} {tuple(levels.shape)}")


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    output_size: Tuple[int, int] = (7, 7),
) -> torch.Tensor:
    """features per level (B, C, H_l, W_l) f32, rois (B, R, 4) xyxy, levels
    (B, R) int32 0-based level ids → (B, R, ph, pw, C) f32.

    A CUDA tensor goes through the kernel (``multilevel_roi_align.launches``
    counts its launches); a CPU tensor goes through the plain version."""
    _check(features, rois, levels, strides)
    if rois.device.type == "cpu":
        return multilevel_roi_align_plain(features, rois, levels, strides, output_size)
    if rois.device.type != "cuda":
        raise ValueError(f"no RoIAlign kernel for device {rois.device}")
    B, R = levels.shape
    C = features[0].shape[1]
    ph, pw = output_size
    out = torch.empty((B, R, ph, pw, C), dtype=torch.float32, device=rois.device)
    nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in features]
    rois, levels = rois.contiguous(), levels.contiguous()
    n = len(nhwc)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in nhwc])
    heights = (ctypes.c_int * n)(*[f.shape[1] for f in nhwc])
    widths = (ctypes.c_int * n)(*[f.shape[2] for f in nhwc])
    strides_c = (ctypes.c_int * n)(*[int(s) for s in strides])
    lib = _library()
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        err = lib.basedet_roi_align_fwd(ptrs, heights, widths, strides_c, n, rois.data_ptr(),
                                        levels.data_ptr(), B, R, C, ph, pw, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign kernel launch failed: CUDA error {err}")
    multilevel_roi_align.launches += 1
    return out


multilevel_roi_align.launches = 0


def pool_rois_multilevel(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    strides: Sequence[int],
    output_size: Tuple[int, int] = (7, 7),
) -> torch.Tensor:
    """Batched multilevel RoIAlign → (B, R, ph, pw, C) (counterpart of
    ``basedet_tpu/ops/roi_align_pallas.py::pool_rois_multilevel``): level
    ids by the plain ``roi_level_assignment``, then the kernel's wrapper."""
    levels = roi_level_assignment(rois, int(math.log2(strides[0])), int(math.log2(strides[-1])))
    return multilevel_roi_align(features, rois, levels, strides, output_size)
