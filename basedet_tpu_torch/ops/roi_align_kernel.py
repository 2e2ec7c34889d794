"""Multilevel RoIAlign, forward and backward: the two CUDA kernels in
``csrc/roi_align.cu``, their wrappers, the ``torch.autograd.Function`` that
joins them, and the dispatch ``pool_rois_multilevel``.

The forward replaces the JAX package's two Pallas forwards of one function,
``basedet_tpu/ops/roi_align_window.py::_fwd_kernel_win`` and
``basedet_tpu/ops/roi_align_pallas.py::_fwd_kernel``; the backward replaces
their two backwards, ``_bwd_kernel_win`` and ``_bwd_kernel``. The plain
versions are ``ops/roi_align.py::multilevel_roi_align_plain`` and
``multilevel_roi_align_backward_plain``.

On the card both kernels are bound by bytes: at Faster R-CNN's eval shape (one
image, 1000 RoIs, 256 channels) the output alone is 50.2 MB and P2-P5 are
91.4 MB, of which proposal-like RoIs touch about four fifths. The forward
reads the FPN's NCHW levels in place, through each level's pointer and
strides (no copy); a block computes one RoI's geometry and taps once and
pools a slab of 64 channels, a warp's loads running along a feature row, and
stores its staged output in rows of C floats. One launch pools every level
and image; one zero-fill and one launch scatter the gradient back into every
level.

The gradient goes to the features only; RoIs that require one are refused,
as the JAX package gives them none. The backward sums with f32 ``atomicAdd``,
so the order of each sum, and with it the last bits of the gradient, vary
from run to run.

The kernels are built from the repository's source at first use and bound
with ``ctypes`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.roi_align import (
    multilevel_roi_align_backward_plain,
    multilevel_roi_align_plain,
    roi_level_assignment,
)

SOURCE = CSRC / "roi_align.cu"
MAX_LEVELS = 4
MAX_PW = 8  # kMaxPw of the source: bins across a pooled output


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_roi_align_fwd
    i32p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), i32p, i32p, i32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    bwd = lib.basedet_roi_align_bwd
    bwd.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i32p, i32p, i32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    bwd.restype = ctypes.c_int
    return lib


def _level_args(tensors: Sequence[torch.Tensor], sizes: Sequence[Tuple[int, int]], strides: Sequence[int]):
    """The C arrays of the entries: device pointers, heights, widths and
    strides of the levels, one per level."""
    n = len(tensors)
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * n)(*[h for h, _ in sizes]), (ctypes.c_int * n)(*[w for _, w in sizes]),
            (ctypes.c_int * n)(*[int(s) for s in strides]), n)


def _check_rois(n_levels, rois, levels, strides) -> None:
    if not 1 <= n_levels <= MAX_LEVELS or len(strides) != n_levels:
        raise ValueError(f"need 1-{MAX_LEVELS} levels with one stride each, got "
                         f"{n_levels} levels and strides {tuple(strides)}")
    if rois.dim() != 3 or rois.shape[2] != 4 or rois.dtype != torch.float32:
        raise ValueError(f"rois must be f32 (B, R, 4), got {rois.dtype} {tuple(rois.shape)}")
    if rois.requires_grad:
        raise NotImplementedError("RoIAlign gives its RoIs no gradient: rois require grad")
    if levels.shape != rois.shape[:2] or levels.dtype != torch.int32 or levels.device != rois.device:
        raise ValueError(f"levels must be int32 {tuple(rois.shape[:2])} beside the rois, got "
                         f"{levels.dtype} {tuple(levels.shape)}")


def _check(features, rois, levels, strides) -> None:
    _check_rois(len(features), rois, levels, strides)
    B, C = features[0].shape[:2]
    for f in features:
        if f.dim() != 4 or f.shape[:2] != (B, C) or f.dtype != torch.float32:
            raise ValueError(f"features must be f32 (B, C, H, W) with one B and C, got "
                             f"{[(tuple(x.shape), x.dtype) for x in features]}")
        if f.device != rois.device:
            raise ValueError("features and rois lie on different devices")
    if rois.shape[0] != B:
        raise ValueError(f"{rois.shape[0]} images of rois for {B} images of features")


def _launch_forward(features, rois, levels, strides, output_size) -> torch.Tensor:
    B, R = levels.shape
    C = features[0].shape[1]
    ph, pw = output_size
    if not 1 <= pw <= MAX_PW or ph < 1:
        raise ValueError(f"the RoIAlign kernel pools at most {MAX_PW} bins across, got {output_size}")
    out = torch.empty((B, R, ph, pw, C), dtype=torch.float32, device=rois.device)
    ptrs, heights, widths, level_strides, n = _level_args(features, [f.shape[-2:] for f in features], strides)
    feat_strides = (ctypes.c_longlong * (4 * n))(*[s for f in features for s in f.stride()])
    rois, levels = rois.contiguous(), levels.contiguous()
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        err = _library().basedet_roi_align_fwd(
            ptrs, feat_strides, heights, widths, level_strides, n, rois.data_ptr(), levels.data_ptr(), B, R, C,
            ph, pw, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign kernel launch failed: CUDA error {err}")
    multilevel_roi_align.launches += 1
    return out


def multilevel_roi_align_backward(
    grad: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    sizes: Sequence[Tuple[int, int]],
) -> List[torch.Tensor]:
    """The gradient of :func:`multilevel_roi_align` in its features: grad
    (B, R, ph, pw, C) f32 and the forward's rois, levels and strides, with
    ``sizes`` the (H_l, W_l) per level → dF per level, shaped (B, C, H_l,
    W_l) f32 (channels-last in memory on the card), zero where no RoI of the
    level lands.

    A CUDA tensor goes through the kernel
    (``multilevel_roi_align_backward.launches`` counts its launches): one
    zero-fill of all levels, one launch. It sums with f32 ``atomicAdd``, so
    two runs on the same inputs may differ in the last bits. A CPU tensor
    goes through the plain version."""
    _check_rois(len(sizes), rois, levels, strides)
    if (grad.dim() != 5 or grad.shape[:2] != rois.shape[:2] or grad.dtype != torch.float32
            or grad.device != rois.device):
        raise ValueError(f"grad must be f32 (B, R, ph, pw, C) beside the rois, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if rois.device.type == "cpu":
        return multilevel_roi_align_backward_plain(grad, rois, levels, strides, sizes)
    if rois.device.type != "cuda":
        raise ValueError(f"no RoIAlign kernel for device {rois.device}")
    B, R, ph, pw, C = grad.shape
    counts = [B * h * w * C for h, w in sizes]
    flat = torch.zeros(sum(counts), dtype=torch.float32, device=rois.device)
    nhwc = [t.view(B, h, w, C) for t, (h, w) in zip(flat.split(counts), sizes)]
    grad, rois, levels = grad.contiguous(), rois.contiguous(), levels.contiguous()
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        err = _library().basedet_roi_align_bwd(
            *_level_args(nhwc, sizes, strides), grad.data_ptr(), rois.data_ptr(), levels.data_ptr(),
            B, R, C, ph, pw, stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign backward kernel launch failed: CUDA error {err}")
    multilevel_roi_align_backward.launches += 1
    return [t.permute(0, 3, 1, 2) for t in nhwc]


multilevel_roi_align_backward.launches = 0


class _RoIAlignOnCard(torch.autograd.Function):
    """The forward launch and, for features that require grad, the backward
    launch. Saves the rois, the level ids and the levels' sizes."""

    @staticmethod
    def forward(ctx, rois, levels, strides, output_size, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides = tuple(strides)
        ctx.sizes = [tuple(f.shape[-2:]) for f in features]
        return _launch_forward(features, rois, levels, strides, output_size)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        grads = multilevel_roi_align_backward(grad, rois, levels, ctx.strides, ctx.sizes)
        return (None, None, None, None, *grads)


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    output_size: Tuple[int, int] = (7, 7),
) -> torch.Tensor:
    """features per level (B, C, H_l, W_l) f32, rois (B, R, 4) xyxy, levels
    (B, R) int32 0-based level ids → (B, R, ph, pw, C) f32, differentiable
    in the features.

    A CUDA tensor goes through the kernel (``multilevel_roi_align.launches``
    counts its launches) and, on the way back, through the backward kernel
    (:func:`multilevel_roi_align_backward`). A CPU tensor goes through the
    plain version, whose gradient is autograd's own."""
    _check(features, rois, levels, strides)
    if rois.device.type == "cpu":
        return multilevel_roi_align_plain(features, rois, levels, strides, output_size)
    if rois.device.type != "cuda":
        raise ValueError(f"no RoIAlign kernel for device {rois.device}")
    return _RoIAlignOnCard.apply(rois, levels, strides, output_size, *features)


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
