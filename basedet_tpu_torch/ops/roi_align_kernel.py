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
and image.

The backward has one writer for each element of dF: a block owns a tile of
one level of one image (``TILE_Y`` rows by ``TILE_X`` columns) and a slab of
32 channels, keeps the RoIs whose tap window meets the tile, in RoI-index
order, sums their separable adjoint restricted to the tile in registers and
stores the tile once, zeros included, into NCHW-contiguous dF. One launch
writes every level and image, with no zero-fill and no atomics, so two runs
give the same bits. :func:`tile_gather_model` is its decomposition in
Python, for the CPU tests. The gradient goes to the features only; RoIs
that require one are refused, as the JAX package gives them none.

Both directions come in f32 and bf16 (the element type of the features, the
output, g and dF; RoIs stay f32). The bf16 kernels are the JAX package's
Pallas kernels' own dtype: each axis's weights rounded to bf16 once, products
and sums in f32, the output and dF rounded to bf16 once. They have designs of
their own, with every output's chain of f32 operations the same as the f32
kernels' structure gives it. The bf16 forward gives a block a RoI and 16
channels, a lane one channel and one bin column, and reads the features from
the RoI's window staged in shared memory by 16-byte copies, where it fits
(:func:`forward_stage_groups` is the rule), else from global memory. The bf16
backward gives a block a tile of 8 x 16 and 64 channels, two a lane, sums
only the groups of columns a bin reaches, and stores dF 16 bytes a store. A
bf16 CUDA tensor launches them or raises; it is never sent through the f32
kernels or a plain version. ``multilevel_roi_align.launches`` and
``multilevel_roi_align_backward.launches`` count the f32 launches,
``.launches_bf16`` the bf16 ones.

The kernels are built from the repository's source at first use and bound
with ``ctypes`` (``ops/_build.py``). The forward is reached through one
registered custom op, ``torch.ops.basedet.roi_align``, whose gradient is the
backward kernel's (``torch.library.register_autograd``), so that
``torch.export`` records a pooling as one node and an exported program
launches the forward kernel as the eager module does.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.roi_align import (
    _level_weights,
    multilevel_roi_align_backward_plain,
    multilevel_roi_align_plain,
    roi_level_assignment,
)

SOURCE = CSRC / "roi_align.cu"
MAX_LEVELS = 4
MAX_PW = 8  # kMaxPw of the source: bins across a pooled output
TILE_Y, TILE_X = 8, 32  # kTileY, kTileX of the source: the backward's tile of a level
FWD_SLAB = 16  # kFwdSlab of the source: channels of a bf16 forward block
FWD_STAGE_BYTES = 32768  # kFwdStageBytes: a bf16 forward block's shared memory for staged windows
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types


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
    # the bf16 entries take the same arguments, their element pointers untyped
    lib.basedet_roi_align_fwd_bf16.argtypes = fn.argtypes
    lib.basedet_roi_align_fwd_bf16.restype = ctypes.c_int
    lib.basedet_roi_align_bwd_bf16.argtypes = bwd.argtypes
    lib.basedet_roi_align_bwd_bf16.restype = ctypes.c_int
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
    dtype = features[0].dtype
    for f in features:
        if f.dim() != 4 or f.shape[:2] != (B, C) or f.dtype != dtype or dtype not in DTYPES:
            raise ValueError(f"features must be f32 or bf16 (B, C, H, W) with one B, C and dtype, got "
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
    bf16 = features[0].dtype == torch.bfloat16
    out = torch.empty((B, R, ph, pw, C), dtype=features[0].dtype, device=rois.device)
    ptrs, heights, widths, level_strides, n = _level_args(features, [f.shape[-2:] for f in features], strides)
    feat_strides = (ctypes.c_longlong * (4 * n))(*[s for f in features for s in f.stride()])
    rois, levels = rois.contiguous(), levels.contiguous()
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        entry = _library().basedet_roi_align_fwd_bf16 if bf16 else _library().basedet_roi_align_fwd
        err = entry(ptrs, feat_strides, heights, widths, level_strides, n, rois.data_ptr(), levels.data_ptr(), B, R,
                    C, ph, pw, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign kernel launch failed: CUDA error {err}")
    if bf16:
        multilevel_roi_align.launches_bf16 += 1
    else:
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
    (B, R, ph, pw, C) f32 or bf16 and the forward's rois, levels and strides,
    with ``sizes`` the (H_l, W_l) per level → dF per level, NCHW-contiguous
    (B, C, H_l, W_l) in grad's dtype, zero where no RoI of the level lands.

    A CUDA tensor goes through the kernel of its dtype
    (``multilevel_roi_align_backward.launches`` counts the f32 launches,
    ``.launches_bf16`` the bf16 ones): one
    launch writes every element of every level once, so two runs on the same
    inputs give the same bits. It takes at most ``MAX_PW`` bins across, as
    the forward does. A CPU tensor goes through the plain version."""
    _check_rois(len(sizes), rois, levels, strides)
    if (grad.dim() != 5 or grad.shape[:2] != rois.shape[:2] or grad.dtype not in DTYPES
            or grad.device != rois.device):
        raise ValueError(f"grad must be f32 or bf16 (B, R, ph, pw, C) beside the rois, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    if rois.device.type == "cpu":
        return multilevel_roi_align_backward_plain(grad, rois, levels, strides, sizes)
    if rois.device.type != "cuda":
        raise ValueError(f"no RoIAlign kernel for device {rois.device}")
    B, R, ph, pw, C = grad.shape
    if not 1 <= pw <= MAX_PW or ph < 1:
        raise ValueError(f"the RoIAlign backward kernel takes at most {MAX_PW} bins across, got {(ph, pw)}")
    bf16 = grad.dtype == torch.bfloat16
    counts = [B * C * h * w for h, w in sizes]
    flat = torch.empty(sum(counts), dtype=grad.dtype, device=rois.device)
    dfs = [t.view(B, C, h, w) for t, (h, w) in zip(flat.split(counts), sizes)]
    grad, rois, levels = grad.contiguous(), rois.contiguous(), levels.contiguous()
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream(rois.device).cuda_stream
        entry = _library().basedet_roi_align_bwd_bf16 if bf16 else _library().basedet_roi_align_bwd
        err = entry(*_level_args(dfs, sizes, strides), grad.data_ptr(), rois.data_ptr(), levels.data_ptr(),
                    B, R, C, ph, pw, stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign backward kernel launch failed: CUDA error {err}")
    if bf16:
        multilevel_roi_align_backward.launches_bf16 += 1
    else:
        multilevel_roi_align_backward.launches += 1
    return dfs


multilevel_roi_align_backward.launches = 0
multilevel_roi_align_backward.launches_bf16 = 0


def _axis_taps(start: np.ndarray, bin_size: np.ndarray, p: int, s: int, size: int):
    """The source's ``axis_tap`` in numpy f32, over arrays of RoIs: the rows
    (lo, hi) that sample s of bin p reads (NaN coordinates clamp to 0, as
    ``fminf``/``fmaxf`` give them)."""
    f32 = np.float32
    step = f32(p) + (f32(s) + f32(0.5)) / f32(2)
    coord = start + step * bin_size
    top = f32(size - 1)
    c = np.fmin(np.fmax(coord, f32(0)), top)
    lo = np.floor(c)
    return lo.astype(np.int64), np.minimum(lo + f32(1), top).astype(np.int64)


def tap_windows(rois: torch.Tensor, levels: torch.Tensor, strides: Sequence[int],
                sizes: Sequence[Tuple[int, int]], output_size: Tuple[int, int]) -> np.ndarray:
    """The backward kernel's window of every RoI, (B, R, 5) int64: its level
    (clamped to the levels present) and the first and last rows and columns
    that its taps read on it, from the first and last samples of each axis
    (the taps move monotonically with the sample)."""
    ph, pw = output_size
    box = rois.detach().cpu().numpy().astype(np.float32)
    level = np.clip(levels.cpu().numpy(), 0, len(strides) - 1)
    scale = np.float32(1.0) / np.float32([strides[l] for l in range(len(strides))])[level]
    x1, y1, x2, y2 = (box[..., k] * scale - np.float32(0.5) for k in range(4))
    bin_h, bin_w = (y2 - y1) / np.float32(ph), (x2 - x1) / np.float32(pw)
    h = np.int64([sizes[l][0] for l in range(len(sizes))])[level]
    w = np.int64([sizes[l][1] for l in range(len(sizes))])[level]
    out = np.zeros(box.shape[:2] + (5,), np.int64)
    out[..., 0] = level
    with np.errstate(invalid="ignore", over="ignore"):
        for k, (start, size, p) in enumerate(((y1, h, ph), (x1, w, pw))):
            for idx in np.ndindex(box.shape[:2]):
                a = _axis_taps(start[idx], (bin_h, bin_w)[k][idx], 0, 0, int(size[idx]))
                z = _axis_taps(start[idx], (bin_h, bin_w)[k][idx], p - 1, 1, int(size[idx]))
                out[idx + (1 + 2 * k,)] = min(a[0], z[0])
                out[idx + (2 + 2 * k,)] = max(a[1], z[1])
    return out


def forward_stage_groups(windows: np.ndarray, C: int, unit_x_stride: bool = True) -> np.ndarray:
    """The bf16 forward kernel's staging, for RoIs with ``windows`` (B, R, 5)
    from :func:`tap_windows`: (B, R, slabs) int, the channels that the block
    of that RoI and slab of ``FWD_SLAB`` stages in shared memory at once (all
    of the slab's where their windows fit ``FWD_STAGE_BYTES`` together), or 0
    where it reads global memory instead: not one channel's window fits, or
    the level's x stride is not 1 (channels-last features). A channel's
    window takes its rows in 16-byte chunks, with room for a row that starts
    7 elements past a 16-byte boundary, and channels lie 16 elements apart
    modulo 64, so that a warp's four channels sit 8 banks apart."""
    rows = windows[..., 2] - windows[..., 1] + 1
    span = windows[..., 4] - windows[..., 3] + 1
    room = rows * (8 * ((span + 14) // 8))
    pitch = room + (80 - room % 64) % 64
    channels = np.minimum(FWD_SLAB, C - FWD_SLAB * np.arange(-(-C // FWD_SLAB)))
    groups = np.minimum(channels, FWD_STAGE_BYTES // (2 * pitch[..., None]))
    return groups if unit_x_stride else np.zeros_like(groups)


def tile_gather_model(
    grad: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    sizes: Sequence[Tuple[int, int]],
    tile: Tuple[int, int] = (TILE_Y, TILE_X),
):
    """The backward kernel's decomposition in Python: for every level l,
    image b and tile (ty, tx) of ``tile`` rows and columns, the RoIs of
    level l whose window (:func:`tap_windows`) meets the tile, in RoI-index
    order, each adding the plain adjoint restricted to the tile. Returns (dF
    per level (B, C, H_l, W_l) f32, {(l, b, ty, tx): [r, ...]} for every
    tile)."""
    B, R, ph, pw, C = grad.shape
    win = tap_windows(rois, levels, strides, sizes, (ph, pw))
    out, lists = [], {}
    with full_f32():
        for l, (size, stride) in enumerate(zip(sizes, strides)):
            H, W = size
            py, px = _level_weights(rois, levels, l, stride, (H, W), (ph, pw), 2)
            d = torch.zeros((B, C, H, W), dtype=torch.float32, device=grad.device)
            for b in range(B):
                for ty in range(-(-H // tile[0])):
                    for tx in range(-(-W // tile[1])):
                        y0, x0 = ty * tile[0], tx * tile[1]
                        ys, xs = slice(y0, min(y0 + tile[0], H)), slice(x0, min(x0 + tile[1], W))
                        kept = [r for r in range(R) if win[b, r, 0] == l and win[b, r, 1] < y0 + tile[0]
                                and win[b, r, 2] >= y0 and win[b, r, 3] < x0 + tile[1] and win[b, r, 4] >= x0]
                        lists[(l, b, ty, tx)] = kept
                        for r in kept:
                            u = torch.einsum("iy,ijc->yjc", py[b, r, :, ys], grad[b, r].float())
                            d[b, :, ys, xs] += torch.einsum("jx,yjc->cyx", px[b, r, :, xs], u)
            out.append(d)
    return out, lists


@torch.library.custom_op("basedet::roi_align", mutates_args=())
def _roi_align_op(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor, strides: List[int],
                  output_size: List[int]) -> torch.Tensor:
    if rois.device.type == "cpu":
        return multilevel_roi_align_plain(features, rois, levels, strides, tuple(output_size))
    return _launch_forward(features, rois, levels, strides, tuple(output_size))


@_roi_align_op.register_fake
def _(features, rois, levels, strides, output_size):
    B, R = levels.shape
    return features[0].new_empty((B, R, *output_size, features[0].shape[1]))


def _roi_align_setup(ctx, inputs, output):
    features, rois, levels, strides, _ = inputs
    ctx.save_for_backward(rois, levels)
    ctx.strides = tuple(strides)
    ctx.sizes = [tuple(f.shape[-2:]) for f in features]


def _roi_align_grad(ctx, grad):
    rois, levels = ctx.saved_tensors
    # autograd hands g in the output's dtype, the features'
    return multilevel_roi_align_backward(grad, rois, levels, ctx.strides, ctx.sizes), None, None, None, None


torch.library.register_autograd("basedet::roi_align", _roi_align_grad, setup_context=_roi_align_setup)


def multilevel_roi_align(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    output_size: Tuple[int, int] = (7, 7),
) -> torch.Tensor:
    """features per level (B, C, H_l, W_l) f32 or bf16 (one dtype), rois
    (B, R, 4) f32 xyxy, levels (B, R) int32 0-based level ids → (B, R, ph,
    pw, C) in the features' dtype, differentiable in the features (dF in
    their dtype).

    Calls the custom op ``basedet::roi_align``: a CUDA tensor goes through
    the kernel of its dtype (``multilevel_roi_align.launches`` counts the f32
    launches, ``.launches_bf16`` the bf16 ones) and, on the way back, through
    the backward kernel (:func:`multilevel_roi_align_backward`). A CPU tensor
    goes through the plain version: inside the op without autograd
    (inference, ``torch.export``), or, where a feature requires grad, called
    directly, so that its gradient stays autograd's own."""
    _check(features, rois, levels, strides)
    if rois.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no RoIAlign kernel for device {rois.device}")
    if rois.device.type == "cpu" and torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return multilevel_roi_align_plain(features, rois, levels, strides, output_size)
    return torch.ops.basedet.roi_align(list(features), rois, levels, [int(s) for s in strides],
                                       [int(s) for s in output_size])


multilevel_roi_align.launches = 0
multilevel_roi_align.launches_bf16 = 0


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
