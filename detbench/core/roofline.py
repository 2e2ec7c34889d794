"""Peaks of one NVIDIA H100 and the least time of each kernel's call, from
the call's own arguments: each input read once, each output written once.
A copy of ``chip_smoke.py``'s ``bound``, ``nms_bound``, ``matching_bound``,
``roi_align_touched``, ``roi_align_bound``, ``roi_align_bwd_bound`` and
``iou_bound``, taking the strides and channels from the call."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 outside the tensor cores, dense bf16 tensor cores
PEAK_BYTES_PER_S, PEAK_F32_PER_S, PEAK_BF16_PER_S = 3.35e12, 67e12, 989e12
PEAK_FLOPS = {"float32": PEAK_F32_PER_S, "bfloat16": PEAK_BF16_PER_S}


def bound(bytes_moved: float, ops: float, peak_ops: float = PEAK_F32_PER_S) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): bytes over the memory rate or
    operations over their peak, whichever is larger."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_bound(B: int, K: int, valid: torch.Tensor, kept: torch.Tensor) -> Tuple[float, str]:
    """Boxes (16 B), valid and keep (1 B each) once per candidate; ~15 f32
    operations per IoU test, and the fewest tests greedy NMS needs: each kept
    box against every kept box before it, each suppressed box against one.
    ``valid`` and ``kept`` are per-image counts."""
    kept = kept.double()
    suppressed = valid.double() - kept
    return bound(B * K * (16 + 1 + 1), 15 * float((kept * (kept - 1) / 2 + suppressed).sum()))


def matching_bound(rows: int, B: int, M: int) -> Tuple[float, str]:
    """Cost and IoU (4 B each) read for the valid (image, gt) rows, best gt
    (4 B) and foreground (1 B) written per anchor; ~2 operations per element read."""
    return bound(rows * M * 8 + B * M * 5, 2 * rows * M)


def iou_bound(b1_shape: Sequence[int], b2_shape: Sequence[int]) -> Tuple[float, str]:
    """Both box sets read once, the f32 output written once; ~17 operations a pair."""
    B = b1_shape[0] if len(b1_shape) == 3 else 1
    pairs = B * b1_shape[-2] * b2_shape[-2]
    n1 = 1
    for s in b1_shape:
        n1 *= s
    n2 = 1
    for s in b2_shape:
        n2 *= s
    return bound(4 * pairs + 4 * n1 + 4 * n2, 17 * pairs)


def _axis_weights(lo, bin_size, pool: int, sampling: int, size: int, mask):
    """(..., pool, size) RoIAlign weights along one axis (the plain version's)."""
    dev = lo.device
    steps = (torch.arange(pool, dtype=torch.float32, device=dev)[:, None]
             + (torch.arange(sampling, dtype=torch.float32, device=dev)[None, :] + 0.5) / sampling)
    coords = lo[..., None, None] + steps * bin_size[..., None, None]
    oob = (coords < -1.0) | (coords > size)
    c = coords.clamp(0.0, size - 1.0)
    low = torch.floor(c)
    high = torch.minimum(low + 1.0, torch.tensor(size - 1.0, device=dev))
    lerp = c - low
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w_sample = torch.where(oob, 0.0, 1.0) / sampling
    w = ((grid == low[..., None]) * (1.0 - lerp)[..., None]
         + (grid == high[..., None]) * lerp[..., None]) * w_sample[..., None]
    return w.sum(-2) * mask[..., None, None]


def roi_align_touched(sizes, strides, rois, levels, output_size=(7, 7)) -> int:
    """The (level, b, y, x) feature rows that some RoI's taps read with a
    nonzero weight: a RoI reads the product of the rows and the columns its
    samples touch. Computed an image at a time."""
    ph, pw = output_size
    touched = 0
    for li, ((H, W), stride) in enumerate(zip(sizes, strides)):
        for b in range(rois.shape[0]):
            box = rois[b] / stride - 0.5
            mask = (levels[b] == li).float()
            py = _axis_weights(box[:, 1], (box[:, 3] - box[:, 1]) / ph, ph, 2, H, mask)
            px = _axis_weights(box[:, 0], (box[:, 2] - box[:, 0]) / pw, pw, 2, W, mask)
            rows, cols = (py != 0).any(-2).float(), (px != 0).any(-2).float()
            touched += int((rows.T @ cols > 0).sum())
    return touched


def roi_align_bound(sizes, strides, channels: int, elem: int, rois, levels) -> Tuple[float, str]:
    """RoIAlign forward: the output written once, rois and level ids read
    once, the channels of every touched feature row read once, in the
    features' dtype (``elem`` bytes); 16 taps × 3 + 4 weights × 4 f32
    operations per output element."""
    B, R = levels.shape
    out = B * R * 7 * 7 * channels
    feat = roi_align_touched(sizes, strides, rois, levels) * channels * elem
    return bound(out * elem + feat + B * R * 20, out * (16 * 3 + 4 * 4))


def roi_align_bwd_bound(grad_shape, elem: int, sizes) -> Tuple[float, str]:
    """RoIAlign backward: g, rois and level ids read once, every level's dF
    written once, in g's dtype; 4 weight multiplies and 16 taps × 2 f32
    operations per element of g."""
    B, R, ph, pw, C = grad_shape
    n = B * R * ph * pw * C
    d_bytes = sum(B * h * w * C * elem for h, w in sizes)
    return bound(n * elem + d_bytes + B * R * 20, n * (16 * 2 + 4))
