"""Multilevel RoIAlign, plain PyTorch (counterpart of
``basedet_tpu/ops/roi_align_separable.py``).

Bilinear RoIAlign (average, aligned, sampling ratio 2) over FPN levels,
computed as the JAX package computes it: per RoI and level, two separable
weight matrices ``Py`` (ph, H) and ``Px`` (pw, W) fold the sample positions,
the bilinear lerp (``hi = min(lo + 1, size - 1)``), the zeroing of samples
outside ``[-1, size]``, the 1/S average and the level mask, and

    pooled[i, j, c] = sum_y sum_x Py[i, y] Px[j, x] F[c, y, x].

This is the plain version of the CUDA kernel in ``ops/roi_align_kernel.py``
and the CPU path of its wrapper. Features are NCHW per level; the output is
(B, R, ph, pw, C), channels last, as the JAX package gives it, so that the
box head flattens it in the same (h, w, c) order.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from basedet_tpu_torch.layers.common.function import full_f32


def roi_level_assignment(
    rois: torch.Tensor,
    min_level: int,
    max_level: int,
    canonical_level: int = 4,
    canonical_box_size: int = 224,
) -> torch.Tensor:
    """FPN level ids (..., ) int32, 0-based from ``min_level``:
    ``floor(4 + log(sqrt(max(area, 1e-12)) / 224) / log 2)``, clipped, in the
    JAX package's op order."""
    area = (rois[..., 2] - rois[..., 0]).clamp(min=0) * (rois[..., 3] - rois[..., 1]).clamp(min=0)
    lvl = torch.floor(
        canonical_level
        + torch.log(torch.sqrt(area.clamp(min=1e-12)) / canonical_box_size) / math.log(2.0)
    ).to(torch.int32)
    return lvl.clamp(min_level, max_level) - min_level


def _axis_weights(lo_coord: torch.Tensor, bin_size: torch.Tensor, pool_dim: int,
                  sampling_ratio: int, size: int, mask: torch.Tensor) -> torch.Tensor:
    """(..., pool_dim, size) weights along one axis from (...) RoI starts (in
    feature coordinates, already shifted by -0.5), bin sizes and the level
    mask."""
    S = sampling_ratio
    dev = lo_coord.device
    steps = (torch.arange(pool_dim, dtype=torch.float32, device=dev)[:, None]
             + (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5) / S)  # (P, S)
    coords = lo_coord[..., None, None] + steps * bin_size[..., None, None]  # (..., P, S)
    oob = (coords < -1.0) | (coords > size)
    c = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(c)
    hi = torch.minimum(lo + 1.0, torch.tensor(size - 1.0, device=dev))
    lerp = c - lo
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w_sample = torch.where(oob, 0.0, 1.0) / S
    w = ((grid == lo[..., None]) * (1.0 - lerp)[..., None]
         + (grid == hi[..., None]) * lerp[..., None]) * w_sample[..., None]
    return w.sum(-2) * mask[..., None, None]  # (..., P, size)


def multilevel_roi_align_plain(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    output_size: Tuple[int, int] = (7, 7),
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """features per level (B, C, H_l, W_l) f32, rois (B, R, 4) xyxy in image
    coordinates, levels (B, R) 0-based level ids → (B, R, ph, pw, C) f32.
    ``multilevel_roi_align_plain.calls`` counts its calls."""
    multilevel_roi_align_plain.calls += 1
    ph, pw = output_size
    out = None
    with full_f32():
        for li, (feat, stride) in enumerate(zip(features, strides)):
            B, C, H, W = feat.shape
            scale = 1.0 / stride
            x1 = rois[..., 0] * scale - 0.5  # aligned: half-pixel shift
            y1 = rois[..., 1] * scale - 0.5
            x2 = rois[..., 2] * scale - 0.5
            y2 = rois[..., 3] * scale - 0.5
            mask = (levels == li).to(torch.float32)
            # divisors as tensors: PyTorch multiplies a CUDA tensor by the
            # reciprocal of a Python-number divisor, an ulp off IEEE division
            # (the kernel's), and at P2's coordinates an ulp is 3e-5 px
            bin_h = (y2 - y1) / torch.tensor(float(ph), device=rois.device)
            bin_w = (x2 - x1) / torch.tensor(float(pw), device=rois.device)
            py = _axis_weights(y1, bin_h, ph, sampling_ratio, H, mask)  # (B, R, ph, H)
            px = _axis_weights(x1, bin_w, pw, sampling_ratio, W, mask)  # (B, R, pw, W)
            t = torch.einsum("briy,bcyx->brixc", py, feat.float())
            o = torch.einsum("brjx,brixc->brijc", px, t)
            out = o if out is None else out + o
    return out


multilevel_roi_align_plain.calls = 0
