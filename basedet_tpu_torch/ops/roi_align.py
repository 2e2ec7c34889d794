"""Multilevel RoIAlign, plain PyTorch (counterpart of
``basedet_tpu/ops/roi_align_separable.py``).

Bilinear RoIAlign (average, aligned, sampling ratio 2) over FPN levels,
computed as the JAX package computes it: per RoI and level, two separable
weight matrices ``Py`` (ph, H) and ``Px`` (pw, W) fold the sample positions,
the bilinear lerp (``hi = min(lo + 1, size - 1)``), the zeroing of samples
outside ``[-1, size]``, the 1/S average and the level mask, and

    pooled[i, j, c] = sum_y sum_x Py[i, y] Px[j, x] F[c, y, x].

Its adjoint in the features, from the same weights, is

    dF[c, y, x] = sum_r sum_i sum_j Py[r, i, y] Px[r, j, x] g[r, i, j, c];

the RoIs get no gradient, as in the JAX package.

These are the plain versions of the two CUDA kernels in
``ops/roi_align_kernel.py`` and the CPU path of their wrappers. Features are
NCHW per level; the output is (B, R, ph, pw, C), channels last, as the JAX
package gives it, so that the box head flattens it in the same (h, w, c)
order.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

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


def _level_weights(rois: torch.Tensor, levels: torch.Tensor, level: int, stride: int,
                   size: Tuple[int, int], output_size: Tuple[int, int],
                   sampling_ratio: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``Py`` (B, R, ph, H) and ``Px`` (B, R, pw, W) of one level, zero for
    the RoIs of other levels."""
    (H, W), (ph, pw) = size, output_size
    scale = 1.0 / stride
    x1 = rois[..., 0] * scale - 0.5  # aligned: half-pixel shift
    y1 = rois[..., 1] * scale - 0.5
    x2 = rois[..., 2] * scale - 0.5
    y2 = rois[..., 3] * scale - 0.5
    mask = (levels == level).to(torch.float32)
    # divisors as tensors: PyTorch multiplies a CUDA tensor by the
    # reciprocal of a Python-number divisor, an ulp off IEEE division
    # (the kernel's), and at P2's coordinates an ulp is 3e-5 px
    bin_h = (y2 - y1) / torch.tensor(float(ph), device=rois.device)
    bin_w = (x2 - x1) / torch.tensor(float(pw), device=rois.device)
    return (_axis_weights(y1, bin_h, ph, sampling_ratio, H, mask),
            _axis_weights(x1, bin_w, pw, sampling_ratio, W, mask))


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
    out = None
    with full_f32():
        for li, (feat, stride) in enumerate(zip(features, strides)):
            py, px = _level_weights(rois, levels, li, stride, feat.shape[-2:], output_size,
                                    sampling_ratio)
            t = torch.einsum("briy,bcyx->brixc", py, feat.float())
            o = torch.einsum("brjx,brixc->brijc", px, t)
            out = o if out is None else out + o
    return out


multilevel_roi_align_plain.calls = 0


def multilevel_roi_align_backward_plain(
    grad: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    strides: Sequence[int],
    sizes: Sequence[Tuple[int, int]],
    sampling_ratio: int = 2,
) -> List[torch.Tensor]:
    """The gradient of :func:`multilevel_roi_align_plain` in its features:
    grad (B, R, ph, pw, C) f32 and the forward's rois, levels and strides,
    with ``sizes`` the (H_l, W_l) per level → dF per level (B, C, H_l, W_l)
    f32, zero where no RoI of the level lands.
    ``multilevel_roi_align_backward_plain.calls`` counts its calls."""
    multilevel_roi_align_backward_plain.calls += 1
    output_size = tuple(grad.shape[2:4])
    out = []
    with full_f32():
        for li, (size, stride) in enumerate(zip(sizes, strides)):
            py, px = _level_weights(rois, levels, li, stride, tuple(size), output_size,
                                    sampling_ratio)
            t = torch.einsum("brjx,brijc->brixc", px, grad.float())
            out.append(torch.einsum("briy,brixc->bcyx", py, t))
    return out


multilevel_roi_align_backward_plain.calls = 0
