"""Caffe-compatible pooling (ceil-mode output size), NCHW (counterpart of
``basedet_tpu/layers/blocks/pool.py``, which pools NHWC).

Caffe computes the output size with ceil division and clamps the last
window so it starts inside the padded input; PyTorch's default, like
MegEngine's and JAX's, is floor. Needed for loading zoo weights of
Caffe-era backbones, where one row or column of difference breaks the FPN's
shapes.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def caffe_pooling_2d(
    x: torch.Tensor,
    kernel_size: Union[int, Tuple[int, int]],
    stride: Union[int, Tuple[int, int], None] = None,
    padding: Union[int, Tuple[int, int]] = 0,
    mode: str = "max",
) -> torch.Tensor:
    """Pool NCHW ``x`` with Caffe's ceil-mode output-size rule.

    ``mode`` is "max" or "average"; average counts padded zeros in the
    divisor (Caffe AVE / MegEngine "average" semantics)."""
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride) if stride is not None else (kh, kw)
    ph, pw = _pair(padding)
    assert mode in ("max", "average"), mode

    h, w = x.shape[2], x.shape[3]
    # Caffe: ceil((H + 2p - k) / s) + 1, clamped so the last window starts
    # inside input+padding
    caffe_h = (h + 2 * ph - kh + sh - 1) // sh + 1
    caffe_w = (w + 2 * pw - kw + sw - 1) // sw + 1
    if ph > 0 or pw > 0:
        if (caffe_h - 1) * sh >= h + ph:
            caffe_h -= 1
        if (caffe_w - 1) * sw >= w + pw:
            caffe_w -= 1

    # pad exactly what the ceil-mode windows read: ph/pw in front, whatever
    # the last window still needs at the back; then pool without padding
    back_h = max(0, (caffe_h - 1) * sh + kh - h - ph)
    back_w = max(0, (caffe_w - 1) * sw + kw - w - pw)
    fill = float("-inf") if mode == "max" else 0.0
    padded = F.pad(x, (pw, back_w, ph, back_h), value=fill)
    if mode == "max":
        out = F.max_pool2d(padded, (kh, kw), (sh, sw))
    else:
        out = F.avg_pool2d(padded, (kh, kw), (sh, sw))
    assert out.shape[2] == caffe_h and out.shape[3] == caffe_w, (out.shape, caffe_h, caffe_w)
    return out
