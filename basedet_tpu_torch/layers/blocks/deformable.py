"""Deformable convolution v1/v2 as a bilinear block gather and a dense tap
mix (counterpart of ``basedet_tpu/layers/blocks/deformable.py``).

The JAX package's formulation is kept as it is, so that the two agree term
by term: the 2x2 corner block of every sample is one gathered (4C)-wide row
of a table built from a one-pixel zero pad, and the K = 9 modulated taps are
mixed by one dense layer over a tap-major (K, C) flatten. The gather's
gradient in the table, the DCN's gradient in its input, is the row scatter
of ``ops/scatter_rows_kernel.py`` (kernel #9 on the card).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.ops.scatter_rows_kernel import gather_rows_batched

TAPS = 9


def bilinear_sample_batched(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) channels-last; y, x (B, ...) float coordinates →
    (B, ..., C), zero outside the image.

    Anchors (the floor of each coordinate, plus one) lie in the padded
    table's coordinates and are clamped to [0, H] x [0, W]; ``valid`` zeroes
    the samples whose anchor was clamped from farther out, so the zero pad
    reproduces per-corner inside masks for anchors in [-1, H]."""
    B, H, W, C = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0).to(img.dtype)
    wx = (x - x0).to(img.dtype)

    fp = F.pad(img, (0, 0, 1, 1, 1, 1))  # (B, H+2, W+2, C)
    blk = torch.cat(
        [fp[:, : H + 1, : W + 1], fp[:, : H + 1, 1: W + 2],
         fp[:, 1: H + 2, : W + 1], fp[:, 1: H + 2, 1: W + 2]],
        dim=-1,
    ).reshape(B, (H + 1) * (W + 1), 4 * C)

    ay = y0.to(torch.int32) + 1  # anchor in padded coordinates
    ax = x0.to(torch.int32) + 1
    valid = (ay >= 0) & (ay <= H) & (ax >= 0) & (ax <= W)
    flat = (ay.clamp(0, H) * (W + 1) + ax.clamp(0, W)).reshape(B, -1)
    v = gather_rows_batched(blk, flat).reshape(*y.shape, 4, C)

    w = torch.stack(
        [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], dim=-1
    ) * valid.to(img.dtype)[..., None]  # (..., 4)
    return torch.einsum("...k,...kc->...c", w, v)


class ModulatedDeformConv(nn.Module):
    """DCNv2 (modulated; DCNv1 with ``modulated=False``): 3x3, stride 1,
    padding 1, one deformable group, NCHW in and out. ``conv_offset`` gives
    (dy, dx) per tap and, modulated, 9 mask logits through a sigmoid; the
    taps ``ky, kx`` in {-1, 0, 1} run in ``indexing="ij"`` order. The mix is
    the submodule named ``weight`` (flax's ``Dense`` of that name), so the
    keys are ``weight.weight`` and ``weight.bias``."""

    def __init__(self, in_channels: int, out_channels: int, modulated: bool = True, device=None):
        super().__init__()
        self.modulated = modulated
        n_off = 2 * TAPS + (TAPS if modulated else 0)
        self.conv_offset = nn.Conv2d(in_channels, n_off, 3, padding=1, device=device)
        self.weight = nn.Linear(TAPS * in_channels, out_channels, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX package initialises it: the offset branch zero (the
        standard DCN init), the mix He-normal over its 9C inputs (normal in
        place of truncated normal), its bias zero."""
        self.conv_offset.weight.zero_()
        self.conv_offset.bias.zero_()
        fan_in = self.weight.weight.shape[1]
        self.weight.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        self.weight.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        off = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, H, W, n_off)
        offsets = off[..., : 2 * TAPS].reshape(B, H, W, TAPS, 2)  # (dy, dx) per tap
        if self.modulated:
            mask = torch.sigmoid(off[..., 2 * TAPS:])  # (B, H, W, K)
        else:
            mask = torch.ones((B, H, W, TAPS), dtype=x.dtype, device=x.device)

        k = torch.arange(-1.0, 2.0, dtype=x.dtype, device=x.device)
        ky, kx = torch.meshgrid(k, k, indexing="ij")
        gy, gx = torch.meshgrid(torch.arange(H, dtype=x.dtype, device=x.device),
                                torch.arange(W, dtype=x.dtype, device=x.device), indexing="ij")
        ys = gy[None, :, :, None] + ky.reshape(1, 1, 1, -1) + offsets[..., 0]
        xs = gx[None, :, :, None] + kx.reshape(1, 1, 1, -1) + offsets[..., 1]

        sampled = bilinear_sample_batched(x.permute(0, 2, 3, 1), ys, xs)  # (B, H, W, K, C)
        sampled = (sampled * mask[..., None]).reshape(B, H, W, TAPS * C)
        return self.weight(sampled).permute(0, 3, 1, 2)


class DeformConv(ModulatedDeformConv):
    """DCNv1 (no modulation)."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__(in_channels, out_channels, modulated=False, device=device)
