"""Anchor boxes and point grids (counterparts of ``DefaultAnchorGenerator``,
``AnchorPointGenerator`` and ``FastPointGenerator`` in
``basedet_tpu/layers/common/anchor_generator.py``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DefaultAnchorGenerator:
    """Scale x ratio base anchors replicated over the stride grid: base
    anchors of area scale^2 and aspect ratio h/w, centred at
    (offset + grid) * stride, scale-major then ratio per location, each level
    (H*W*A, 4) xyxy in grid-major order. Built in numpy exactly as the JAX
    package builds them, then moved to the device."""

    anchor_scales: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,))
    anchor_ratios: Sequence[Sequence[float]] = ((0.5, 1, 2),)
    strides: Sequence[int] = (4, 8, 16, 32, 64)
    offset: float = 0.0

    def _per_level(self, vals):
        vals = [list(v) for v in vals]
        if len(vals) == 1:
            vals = vals * len(self.strides)
        if len(vals) != len(self.strides):
            raise ValueError(f"{len(vals)} anchor specs for {len(self.strides)} levels")
        return vals

    @property
    def num_anchors(self) -> int:
        return len(self._per_level(self.anchor_scales)[0]) * len(self._per_level(self.anchor_ratios)[0])

    def base_anchors(self) -> List[np.ndarray]:
        out = []
        for scales, ratios in zip(self._per_level(self.anchor_scales),
                                  self._per_level(self.anchor_ratios)):
            anchors = []
            for s in scales:
                area = float(s) ** 2
                for r in ratios:
                    w = math.sqrt(area / r)
                    h = r * w
                    anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
            out.append(np.asarray(anchors, np.float32))
        return out

    def __call__(self, feat_sizes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
        """[(H, W), ...] per level → [(H*W*A, 4) xyxy anchors] on device."""
        outs = []
        for (h, w), stride, base in zip(feat_sizes, self.strides, self.base_anchors()):
            shift = self.offset * stride
            gx, gy = np.meshgrid(shift + stride * np.arange(w, dtype=np.float32),
                                 shift + stride * np.arange(h, dtype=np.float32))
            gx, gy = gx.reshape(-1), gy.reshape(-1)
            grids = np.stack([gx, gy, gx, gy], axis=1)
            anchors = (grids[:, None, :] + base[None, :, :]).reshape(-1, 4)
            outs.append(torch.from_numpy(anchors).to(device))
        return outs


@dataclass(frozen=True)
class AnchorPointGenerator:
    """The FCOS family's anchor points: per level (H·W, 2) xy at (grid +
    offset) · stride, row-major (y outer, x inner), built in numpy as the JAX
    package builds them, then moved to the device."""

    strides: Sequence[int] = (8, 16, 32, 64, 128)
    offset: float = 0.5

    def __call__(self, feat_sizes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
        outs = []
        for (h, w), stride in zip(feat_sizes, self.strides):
            shift = self.offset * stride
            gx, gy = np.meshgrid(shift + stride * np.arange(w, dtype=np.float32),
                                 shift + stride * np.arange(h, dtype=np.float32))
            outs.append(torch.from_numpy(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)).to(device))
        return outs


@dataclass(frozen=True)
class FastPointGenerator:
    """Per level, (H·W, 2) anchor coordinates in image pixels (grid · stride,
    offset 0: the cells' top-left corners), row-major (y outer, x inner), and
    the matching (H·W,) stride vector."""

    strides: Sequence[int] = (8, 16, 32)
    offset: float = 0.0

    def __call__(
        self, feat_sizes: Sequence[Tuple[int, int]], device
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        grids, strides = [], []
        for (h, w), stride in zip(feat_sizes, self.strides):
            shift = self.offset * stride
            xs = shift + stride * torch.arange(w, dtype=torch.float32, device=device)
            ys = shift + stride * torch.arange(h, dtype=torch.float32, device=device)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            grids.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1))
            strides.append(torch.full((h * w,), float(stride), device=device))
        return grids, strides
