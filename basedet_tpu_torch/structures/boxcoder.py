"""Box and point delta coders (counterpart of
``basedet_tpu/structures/boxcoder.py``), broadcast over leading axes:
``BoxCoder``, R-CNN's (dx, dy, dw, dh) with mean/std whitening (for
class-specific deltas (..., K, 4), broadcast the anchors to (..., 1, 4) at
the call site); ``SumBoxCoder``, gt - anchor whitened; ``PointCoder``, FCOS's
(l, t, r, b) distances from points.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch


def _to_cs(boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """xyxy -> (w, h, cx, cy), each (...)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h


@dataclass(frozen=True)
class BoxCoder:
    reg_mean: Sequence[float] = (0.0, 0.0, 0.0, 0.0)
    reg_std: Sequence[float] = (1.0, 1.0, 1.0, 1.0)

    def _mean_std(self, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.reg_mean, dtype=like.dtype, device=like.device),
                torch.tensor(self.reg_std, dtype=like.dtype, device=like.device))

    def encode(self, anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        aw, ah, acx, acy = _to_cs(anchors)
        gw, gh, gcx, gcy = _to_cs(gt)
        target = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                              torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
        mean, std = self._mean_std(target)
        return (target - mean) / std

    def decode(self, anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """anchors (..., 4), deltas (..., 4) -> boxes (..., 4) xyxy."""
        mean, std = self._mean_std(deltas)
        deltas = deltas * std + mean
        aw, ah, acx, acy = _to_cs(anchors)
        pcx = acx + deltas[..., 0] * aw
        pcy = acy + deltas[..., 1] * ah
        pw = aw * torch.exp(deltas[..., 2])
        ph = ah * torch.exp(deltas[..., 3])
        return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


@dataclass(frozen=True)
class SumBoxCoder:
    """Additive coder: target = gt - anchors, whitened."""

    reg_mean: Sequence[float] = (0.0, 0.0, 0.0, 0.0)
    reg_std: Sequence[float] = (1.0, 1.0, 1.0, 1.0)

    _mean_std = BoxCoder._mean_std

    def encode(self, anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        target = gt - anchors
        mean, std = self._mean_std(target)
        return (target - mean) / std

    def decode(self, anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        mean, std = self._mean_std(deltas)
        return anchors + (deltas * std + mean)


@dataclass(frozen=True)
class PointCoder:
    """(l, t, r, b) distances of xyxy boxes' edges from (..., 2) points."""

    def encode(self, points: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return torch.cat([points - gt[..., :2], gt[..., 2:4] - points], dim=-1)

    def decode(self, points: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        return torch.stack([points[..., 0] - deltas[..., 0], points[..., 1] - deltas[..., 1],
                            points[..., 0] + deltas[..., 2], points[..., 1] + deltas[..., 3]], dim=-1)
