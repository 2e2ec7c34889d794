"""Elementwise smooth-L1 (counterpart of ``basedet_tpu/layers/losses/smooth_l1_loss.py``);
``beta <= 0`` is plain L1."""
from __future__ import annotations

import torch


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
