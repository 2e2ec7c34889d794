"""Sigmoid focal loss, elementwise (counterpart of
``basedet_tpu/layers/losses/sigmoid_focal_loss.py``), built on the port's
``binary_cross_entropy`` with the JAX package's term order."""
from __future__ import annotations

import torch

from .cross_entropy import binary_cross_entropy


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = -1,
                       gamma: float = 0) -> torch.Tensor:
    """FL(p_t) = -alpha_t (1 - p_t)^gamma log(p_t); no reduction. ``alpha < 0``
    drops the class weighting, ``gamma == 0`` the modulating factor."""
    scores = torch.sigmoid(logits)
    loss = binary_cross_entropy(logits, targets, with_logits=True)
    if gamma != 0:
        loss = loss * (targets * (1 - scores) + (1 - targets) * scores) ** gamma
    if alpha >= 0:
        loss = loss * (targets * alpha + (1 - targets) * (1 - alpha))
    return loss
