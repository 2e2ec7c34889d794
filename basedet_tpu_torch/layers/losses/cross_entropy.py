"""Elementwise binary cross-entropy (counterpart of
``basedet_tpu/layers/losses/cross_entropy.py``). Reductions are the caller's."""
from __future__ import annotations

import torch


def binary_cross_entropy(pred: torch.Tensor, label: torch.Tensor, with_logits: bool = True) -> torch.Tensor:
    """``with_logits``: ``max(x, 0) - x*z + log1p(exp(-|x|))``, the JAX
    package's formula term by term, so values and gradients agree."""
    if with_logits:
        return torch.maximum(pred, torch.zeros_like(pred)) - pred * label + torch.log1p(torch.exp(-pred.abs()))
    eps = 1e-7
    p = pred.clamp(eps, 1 - eps)
    return -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
