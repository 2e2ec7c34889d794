"""Dropout and stochastic depth drawing from an explicit generator
(counterpart of ``basedet_tpu/layers/blocks/drop.py``, and of flax's
``nn.Dropout`` as the transformer uses it). ``F.dropout`` takes no
generator, so the keep masks are drawn with ``torch.rand(...,
generator=...)``: an element is kept where its uniform draw is below the keep
probability, as ``jax.random.bernoulli`` decides, and a kept element is
divided by that probability. A mask over the batch (leading dimension) is
drawn at the global batch's shape, of which the rank takes its rows
(``parallel.shard_rows``), so a rank draws its images' rows of the world
size 1 mask."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from basedet_tpu_torch.parallel import shard_rows, world_size


def keep_mask(shape: Sequence[int], keep_prob: float, generator: torch.Generator, device) -> torch.Tensor:
    """Bernoulli(``keep_prob``) of ``shape`` from ``generator``: bool, True = kept."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob


def batch_keep_mask(shape: Sequence[int], keep_prob: float, generator: torch.Generator, device) -> torch.Tensor:
    """``keep_mask`` of a per-rank ``shape`` whose leading dimension is the
    batch: the rank's rows of the mask of the global batch."""
    return shard_rows(keep_mask((shape[0] * world_size(), *shape[1:]), keep_prob, generator, device))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in train mode: ``x / keep`` where kept, 0
    elsewhere, for ``x`` (batch, ...). ``generator`` None means deterministic
    (eval mode); a rate of 0 returns ``x``."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(batch_keep_mask(x.shape, keep, generator, x.device), x / keep, 0.0)


def drop_path(x: torch.Tensor, drop_prob: float, generator: torch.Generator) -> torch.Tensor:
    """Drop whole residual branches per sample (train time only): one draw
    per leading index, the kept ones scaled by 1 / (1 - drop_prob)."""
    if drop_prob <= 0.0:
        return x
    keep = 1.0 - drop_prob
    mask = batch_keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, generator, x.device)
    return x / keep * mask


class DropPath(nn.Module):
    """``drop_path`` in train mode with a generator; the identity otherwise."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or generator is None or self.drop_prob <= 0.0:
            return x
        return drop_path(x, self.drop_prob, generator)
