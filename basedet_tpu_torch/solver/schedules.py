"""Learning-rate schedules as step → lr functions (counterpart of
``basedet_tpu/solver/schedules.py``). The step is the 0-based count of steps
taken before the one the LR is for; the LR is a Python float. Ported:
``multistep_lr`` and YOLOX's schedule."""
from __future__ import annotations

import math
from typing import Callable, Sequence


def multistep_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_iters: int = 0,
    warmup_factor: float = 0.001,
) -> Callable[[int], float]:
    """Step decay by ``gamma`` at each of ``milestones``, under a linear
    warm-up from ``warmup_factor`` of the LR over ``warmup_iters`` steps."""
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** sum(step >= m for m in milestones)
        if step < warmup_iters:
            alpha = min(max(step / warmup_iters, 0.0), 1.0)
            lr *= warmup_factor * (1 - alpha) + alpha
        return lr

    return schedule


def yolox_cosine_lr(
    base_lr: float,
    total_iters: int,
    warmup_iters: int,
    no_aug_iters: int,
    min_lr_ratio: float = 0.05,
) -> Callable[[int], float]:
    """Quadratic warm-up → cosine → floor at min_lr for the no-aug tail."""
    min_lr = base_lr * min_lr_ratio
    cos_end = total_iters - no_aug_iters

    def schedule(step: int) -> float:
        if step >= cos_end:
            return min_lr
        if step < warmup_iters:
            return base_lr * min(max(step / max(warmup_iters, 1), 0.0), 1.0) ** 2
        progress = min(max((step - warmup_iters) / max(cos_end - warmup_iters, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return schedule
