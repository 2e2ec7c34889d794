"""The solver and EMA in plain PyTorch: SGD with momentum (Nesterov's or
not) and coupled weight decay, YOLOX's warm-cosine and the multistep
schedules, and the EMA of the parameters, as a configuration file's
``solver`` and ``ema`` sections state them."""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(s: Dict, step: int) -> float:
    """The LR for the step after ``step`` steps taken."""
    base, warm = s["base_lr"], s["warmup_iters"]
    if s["schedule"] == "yolox_cosine":
        min_lr = base * s["min_lr_ratio"]
        cos_end = s["total_iters"] - s["no_aug_iters"]
        if step >= cos_end:
            return min_lr
        if step < warm:
            return base * min(max(step / max(warm, 1), 0.0), 1.0) ** 2
        progress = min(max((step - warm) / max(cos_end - warm, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base - min_lr) * (1 + math.cos(math.pi * progress))
    if s["schedule"] == "multistep":
        lr = base * s["gamma"] ** sum(step >= m for m in s["milestones"])
        if step < warm:
            alpha = min(max(step / warm, 0.0), 1.0)
            lr *= s["warmup_factor"] * (1 - alpha) + alpha
        return lr
    raise ValueError(f"unknown schedule {s['schedule']!r}")


def decays(rule: str, name: str, p: torch.Tensor) -> bool:
    if rule == "all":
        return True
    if rule == "kernels":  # conv and dense kernels only
        return not (name.endswith("bias") or p.ndim <= 1)
    raise ValueError(f"unknown weight-decay rule {rule!r}")


class SGD:
    """``p -= lr * u`` with ``d = g + wd p`` (where the rule decays p),
    ``buf = d`` at the first step and ``momentum * buf + d`` after, and
    ``u = d + momentum * buf`` (Nesterov) or ``buf``."""

    def __init__(self, named_params: List, s: Dict):
        self.s = s
        self.params = [(n, p) for n, p in named_params if p.requires_grad]
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        s = self.s
        for n, p in self.params:
            if p.grad is None:
                continue
            d = p.grad + s["weight_decay"] * p if decays(s["weight_decay_rule"], n, p) else p.grad.clone()
            buf = self.buf.get(n)
            buf = d.clone() if buf is None else buf.mul_(s["momentum"]).add_(d)
            self.buf[n] = buf
            p.sub_(lr * (d + s["momentum"] * buf if s["nesterov"] else buf))


def ema_momentum(e: Dict, total_iters: int) -> float:
    return max(0.0, 1.0 - e["alpha"] * (90000 * e["update_period"] / total_iters))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], named_params: List, e: Dict, step: int, total_iters: int) -> None:
    """The EMA after the update of step ``step`` (0-based): the parameters
    themselves until burn-in, then ``m ema + (1 - m) p`` every period."""
    m = 0.0 if step < e["burnin_iters"] else ema_momentum(e, total_iters)
    if not (step % e["update_period"] == 0 or step <= e["burnin_iters"]):
        m = 1.0
    for n, p in named_params:
        ema[n].mul_(m).add_(p, alpha=1.0 - m)
