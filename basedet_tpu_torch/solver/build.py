"""Solvers: config → SGD optimizer, LR schedule and gradient clipping
(counterpart of ``basedet_tpu/solver/build.py``). One device: the world size
is 1. Only ``YOLOXSolver`` is ported.

optax's ``add_decayed_weights → trace(nesterov) → scale(-lr)`` is
``torch.optim.SGD(weight_decay, momentum, nesterov=True)`` with the LR set
before each step, which the train step does (``engine/train_state.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch

from basedet_tpu_torch.solver.schedules import yolox_cosine_lr
from basedet_tpu_torch.utils.registry import registers


def iters_per_epoch(cfg, world_size: int = 1) -> int:
    s = cfg.SOLVER
    return max(1, int(s.NUM_IMAGE_PER_EPOCH / world_size / cfg.MODEL.BATCHSIZE))


def build_schedule(cfg, base_lr: float, world_size: int = 1) -> Tuple[Callable[[int], float], int]:
    """(schedule, total iterations) from ``cfg.SOLVER``. ``WARM_ITERS`` is
    given, or derived from ``WARM_EPOCH`` when it is None."""
    s = cfg.SOLVER
    per_epoch = iters_per_epoch(cfg, world_size)
    total = s.MAX_EPOCH * per_epoch
    warm = s.get("WARM_ITERS", 0)
    if warm is None:
        warm = int(s.get("WARM_EPOCH", 0) * per_epoch)
    name = s.get("LR_SCHEDULER_NAME", "MultiStepLR")
    if name != "YoloxCosineLR":
        raise NotImplementedError(f"LR schedule {name!r} is not ported to basedet_tpu_torch yet")
    extra = s.get("EXTRA_LR_ARGS", {})
    return yolox_cosine_lr(
        base_lr, total, warmup_iters=warm,
        no_aug_iters=extra.get("NO_AUG_EPOCH", 15) * per_epoch,
        min_lr_ratio=extra.get("MIN_LR_RATIO", 0.05),
    ), total


@dataclass
class Solver:
    """What the trainer needs of a solver: the optimizer for a module, the
    schedule, and the clipping applied to the gradients before the step."""

    lr_schedule: Callable[[int], float]
    base_lr: float
    max_iters: int
    weight_decay: float
    momentum: float
    grad_clip: Optional[Tuple[str, float]] = None  # ("value", upper) | ("norm", max_norm)

    def make_optimizer(self, module: torch.nn.Module) -> torch.optim.SGD:
        """Nesterov SGD in two groups: weight decay on conv kernels (ndim >
        1), none on biases and BN weights."""
        decay, no_decay = [], []
        for name, p in module.named_parameters():
            (no_decay if name.endswith("bias") or p.ndim <= 1 else decay).append(p)
        return torch.optim.SGD(
            [{"params": decay, "weight_decay": self.weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=self.lr_schedule(0), momentum=self.momentum, nesterov=True,
        )

    @torch.no_grad()
    def clip_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """``optax.clip`` / ``optax.clip_by_global_norm``, in place."""
        if self.grad_clip is None:
            return
        kind, limit = self.grad_clip
        grads = [p.grad for p in params if p.grad is not None]
        if kind == "value":
            for g in grads:
                g.clamp_(-limit, limit)
            return
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < limit, 1.0, limit / norm)
        for g in grads:
            g.mul_(scale)


def _grad_clip(trainer_cfg) -> Optional[Tuple[str, float]]:
    gc = trainer_cfg.GRAD_CLIP
    if not gc.ENABLE:
        return None
    if gc.TYPE == "value":
        return ("value", float(gc.ARGS.get("upper", 1.0)))
    if gc.TYPE == "norm":
        return ("norm", float(gc.ARGS.get("max_norm", 1.0)))
    raise ValueError(f"unknown grad clip type {gc.TYPE}")


@registers.solvers.register()
class YOLOXSolver:
    """Nesterov SGD, LR = BASIC_LR · BATCHSIZE · world, YOLOX's cosine
    schedule, no weight decay on biases and BN weights."""

    @classmethod
    def build(cls, cfg, world_size: int = 1) -> Solver:
        s = cfg.SOLVER
        lr = s.BASIC_LR * cfg.MODEL.BATCHSIZE * world_size
        schedule, total = build_schedule(cfg, lr, world_size)
        return Solver(
            lr_schedule=schedule, base_lr=lr, max_iters=total, weight_decay=s.WEIGHT_DECAY,
            momentum=s.get("EXTRA_OPT_ARGS", {}).get("momentum", 0.9),
            grad_clip=_grad_clip(cfg.TRAINER),
        )
