"""Solvers: config → SGD optimizer, LR schedule and gradient clipping
(counterpart of ``basedet_tpu/solver/build.py``). One device: the world size
is 1. Ported: ``DefaultSolver``, ``DetSolver`` and ``YOLOXSolver`` with SGD
under ``MultiStepLR`` or ``YoloxCosineLR``. ``CosineLR`` and the AdamW and
Adam optimizers are refused by name until a ported model needs them;
``DetrSolver`` is not registered, and the registry says so.

optax's ``add_decayed_weights → trace(nesterov) → scale(-lr)`` is
``torch.optim.SGD(weight_decay, momentum, nesterov)`` with the LR set before
each step, which the train step does (``engine/train_state.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch

from basedet_tpu_torch.solver.schedules import multistep_lr, yolox_cosine_lr
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
    if name == "MultiStepLR":
        return multistep_lr(
            base_lr, [m * per_epoch for m in s.LR_DECAY_STAGES],
            gamma=s.get("LR_DECAY_RATE", 0.1), warmup_iters=warm,
        ), total
    if name != "YoloxCosineLR":
        raise NotImplementedError(f"LR schedule {name!r} is not ported to basedet_tpu_torch yet")
    extra = s.get("EXTRA_LR_ARGS", {})
    return yolox_cosine_lr(
        base_lr, total, warmup_iters=warm,
        no_aug_iters=extra.get("NO_AUG_EPOCH", 15) * per_epoch,
        min_lr_ratio=extra.get("MIN_LR_RATIO", 0.05),
    ), total


def _decays_all(name: str, param: torch.Tensor) -> bool:
    return True


def _decays_kernels(name: str, param: torch.Tensor) -> bool:
    """Weight decay on conv and dense kernels (ndim > 1), none on biases and
    norm weights."""
    return not (name.endswith("bias") or param.ndim <= 1)


@dataclass
class Solver:
    """What the trainer needs of a solver: the optimizer for a module, the
    schedule, and the clipping applied to the gradients before the step.
    ``nesterov`` and ``decays`` (name, parameter → whether weight decay
    applies) carry what differs between the solvers."""

    lr_schedule: Callable[[int], float]
    base_lr: float
    max_iters: int
    weight_decay: float
    momentum: float
    grad_clip: Optional[Tuple[str, float]] = None  # ("value", upper) | ("norm", max_norm)
    nesterov: bool = False
    decays: Callable[[str, torch.Tensor], bool] = _decays_all

    def make_optimizer(self, module: torch.nn.Module) -> torch.optim.SGD:
        """SGD over the module's trainable parameters, those that decay in
        one group and the others in a second. A frozen parameter
        (``requires_grad`` False) is not given to the optimizer: it gets
        neither update nor decay."""
        decay, no_decay = [], []
        for name, p in module.named_parameters():
            if p.requires_grad:
                (decay if self.decays(name, p) else no_decay).append(p)
        groups = [{"params": decay, "weight_decay": self.weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        return torch.optim.SGD([g for g in groups if g["params"]], lr=self.lr_schedule(0),
                               momentum=self.momentum, nesterov=self.nesterov)

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
class DefaultSolver:
    """SGD with momentum and coupled weight decay on every trainable
    parameter, biases too; LR = BASIC_LR · BATCHSIZE, times the world size
    under ``REDUCE_MODE`` MEAN (else the weight decay takes that factor)."""

    @classmethod
    def build(cls, cfg, world_size: int = 1) -> Solver:
        s = cfg.SOLVER
        opt_name = s.get("OPTIMIZER_NAME", "SGD")
        if opt_name != "SGD":
            raise NotImplementedError(f"optimizer {opt_name!r} is not ported to basedet_tpu_torch yet")
        lr, wd = s.BASIC_LR * cfg.MODEL.BATCHSIZE, s.WEIGHT_DECAY
        if s.get("REDUCE_MODE", "MEAN") == "MEAN":
            lr = lr * world_size
        else:
            wd = wd * world_size
        schedule, total = build_schedule(cfg, lr, world_size)
        extra = s.get("EXTRA_OPT_ARGS", {})
        return Solver(
            lr_schedule=schedule, base_lr=lr, max_iters=total, weight_decay=wd,
            momentum=extra.get("momentum", 0.0), grad_clip=_grad_clip(cfg.TRAINER),
            nesterov=extra.get("nesterov", False),
        )


@registers.solvers.register()
class DetSolver(DefaultSolver):
    """DefaultSolver for detectors with a frozen backbone stem: the JAX
    package gives the parameters under ``bottom_up/conv1`` (FREEZE_AT >= 1)
    and ``bottom_up/layer1`` (>= 2) zero updates and no decay. In the port
    the backbone turns ``requires_grad`` off for those
    (``models/cls/resnet.py``), and ``Solver.make_optimizer`` leaves every
    such parameter out."""


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
            grad_clip=_grad_clip(cfg.TRAINER), nesterov=True, decays=_decays_kernels,
        )
