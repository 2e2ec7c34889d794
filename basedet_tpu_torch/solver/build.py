"""Solvers: config → optimizer, LR schedule and gradient clipping
(counterpart of ``basedet_tpu/solver/build.py``), at the world size the
trainer gives (the process group's): it scales the LR (or, under
``REDUCE_MODE`` SUM, the weight decay) and divides the iterations per epoch
as the JAX package does at that device count. ``DefaultSolver`` (SGD, AdamW or Adam), ``DetSolver``, ``YOLOXSolver``
and ``DetrSolver``, under ``MultiStepLR``, ``CosineLR`` or ``YoloxCosineLR``.

optax's ``add_decayed_weights → trace(nesterov) → scale(-lr)`` is
``torch.optim.SGD(weight_decay, momentum, nesterov)`` with the LR set before
each step, which the train step does (``engine/train_state.py``), times a
parameter group's ``lr_ratio``. ``optax.adamw`` computes p - lr·(û + wd·p)
and decays every leaf, biases and norms too; ``torch.optim.AdamW`` computes
p·(1 - lr·wd) - lr·û, the same up to rounding. ``optax.adam`` has no decay.
The schedule's count is 0 at the first update in both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from basedet_tpu_torch.solver.schedules import cosine_lr, multistep_lr, yolox_cosine_lr
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
    extra = s.get("EXTRA_LR_ARGS", {})
    if name == "CosineLR":
        return cosine_lr(base_lr, total, warmup_iters=warm, **extra), total
    if name != "YoloxCosineLR":
        raise NotImplementedError(f"LR schedule {name!r} is not ported to basedet_tpu_torch yet")
    return yolox_cosine_lr(
        base_lr, total, warmup_iters=warm,
        no_aug_iters=extra.get("NO_AUG_EPOCH", 15) * per_epoch,
        min_lr_ratio=extra.get("MIN_LR_RATIO", 0.05),
    ), total


def _decays_all(name: str, param: torch.Tensor) -> bool:
    return True


def _decays_none(name: str, param: torch.Tensor) -> bool:
    return False


def _same_lr(name: str) -> float:
    return 1.0


def _decays_kernels(name: str, param: torch.Tensor) -> bool:
    """Weight decay on conv and dense kernels (ndim > 1), none on biases and
    norm weights."""
    return not (name.endswith("bias") or param.ndim <= 1)


def _scaled_lr_wd(cfg, world_size: int) -> Tuple[float, float]:
    """LR = BASIC_LR · BATCHSIZE, times the world size under ``REDUCE_MODE``
    MEAN; else the weight decay takes that factor."""
    s = cfg.SOLVER
    lr, wd = s.BASIC_LR * cfg.MODEL.BATCHSIZE, s.WEIGHT_DECAY
    if s.get("REDUCE_MODE", "MEAN") == "MEAN":
        return lr * world_size, wd
    return lr, wd * world_size


@dataclass
class Solver:
    """What the trainer needs of a solver: the optimizer for a module, the
    schedule, and the clipping applied to the gradients before the step.
    ``optimizer`` ("SGD", "AdamW" or "Adam"), ``momentum`` and ``nesterov``
    (SGD), ``betas`` (Adam), ``decays`` (name, parameter → whether weight
    decay applies) and ``lr_ratio`` (name → the factor on the schedule's LR)
    carry what differs between the solvers."""

    lr_schedule: Callable[[int], float]
    base_lr: float
    max_iters: int
    weight_decay: float
    momentum: float = 0.0
    grad_clip: Optional[Tuple[str, float]] = None  # ("value", upper) | ("norm", max_norm)
    nesterov: bool = False
    decays: Callable[[str, torch.Tensor], bool] = _decays_all
    optimizer: str = "SGD"
    betas: Tuple[float, float] = (0.9, 0.999)
    lr_ratio: Callable[[str], float] = _same_lr

    def param_groups(self, module: torch.nn.Module) -> List[Dict]:
        """The module's trainable parameters in groups of one LR ratio and one
        weight decay, the larger ratio first and those that decay first. A
        frozen parameter (``requires_grad`` False) is in none: it gets
        neither update nor decay."""
        groups: Dict[Tuple[float, bool], List[torch.nn.Parameter]] = {}
        for name, p in module.named_parameters():
            if p.requires_grad:
                groups.setdefault((self.lr_ratio(name), self.decays(name, p)), []).append(p)
        return [{"params": ps, "weight_decay": self.weight_decay if decays else 0.0, "lr_ratio": ratio}
                for (ratio, decays), ps in sorted(groups.items(), key=lambda kv: (-kv[0][0], not kv[0][1]))]

    def make_optimizer(self, module: torch.nn.Module) -> torch.optim.Optimizer:
        groups, lr = self.param_groups(module), self.lr_schedule(0)
        if self.optimizer == "SGD":
            return torch.optim.SGD(groups, lr=lr, momentum=self.momentum, nesterov=self.nesterov)
        if self.optimizer in ("AdamW", "Adam"):
            cls = torch.optim.AdamW if self.optimizer == "AdamW" else torch.optim.Adam
            return cls(groups, lr=lr, betas=self.betas, eps=1e-8)
        raise ValueError(f"unknown optimizer {self.optimizer}")

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
    """``OPTIMIZER_NAME`` SGD (momentum and coupled weight decay on every
    trainable parameter, biases too), AdamW (``EXTRA_OPT_ARGS.betas``,
    decoupled decay on every parameter) or Adam (default betas, no decay);
    LR = BASIC_LR · BATCHSIZE, times the world size under ``REDUCE_MODE``
    MEAN (else the weight decay takes that factor)."""

    @classmethod
    def build(cls, cfg, world_size: int = 1) -> Solver:
        s = cfg.SOLVER
        opt_name = s.get("OPTIMIZER_NAME", "SGD")
        if opt_name not in ("SGD", "AdamW", "Adam"):
            raise ValueError(f"unknown optimizer {opt_name}")
        lr, wd = _scaled_lr_wd(cfg, world_size)
        schedule, total = build_schedule(cfg, lr, world_size)
        extra = s.get("EXTRA_OPT_ARGS", {})
        return Solver(
            lr_schedule=schedule, base_lr=lr, max_iters=total, weight_decay=wd,
            momentum=extra.get("momentum", 0.0), grad_clip=_grad_clip(cfg.TRAINER),
            nesterov=extra.get("nesterov", False), optimizer=opt_name,
            decays=_decays_none if opt_name == "Adam" else _decays_all,
            betas=tuple(extra.get("betas", (0.9, 0.999))) if opt_name == "AdamW" else (0.9, 0.999),
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


@registers.solvers.register()
class DetrSolver:
    """AdamW (default betas) with decoupled decay on every trainable
    parameter; the backbone's (``bottom_up``) at ``BACKBONE_LR_RATIO`` times
    the schedule's LR; the stem (``FREEZE_AT`` >= 1) and ``layer1`` (>= 2)
    frozen, with no update and no decay, as ``DetSolver`` freezes them
    (``requires_grad`` off in the backbone); the gradient clipped before the
    optimizer. The JAX package's labels test ``"conv1" in path`` under
    ``bottom_up``, which also freezes every bottleneck's first conv
    (``layer2_0/conv1``, ...): a fault of the reference, not ported."""

    @classmethod
    def build(cls, cfg, world_size: int = 1) -> Solver:
        lr, wd = _scaled_lr_wd(cfg, world_size)
        schedule, total = build_schedule(cfg, lr, world_size)
        ratio = float(cfg.SOLVER.get("BACKBONE_LR_RATIO", 0.1))
        return Solver(
            lr_schedule=schedule, base_lr=lr, max_iters=total, weight_decay=wd,
            grad_clip=_grad_clip(cfg.TRAINER), optimizer="AdamW",
            lr_ratio=lambda name: ratio if name.startswith("bottom_up.") else 1.0,
        )
