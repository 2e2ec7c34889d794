"""The port's own registries (counterpart of ``basedet_tpu/utils/registry.py``).

They reuse the JAX package's ``Registry`` class and hold the port's classes
under the same names (``MODEL.NAME``, ``TEST.EVALUATOR_NAME``,
``DATA.BUILDER_NAME``, ``SOLVER.BUILDER_NAME``, ``HOOKS.BUILDER_NAME``,
``TRAINER.NAME``), so one config file drives both packages."""
from __future__ import annotations

import importlib
from typing import Optional

import torch

from basedet_tpu.utils.registry import Registry


class _Registers:
    def __init__(self):
        self.models = Registry("models")
        self.evaluators = Registry("evaluators")
        self.dataloader = Registry("dataloader")
        self.solvers = Registry("solvers")
        self.hooks = Registry("hooks")
        self.trainers = Registry("trainers")


registers = _Registers()

# modules whose import runs the registration decorators
_REGISTRATION_MODULES = (
    "basedet_tpu_torch.models", "basedet_tpu_torch.evaluators", "basedet_tpu_torch.data",
    "basedet_tpu_torch.solver", "basedet_tpu_torch.engine",
)


def all_register() -> None:
    for mod in _REGISTRATION_MODULES:
        importlib.import_module(mod)


def build_model(cfg, device, generator: Optional[torch.Generator] = None):
    """The ``cfg.MODEL.NAME`` model on ``device``, its weights drawn from
    ``generator`` (a generator on ``device`` seeded 0 when none is given)."""
    all_register()
    return registers.models.get(cfg.MODEL.NAME)(cfg, torch.device(device), generator)


def build_evaluator(cfg):
    all_register()
    return registers.evaluators.get(cfg.TEST.EVALUATOR_NAME)(cfg)


def build_trainer(cfg, device):
    """The ``cfg.TRAINER.NAME`` trainer around the config's model (on
    ``device``), train loader, solver and hook list."""
    all_register()
    model = build_model(cfg, device)
    dataloader = registers.dataloader.get(cfg.DATA.BUILDER_NAME).build(cfg)
    solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg)
    hooks = registers.hooks.get(cfg.HOOKS.BUILDER_NAME).build(cfg)
    return registers.trainers.get(cfg.TRAINER.NAME)(cfg, model, dataloader, solver, hooks)
