"""The port's own registries (counterpart of ``basedet_tpu/utils/registry.py``).

``Registry`` is a copy of the JAX package's class, cut to what the port
uses. The registries hold the port's classes under the same names
(``MODEL.NAME``, ``TEST.EVALUATOR_NAME``, ``DATA.BUILDER_NAME``,
``SOLVER.BUILDER_NAME``, ``HOOKS.BUILDER_NAME``, ``TRAINER.NAME``), so a
config tree of either package builds the port."""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

import torch

from basedet_tpu_torch import parallel

class Registry:
    """Name -> object map filled by the ``@registry.register()`` decorator."""

    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None, overwrite: bool = False):
        """Use as ``@reg.register()`` decorator or ``reg.register(obj)``.
        ``overwrite=True`` replaces an entry of that name."""
        if obj is None:
            def deco(o, _name=name):
                self._do_register(_name or o.__name__, o, overwrite)
                return o
            return deco
        self._do_register(name or obj.__name__, obj, overwrite)
        return obj

    def _do_register(self, name: str, obj: Any, overwrite: bool = False) -> None:
        if not overwrite and name in self._map and self._map[name] is not obj:
            raise KeyError(f"{name!r} already registered in registry {self._name!r}")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}; "
                f"known: {sorted(self._map)}"
            )
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map


class _Registers:
    def __init__(self):
        self.models = Registry("models")
        self.evaluators = Registry("evaluators")
        self.dataloader = Registry("dataloader")
        self.solvers = Registry("solvers")
        self.hooks = Registry("hooks")
        self.trainers = Registry("trainers")
        self.transforms = Registry("transforms")
        self.datasets_info = Registry("datasets_info")


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
    ``device``), train loader (pinned for a CUDA ``device``; the rank's rows
    under a process group), solver (at the process group's world size) and
    hook list."""
    all_register()
    model = build_model(cfg, device)
    dataloader = registers.dataloader.get(cfg.DATA.BUILDER_NAME).build(cfg, device)
    solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg, parallel.world_size())
    hooks = registers.hooks.get(cfg.HOOKS.BUILDER_NAME).build(cfg)
    return registers.trainers.get(cfg.TRAINER.NAME)(cfg, model, dataloader, solver, hooks)
