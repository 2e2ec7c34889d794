"""CLI plumbing of the port (its own copy of ``basedet_tpu/tools/misc.py``):
``-f config.py`` imports a file defining ``class Cfg``; trailing ``KEY VALUE``
opts merge into the config.

``--debug`` is the counterpart of the JAX package's ``jax_disable_jit`` and
``jax_debug_nans`` (``enable_debug``): kernels launch synchronously
(``CUDA_LAUNCH_BLOCKING=1``, so that an error points at its launch), every
module's output is checked as it is made and the first non-finite one
raises ``FloatingPointError`` naming the module (a global forward hook), and
the backward runs under ``torch.autograd.set_detect_anomaly(True,
check_nan=True)``, which names the forward operation whose gradient went
non-finite. ``disable_debug`` undoes it.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import weakref

import torch


def import_config(config_file: str, class_name: str = "Cfg"):
    """Import ``config_file`` and instantiate its ``Cfg`` class (the user
    config protocol: basedet_tpu_torch/playground/.../config.py)."""
    path = os.path.abspath(config_file)
    spec = importlib.util.spec_from_file_location("user_config", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["user_config"] = mod
    spec.loader.exec_module(mod)
    cfg_cls = getattr(mod, class_name)
    return cfg_cls()


def default_parser(description: str = "basedet_tpu_torch") -> argparse.ArgumentParser:
    """The JAX package's flags, so that one command line parses in both;
    the entry points refuse the ones the port has not ported."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-f", "--file", type=str, required=False,
                        default="config.py", help="config file path")
    parser.add_argument("--resume", action="store_true", help="resume training")
    parser.add_argument("--amp", action="store_true", help="bf16 compute policy (TRAINER.AMP.ENABLE)")
    parser.add_argument("--ema", action="store_true", help="enable model EMA")
    parser.add_argument("--tb", action="store_true", help="enable tensorboard")
    parser.add_argument("-w", "--weights", type=str, default=None,
                        help="weights file for testing")
    parser.add_argument("--debug", action="store_true",
                        help="synchronous launches, and raise at the first non-finite module output or gradient")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the network to trade FLOPs for memory (TRAINER.REMAT)")
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, default=None,
        help="config override key/value pairs",
    )
    return parser


_PARENTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # module -> (parent, attribute name)
_DEBUG_HANDLES: list = []  # the hooks while debug is on, then the CUDA_LAUNCH_BLOCKING it found


def module_name(module: torch.nn.Module) -> str:
    """``module``'s dotted path from the outermost module built while debug
    was on (``backbone.dark5.conv3.bn``), with its class."""
    names, m = [], module
    while m in _PARENTS:
        m, name = _PARENTS[m]
        names.append(name)
    return f"{'.'.join(reversed(names)) or '<root>'} ({type(module).__name__})"


def _register(parent, name, child):
    if child is not None:
        _PARENTS[child] = (parent, name)


def _check_finite(module, inputs, output):
    stack = [output]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise FloatingPointError(f"--debug: non-finite output of {module_name(module)}, shape "
                                         f"{tuple(x.shape)}")
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())


def enable_debug() -> None:
    """Turn ``--debug`` on for this process: ``CUDA_LAUNCH_BLOCKING=1``
    (effective only where CUDA has not started yet, so the entry points call
    this before they touch the device), the forward check on every module
    and anomaly detection with NaN checks in the backward. Modules built
    after this call are named by their path; others by their class."""
    if _DEBUG_HANDLES:
        return
    from torch.nn.modules import module as nn_module

    _DEBUG_HANDLES.extend([os.environ.get("CUDA_LAUNCH_BLOCKING"),
                           nn_module.register_module_module_registration_hook(_register),
                           nn_module.register_module_forward_hook(_check_finite)])
    os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
    torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_debug() -> None:
    """Undo ``enable_debug``: the hooks removed, anomaly detection off,
    ``CUDA_LAUNCH_BLOCKING`` as it was."""
    if not _DEBUG_HANDLES:
        return
    blocking, *handles = _DEBUG_HANDLES
    _DEBUG_HANDLES.clear()
    for handle in handles:
        handle.remove()
    torch.autograd.set_detect_anomaly(False)
    if blocking is None:
        os.environ.pop("CUDA_LAUNCH_BLOCKING", None)
    else:
        os.environ["CUDA_LAUNCH_BLOCKING"] = blocking


def apply_common_flags(cfg, args) -> None:
    """Map CLI booleans onto config fields; ``--debug`` calls
    ``enable_debug``."""
    if getattr(args, "debug", False):
        enable_debug()
    if getattr(args, "remat", False):
        cfg.TRAINER.REMAT = True
    if args.opts:
        cfg.merge(args.opts)
    if getattr(args, "resume", False):
        cfg.TRAINER.RESUME = True
    if getattr(args, "amp", False):
        cfg.TRAINER.AMP.ENABLE = True
    if getattr(args, "ema", False):
        cfg.TRAINER.EMA.ENABLE = True
    if getattr(args, "tb", False):
        cfg.GLOBAL.TENSORBOARD.ENABLE = True


def resolve_device(name: str) -> torch.device:
    """The device an entry point's ``--device`` names; ``cuda`` without CUDA
    raises, as the entry points never swap it for the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu explicitly")
    return device
