"""CLI plumbing of the port (its own copy of ``basedet_tpu/tools/misc.py``):
``-f config.py`` imports a file defining ``class Cfg``; trailing ``KEY VALUE``
opts merge into the config.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys


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
                        help="JAX's sync debugging; refused by the port, which runs eagerly")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the network to trade FLOPs for memory (TRAINER.REMAT)")
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, default=None,
        help="config override key/value pairs",
    )
    return parser


def apply_common_flags(cfg, args) -> None:
    """Map CLI booleans onto config fields. ``--debug`` configures JAX in the
    JAX package; the port refuses it."""
    if getattr(args, "debug", False):
        raise ValueError("--debug configures JAX; basedet_tpu_torch runs eagerly already")
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
