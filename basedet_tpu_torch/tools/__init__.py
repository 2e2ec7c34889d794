"""Command-line entry points of the port. ``import_config`` loads a user
config file (``class Cfg``) by path."""
from basedet_tpu_torch.tools.misc import import_config

__all__ = ["import_config"]
