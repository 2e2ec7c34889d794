"""Logging (the port's own copy of ``basedet_tpu/utils/logger.py``; stdlib
``logging``): a rank-0-only stderr sink plus a timestamped log file under the
output dir. Both packages log to the logger named ``basedet``.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

_FMT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger("basedet")


def setup_logger(
    output_dir: Optional[str] = None,
    rank: int = 0,
    level: int = logging.INFO,
    file_prefix: str = "train_log",
) -> logging.Logger:
    """Configure the global 'basedet' logger.

    Only rank 0 logs to stderr; every rank may get its own file sink
    (rank suffixed) when ``output_dir`` is given.
    """
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)

    formatter = logging.Formatter(_FMT, datefmt=_DATEFMT)
    if rank == 0:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    else:
        logger.addHandler(logging.NullHandler())

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        suffix = f"_rank{rank}" if rank else ""
        path = os.path.join(output_dir, f"{file_prefix}_{stamp}{suffix}.txt")
        fh = logging.FileHandler(path)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
