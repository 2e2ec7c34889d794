"""Windowed metric meters (the port's own copy of
``basedet_tpu/utils/meters.py``).
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Mapping

import numpy as np


class AverageMeter:
    """Tracks latest / windowed-average / global-average / median of a scalar."""

    def __init__(self, window_size: int = 50):
        self._window = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value) -> None:
        value = float(value)
        self._window.append(value)
        self._total += value
        self._count += 1

    def reset(self) -> None:
        self._window.clear()
        self._total = 0.0
        self._count = 0

    @property
    def latest(self) -> float:
        return self._window[-1] if self._window else float("nan")

    @property
    def avg(self) -> float:
        return float(np.mean(self._window)) if self._window else float("nan")

    @property
    def median(self) -> float:
        return float(np.median(self._window)) if self._window else float("nan")

    @property
    def global_avg(self) -> float:
        return self._total / max(self._count, 1)

    def __len__(self) -> int:
        return len(self._window)


class MeterBuffer(defaultdict):
    """Dict of AverageMeters with batched update."""

    def __init__(self, window_size: int = 50):
        super().__init__(lambda: AverageMeter(window_size))

    def update(self, values: Mapping = None, **kwargs) -> None:
        merged: Dict = dict(values or {})
        merged.update(kwargs)
        for k, v in merged.items():
            if hasattr(v, "item"):
                v = v.item()
            self[k].update(v)

    def reset(self) -> None:
        for m in self.values():
            m.reset()

    def get_filtered_meter(self, filter_key: str) -> Dict[str, AverageMeter]:
        return {k: v for k, v in self.items() if filter_key in k}
