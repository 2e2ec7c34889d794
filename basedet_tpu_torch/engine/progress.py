"""Epoch/iter progress of the trainer and its hooks (a copy of
``basedet_tpu/engine/progress.py``: importing that module runs
``basedet_tpu/engine/__init__.py``, which imports JAX)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Progress:
    epoch: int = 1          # 1-based
    inner_iter: int = 1     # 1-based within epoch
    max_epoch: int = 1
    max_iter: int = 1       # per-epoch iters

    @property
    def current_iter(self) -> int:
        """Global 1-based iteration index."""
        return (self.epoch - 1) * self.max_iter + self.inner_iter

    @property
    def total_iter(self) -> int:
        return self.max_epoch * self.max_iter

    def scale_to_iterwise(self, epochs: List[int]) -> List[int]:
        return [e * self.max_iter for e in epochs]

    def iter_done(self) -> None:
        self.inner_iter += 1

    def epoch_done(self) -> None:
        self.epoch += 1
        self.inner_iter = 1

    def is_last_iter(self) -> bool:
        return self.inner_iter >= self.max_iter

    def is_last_epoch(self) -> bool:
        return self.epoch >= self.max_epoch

    def progress_str_list(self) -> List[str]:
        return [
            f"epoch: {self.epoch}/{self.max_epoch}",
            f"iter: {self.inner_iter}/{self.max_iter}",
        ]

    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self.epoch,
            "inner_iter": self.inner_iter,
            "max_epoch": self.max_epoch,
            "max_iter": self.max_iter,
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        for k, v in state.items():
            setattr(self, k, v)
