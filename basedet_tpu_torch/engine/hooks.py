"""Training hooks (counterpart of ``basedet_tpu/engine/hooks.py``): host code
run between steps. Ported: logging, the LR hook, checkpoints. Resume, eval
and TensorBoard are not ported yet; ``engine/build.py`` refuses the configs
that ask for them."""
from __future__ import annotations

import datetime
import os
import time

import torch

from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.utils.registry import registers


class BaseHook:
    trainer = None  # set by the trainer

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_epoch(self):
        pass

    def after_epoch(self):
        pass

    def before_iter(self):
        pass

    def after_iter(self):
        pass


@registers.hooks.register()
class LoggerHook(BaseHook):
    """Losses, LR, times and ETA every ``log_interval`` iterations, from the
    meters the trainer fills at the same interval."""

    def __init__(self, log_interval: int = 20):
        self.log_interval = log_interval
        self.start_time = None

    def before_train(self):
        self.start_time = time.time()
        t = self.trainer
        logger.info(f"Starting training: {t.progress.max_epoch} epochs x "
                    f"{t.progress.max_iter} iters, world size {t.world_size}, "
                    f"global batch {t.global_batch_size}, device {t.model.device}")

    def after_iter(self):
        p = self.trainer.progress
        if p.current_iter % self.log_interval != 0:
            return
        meters = self.trainer.meters
        done, total = p.current_iter, p.total_iter
        elapsed = time.time() - self.start_time
        eta = datetime.timedelta(seconds=int(elapsed / max(done, 1) * (total - done)))
        loss_str = ", ".join(f"{k}: {m.avg:.4f}" for k, m in meters.items() if "loss" in k)
        extra = ", ".join(f"{k}: {m.avg:.4g}" for k, m in meters.items()
                          if "loss" not in k and "time" not in k)
        time_str = ", ".join(f"{k}: {m.avg * 1000:.0f}ms" for k, m in meters.items() if "time" in k)
        logger.info(f"{', '.join(p.progress_str_list())}, {loss_str}, {extra}, {time_str}, ETA: {eta}")


@registers.hooks.register()
class LRSchedulerHook(BaseHook):
    """Kept for the hook list's shape: the train step sets the LR from the
    schedule itself, and reports it in its metrics."""


@registers.hooks.register()
class CheckpointHook(BaseHook):
    """After each epoch, ``latest.pt`` and ``epoch_<n>.pt`` (every
    ``save_period`` epochs) with the module's state_dict, the optimizer, the
    EMA parameters, the step and the progress, and the file
    ``last_checkpoint`` naming the newest. After training,
    ``dumped_model.pt``: a state_dict of the EMA parameters (the live ones
    without EMA) and the live BN buffers."""

    def __init__(self, save_dir: str, save_period: int = 1):
        self.save_dir = save_dir
        self.save_period = save_period

    def _save(self, name: str):
        t = self.trainer
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, name)
        torch.save({
            "model": t.model.module.state_dict(),
            "optimizer": t.state.optimizer.state_dict(),
            "ema": t.state.ema_params,
            "step": t.state.step,
            "progress": t.progress.state_dict(),
        }, path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(name)
        logger.info(f"saved checkpoint to {path}")

    def after_epoch(self):
        self._save("latest.pt")
        if self.trainer.progress.epoch % self.save_period == 0:
            self._save(f"epoch_{self.trainer.progress.epoch}.pt")

    def after_train(self):
        t = self.trainer
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, "dumped_model.pt")
        torch.save(t.state.variables(t.model.module, ema=t.ema_enabled), path)
        logger.info(f"dumped {'EMA ' if t.ema_enabled else ''}weights to {path}")
