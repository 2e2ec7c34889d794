"""Training hooks (counterpart of ``basedet_tpu/engine/hooks.py``): host code
run between steps. Ported: logging, the LR hook, checkpoints, resume and
evaluation. TensorBoard and orbax checkpoints are not ported;
``engine/build.py`` refuses the configs that ask for them.

Under a process group, rank 0 alone writes the checkpoints and runs the
evaluation, over the whole split, as the JAX package's one process does; the
other ranks wait for it at a barrier. Every rank resumes from the same file,
then takes rank 0's state."""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch

from basedet_tpu_torch import parallel
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
        if parallel.is_main_process():
            self._write(name)
        parallel.barrier()

    def _write(self, name: str):
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
        if parallel.is_main_process():
            os.makedirs(self.save_dir, exist_ok=True)
            path = os.path.join(self.save_dir, "dumped_model.pt")
            torch.save(t.state.variables(t.model.module, ema=t.ema_enabled), path)
            logger.info(f"dumped {'EMA ' if t.ema_enabled else ''}weights to {path}")
        parallel.barrier()


@registers.hooks.register()
class ResumeHook(BaseHook):
    """Before training, restore ``save_dir/latest.pt`` as ``CheckpointHook``
    wrote it: the module's parameters and buffers, the optimizer, the EMA
    parameters, the step and the epoch; training goes on at the epoch after
    it. The config's MAX_EPOCH and iterations per epoch stay in force. Every
    rank reads the file once rank 0 has written it, then takes rank 0's
    parameters, buffers and EMA parameters."""

    def __init__(self, save_dir: str, enable: bool = True):
        self.save_dir = save_dir
        self.enable = enable

    def before_train(self):
        if not self.enable:
            return
        parallel.barrier()
        path = os.path.join(self.save_dir, "latest.pt")
        if not os.path.exists(path):
            logger.info(f"no checkpoint at {path}; training from scratch")
            return
        t = self.trainer
        ckpt = torch.load(path, map_location=t.model.device, weights_only=True)
        t.model.module.load_state_dict(ckpt["model"], strict=True)
        t.state.optimizer.load_state_dict(ckpt["optimizer"])
        if t.state.ema_params is not None:
            if ckpt["ema"] is None:
                raise ValueError(f"{path} was trained without EMA; TRAINER.EMA.ENABLE asks for it")
            with torch.no_grad():
                for name, value in ckpt["ema"].items():
                    t.state.ema_params[name].copy_(value)
        parallel.broadcast_module(t.model.module)
        parallel.broadcast_tensors((t.state.ema_params or {}).values())
        t.state.step = ckpt["step"]
        t.progress.epoch = ckpt["progress"]["epoch"]
        t.progress.inner_iter = ckpt["progress"]["inner_iter"]
        t.progress.epoch_done()
        logger.info(f"resumed from {path}: step {t.state.step}, epoch {t.progress.epoch}")


@registers.hooks.register()
class EvalHook(BaseHook):
    """Evaluate on the trainer's test loader every ``eval_interval`` epochs
    (the last excepted) with the live weights, and after training with the
    live weights, then the EMA weights where the trainer keeps them. Results
    land in ``trainer.eval_results["model"]`` and ``["EMA"]`` (rank 0's
    alone under a process group). Without an evaluator (none was asked for)
    it does nothing."""

    def __init__(self, eval_interval: Optional[int] = None):
        self.eval_interval = eval_interval

    def _run_eval(self, ema: bool):
        if self.trainer.evaluator is None:
            return
        if parallel.is_main_process():
            self._evaluate(ema)
        parallel.barrier()

    def _evaluate(self, ema: bool):
        t = self.trainer
        module = t.model.module
        live = None
        if ema:
            live = {n: p.detach().clone() for n, p in module.named_parameters()}
            with torch.no_grad():
                for n, p in module.named_parameters():
                    p.copy_(t.state.ema_params[n])
        t.model.eval()
        try:
            results = t.evaluator.evaluate_model(t.model, t.test_dataloader)
        finally:
            if live is not None:
                with torch.no_grad():
                    for n, p in module.named_parameters():
                        p.copy_(live[n])
            t.model.train()
        tag = "EMA" if ema else "model"
        t.eval_results[tag] = results
        logger.info(f"eval ({tag}, epoch {t.progress.epoch}): {results}")

    def after_epoch(self):
        p = self.trainer.progress
        if self.eval_interval and p.epoch % self.eval_interval == 0 and not p.is_last_epoch():
            self._run_eval(ema=False)

    def after_train(self):
        self._run_eval(ema=False)
        if self.trainer.state.ema_params is not None:
            self._run_eval(ema=True)
