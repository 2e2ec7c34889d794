"""Training hooks (counterpart of ``basedet_tpu/engine/hooks.py``): host code
run between steps: logging, the LR hook, checkpoints (blocking pickles of
``torch.save``, or ``AsyncCheckpointHook``, the counterpart of the JAX
package's orbax hook), resume, evaluation, and TensorBoard scalars and
detection images (through ``utils/tb_writer.py``, which writes the event
files itself).

Under a process group, rank 0 alone writes the checkpoints and the event
files and runs the evaluation, over the whole split, as the JAX package's one
process does; the other ranks wait for it at a barrier. Every rank resumes
from the same file, then takes rank 0's state."""
from __future__ import annotations

import concurrent.futures
import datetime
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from basedet_tpu_torch import parallel
from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.utils.registry import registers
from basedet_tpu_torch.utils.tb_writer import SummaryWriter


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
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, name)
        torch.save(checkpoint_payload(self.trainer), path)
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
        ckpt = restore_checkpoint(t, path)
        t.progress.epoch = ckpt["progress"]["epoch"]
        t.progress.inner_iter = ckpt["progress"]["inner_iter"]
        t.progress.epoch_done()
        logger.info(f"resumed from {path}: step {t.state.step}, epoch {t.progress.epoch}")


def checkpoint_payload(t) -> dict:
    """What a training checkpoint holds: the module's state_dict, the
    optimizer, the EMA parameters, the step and the progress."""
    return {
        "model": t.model.module.state_dict(),
        "optimizer": t.state.optimizer.state_dict(),
        "ema": t.state.ema_params,
        "step": t.state.step,
        "progress": t.progress.state_dict(),
    }


def restore_checkpoint(t, path: str) -> dict:
    """Load a training checkpoint into the trainer ``t``: the module's
    parameters and buffers, the optimizer, the EMA parameters and the step;
    then rank 0's parameters, buffers and EMA parameters to every rank.
    Returns the checkpoint."""
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
    return ckpt


@registers.hooks.register()
class AsyncCheckpointHook(BaseHook):
    """Checkpoints that do not hold the loop up while they are written
    (``GLOBAL.CKPT_BACKEND "orbax"``; the JAX package's
    ``OrbaxCheckpointHook``): at every epoch's end ``<save_dir>/<epoch>.pt``
    with what ``CheckpointHook`` writes, the newest ``max_to_keep`` kept;
    under ``TRAINER.RESUME`` the newest restored before training, which goes
    on at the epoch after it; ``after_train`` waits for the writes.

    At an epoch's end every tensor of the checkpoint is copied into pinned
    host memory (kept from one epoch to the next) with ``non_blocking`` on
    the current stream, and an event is recorded after the copies. The next
    optimizer step, which updates the parameters in place, is queued behind
    the copies on the same stream, so it cannot overtake them. A writer
    thread waits on the event, writes ``<epoch>.pt.tmp``, syncs it to disk
    and renames it to ``<epoch>.pt``: only renamed files count, so a run
    stopped mid-write leaves a ``.tmp`` that resume ignores. Rank 0 writes;
    every rank restores the same file, then takes rank 0's state."""

    _NAME = re.compile(r"^(\d+)\.pt$")

    def __init__(self, save_dir: str, max_to_keep: int = 3):
        self.save_dir = os.path.abspath(save_dir)
        self.max_to_keep = max_to_keep
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None  # the writer thread
        self._pending: Optional[concurrent.futures.Future] = None
        self._host = {}  # path in the checkpoint's tree -> its host copy, reused every epoch

    def steps(self):
        """The steps of the complete checkpoints in ``save_dir``, oldest first."""
        names = os.listdir(self.save_dir) if os.path.isdir(self.save_dir) else []
        return sorted(int(m.group(1)) for m in map(self._NAME.match, names) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"{step}.pt")

    def before_train(self):
        t = self.trainer
        if not t.cfg.TRAINER.get("RESUME", False):
            return
        parallel.barrier()
        steps = self.steps()
        if not steps:
            logger.info(f"no checkpoint in {self.save_dir}; training from scratch")
            return
        restore_checkpoint(t, self.path(steps[-1]))
        t.progress.epoch, t.progress.inner_iter = steps[-1] + 1, 1
        logger.info(f"resumed from {self.path(steps[-1])}: step {t.state.step}, epoch {t.progress.epoch}")

    def _copy(self, tree, key=()):
        if isinstance(tree, torch.Tensor):
            host = self._host.get(key)
            if host is None or host.shape != tree.shape or host.dtype != tree.dtype:
                host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=tree.is_cuda)
                self._host[key] = host
            host.copy_(tree.detach(), non_blocking=tree.is_cuda)
            return host
        if isinstance(tree, dict):
            return {k: self._copy(v, key + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._copy(v, key + (i,)) for i, v in enumerate(tree))
        return tree

    def after_epoch(self):
        if not parallel.is_main_process():
            return
        self.wait()  # the host copies of the last epoch are free again
        step = self.trainer.progress.epoch
        payload = self._copy(checkpoint_payload(self.trainer))
        done = None
        if self.trainer.model.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = self._pool.submit(self._write, step, payload, done)

    def _write(self, step: int, payload: dict, done) -> None:
        if done is not None:
            done.synchronize()
        os.makedirs(self.save_dir, exist_ok=True)
        path = self.path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        logger.info(f"saved checkpoint to {path}")

    def wait(self) -> None:
        """Block until the last write has finished; its error, if any, is
        raised here."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def after_train(self):
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
        parallel.barrier()


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


@registers.hooks.register()
class TensorboardHook(BaseHook):
    """Every ``write_interval`` steps, each meter's latest value as a scalar
    at the trainer's 1-based iteration (``GLOBAL.TENSORBOARD.ENABLE``,
    ``--tb``), on rank 0."""

    def __init__(self, log_dir: str, write_interval: int = 20):
        self.log_dir = log_dir
        self.write_interval = write_interval
        self.writer = None

    def before_train(self):
        if parallel.is_main_process():
            self.writer = SummaryWriter(self.log_dir)

    def after_iter(self):
        step = self.trainer.progress.current_iter
        if step % self.write_interval != 0 or self.writer is None:
            return
        for k, m in self.trainer.meters.items():
            self.writer.add_scalar(k, m.latest, step)
        self.writer.flush()

    def after_train(self):
        if self.writer is not None:
            self.writer.close()


@registers.hooks.register()
class TBDetectionImageHook(BaseHook):
    """At every epoch's end, the live model's detections on the first
    ``max_images`` images of the last training batch, drawn by
    ``evaluators/visualize.py`` on the padded canvas and written as images
    (``GLOBAL.TENSORBOARD.LOG_IMAGES``), on rank 0."""

    def __init__(self, log_dir: str, max_images: int = 2, score_threshold: float = 0.3):
        self.log_dir = log_dir
        self.max_images = max_images
        self.score_threshold = score_threshold
        self.writer = None

    def before_train(self):
        if parallel.is_main_process():
            self.writer = SummaryWriter(self.log_dir)

    def after_epoch(self):
        from basedet_tpu_torch.evaluators.visualize import visualize_detection

        t = self.trainer
        batch = getattr(t, "last_batch", None)
        if batch is None or self.writer is None:
            return
        n = min(self.max_images, int(batch["data"].shape[0]))
        small = {k: batch[k][:n] for k in ("data", "im_info")}
        was_training = t.model.module.training
        t.model.eval()
        try:
            with torch.no_grad():
                dets = t.model.inference(small)
        finally:
            if was_training:
                t.model.train()
        boxes, scores, labels = (np.asarray(torch.as_tensor(dets[k]).cpu()) for k in ("boxes", "box_scores",
                                                                                     "box_labels"))
        valid = np.asarray(torch.as_tensor(dets["valid"]).cpu()) if "valid" in dets else scores > 0
        images, infos = np.asarray(small["data"].cpu()), np.asarray(small["im_info"].cpu(), np.float64)
        step = t.progress.current_iter
        for b in range(n):
            img = images[b]
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
            keep = valid[b].astype(bool)
            rows = np.concatenate([boxes[b][keep], scores[b][keep, None], labels[b][keep, None]], axis=1)
            # detections are in original-image coordinates; the canvas is the padded training image
            info = infos[b]
            if info[2] > 0 and info[3] > 0:
                s = [info[1] / info[3], info[0] / info[2]]
                rows[:, :4] *= np.asarray([s[0], s[1], s[0], s[1]])
            rendered = visualize_detection(img, rows, score_threshold=self.score_threshold)
            self.writer.add_image(f"detections/img{b}", rendered[..., ::-1], step, dataformats="HWC")
        self.writer.flush()

    def after_train(self):
        if self.writer is not None:
            self.writer.close()
