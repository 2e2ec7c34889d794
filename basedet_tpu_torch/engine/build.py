"""Hook lists (counterpart of ``basedet_tpu/engine/build.py``)."""
from __future__ import annotations

import os

from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.engine.hooks import (AsyncCheckpointHook, BaseHook, CheckpointHook, EvalHook, LoggerHook,
                                            LRSchedulerHook, ResumeHook, TBDetectionImageHook, TensorboardHook)
from basedet_tpu_torch.utils.registry import registers


@registers.hooks.register()
class SimpleHookList:
    """Resume → LR → logger (+ TensorBoard) → checkpoint → eval, as the JAX
    package orders them. ``GLOBAL.CKPT_BACKEND "orbax"`` takes
    ``AsyncCheckpointHook``, which resumes by itself, in place of
    ``ResumeHook`` and ``CheckpointHook``; ``GLOBAL.TENSORBOARD.ENABLE``
    adds the scalars and ``LOG_IMAGES`` the detection images, both under
    ``GLOBAL.OUTPUT_DIR/tb``."""

    @classmethod
    def build(cls, cfg):
        ckpt_dir = cfg.GLOBAL.get("CKPT_SAVE_DIR", "logs/ckpt")
        orbax = cfg.GLOBAL.get("CKPT_BACKEND", "pickle") == "orbax"
        hooks = [] if orbax else [ResumeHook(ckpt_dir, enable=cfg.TRAINER.get("RESUME", False))]
        hooks += [LRSchedulerHook(), LoggerHook(log_interval=cfg.GLOBAL.get("LOG_INTERVAL", 20))]
        if cfg.GLOBAL.TENSORBOARD.get("ENABLE", False):
            tb_dir = os.path.join(cfg.GLOBAL.OUTPUT_DIR, "tb")
            hooks.append(TensorboardHook(tb_dir))
            if cfg.GLOBAL.TENSORBOARD.get("LOG_IMAGES", False):
                hooks.append(TBDetectionImageHook(tb_dir))
        hooks.append(AsyncCheckpointHook(ckpt_dir) if orbax else CheckpointHook(ckpt_dir))
        hooks.append(EvalHook(cfg.TEST.get("EVAL_EPOCH_INTERVAL", None)))
        return hooks


class YoloxNoAugHook(BaseHook):
    """For the last NO_AUG_EPOCH epochs: turn YOLOX's L1 loss on, turn the
    loader's mosaic and mixup off and restart its workers, which were forked
    with the flags on (the JAX package's ``request_pool_restart``). The
    port's step reads ``use_l1`` at every call, so nothing is rebuilt."""

    def before_epoch(self):
        t = self.trainer
        no_aug = t.cfg.AUG.get("TRAIN_SETTING", {}).get("NO_AUG_EPOCH", 0)
        if no_aug and t.progress.epoch > t.progress.max_epoch - no_aug and not t.model.use_l1:
            t.model.use_l1 = True
            mosaic = getattr(t.dataloader, "mosaic_dataset", None)
            if mosaic is not None:
                mosaic.enable_mosaic = False
                mosaic.enable_mixup = False
                t.dataloader.close()  # the next batch forks workers that see the flags
            logger.info(f"epoch {t.progress.epoch}: no-aug phase, L1 loss on"
                        f"{', mosaic and mixup off' if mosaic is not None else ''}")


@registers.hooks.register()
class YOLOXHookList(SimpleHookList):
    @classmethod
    def build(cls, cfg):
        return super().build(cfg) + [YoloxNoAugHook()]
