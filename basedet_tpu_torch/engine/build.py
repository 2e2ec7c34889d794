"""Hook lists (counterpart of ``basedet_tpu/engine/build.py``)."""
from __future__ import annotations

from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.engine.hooks import BaseHook, CheckpointHook, LoggerHook, LRSchedulerHook
from basedet_tpu_torch.utils.registry import registers


@registers.hooks.register()
class SimpleHookList:
    """LR → logger → checkpoint. Refuses what it cannot run yet: resume,
    TensorBoard, orbax checkpoints and mid-train evaluation."""

    @classmethod
    def build(cls, cfg):
        refused = {
            "TRAINER.RESUME": cfg.TRAINER.get("RESUME", False),
            "GLOBAL.TENSORBOARD.ENABLE": cfg.GLOBAL.TENSORBOARD.get("ENABLE", False),
            "GLOBAL.CKPT_BACKEND orbax": cfg.GLOBAL.get("CKPT_BACKEND", "pickle") == "orbax",
            "TEST.EVAL_EPOCH_INTERVAL": cfg.TEST.get("EVAL_EPOCH_INTERVAL", None),
        }
        asked = [k for k, v in refused.items() if v]
        if asked:
            raise NotImplementedError(f"{', '.join(asked)}: not ported to basedet_tpu_torch yet")
        return [
            LRSchedulerHook(),
            LoggerHook(log_interval=cfg.GLOBAL.get("LOG_INTERVAL", 20)),
            CheckpointHook(cfg.GLOBAL.get("CKPT_SAVE_DIR", "logs/ckpt")),
        ]


class YoloxNoAugHook(BaseHook):
    """For the last NO_AUG_EPOCH epochs, turn YOLOX's L1 loss on (the dummy
    loader has no mosaic or mixup to turn off). The port's step reads
    ``use_l1`` at every call, so nothing is rebuilt."""

    def before_epoch(self):
        t = self.trainer
        no_aug = t.cfg.AUG.get("TRAIN_SETTING", {}).get("NO_AUG_EPOCH", 0)
        if no_aug and t.progress.epoch > t.progress.max_epoch - no_aug and not t.model.use_l1:
            t.model.use_l1 = True
            logger.info(f"epoch {t.progress.epoch}: no-aug phase, L1 loss on")


@registers.hooks.register()
class YOLOXHookList(SimpleHookList):
    @classmethod
    def build(cls, cfg):
        return super().build(cfg) + [YoloxNoAugHook()]
