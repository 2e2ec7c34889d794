"""YOLOX-S 640px 300e, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import YOLOXSConfig


class Cfg(YOLOXSConfig):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/yolox_s"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/yolox_s/ckpt"
