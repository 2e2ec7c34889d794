"""YOLOX-M 640px 300e, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import YOLOXMConfig


class Cfg(YOLOXMConfig):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/yolox_m"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/yolox_m/ckpt"
