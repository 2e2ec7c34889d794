"""DETR R50 800px 150e, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import DETRConfig


class Cfg(DETRConfig):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/detr_r50_150e"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/detr_r50_150e/ckpt"
