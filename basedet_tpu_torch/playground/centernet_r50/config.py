"""CenterNet R50 DCNv2 512px, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import CenterNetConfig


class Cfg(CenterNetConfig):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/centernet_r50"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/centernet_r50/ckpt"
