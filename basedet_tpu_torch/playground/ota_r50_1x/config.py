"""OTA R50-FPN 800px 1x, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import OTAConfig


class Cfg(OTAConfig):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/ota_r50_1x"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/ota_r50_1x/ckpt"
