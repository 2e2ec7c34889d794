"""YOLOv3 Darknet-53, the port's config (user config protocol — subclass and override)."""
from basedet_tpu_torch.configs import YOLOv3Config


class Cfg(YOLOv3Config):
    def __init__(self):
        super().__init__()
        self.GLOBAL.OUTPUT_DIR = "logs/yolov3_darknet53"
        self.GLOBAL.CKPT_SAVE_DIR = "logs/yolov3_darknet53/ckpt"
