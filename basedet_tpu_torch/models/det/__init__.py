from .centernet import CenterNet
from .faster_rcnn import FasterRCNN
from .yolox import YOLOX

__all__ = ["CenterNet", "FasterRCNN", "YOLOX"]
