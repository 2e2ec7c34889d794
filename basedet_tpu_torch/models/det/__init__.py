from .faster_rcnn import FasterRCNN
from .yolox import YOLOX

__all__ = ["FasterRCNN", "YOLOX"]
