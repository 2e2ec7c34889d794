from .centernet import CenterNet
from .faster_rcnn import FasterRCNN
from .retinanet import RetinaNet
from .yolox import YOLOX

__all__ = ["CenterNet", "FasterRCNN", "RetinaNet", "YOLOX"]
