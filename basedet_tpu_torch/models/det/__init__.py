from .atss import ATSS
from .centernet import CenterNet
from .faster_rcnn import FasterRCNN
from .fcos import FCOS
from .free_anchor import FreeAnchor
from .ota import OTA
from .retinanet import RetinaNet
from .yolox import YOLOX

__all__ = ["ATSS", "CenterNet", "FCOS", "FasterRCNN", "FreeAnchor", "OTA", "RetinaNet", "YOLOX"]
