from .atss import ATSS
from .centernet import CenterNet
from .detr import DETR
from .faster_rcnn import FasterRCNN
from .fcos import FCOS
from .free_anchor import FreeAnchor
from .ota import OTA
from .retinanet import RetinaNet
from .yolov3 import YOLOv3
from .yolox import YOLOX

__all__ = ["ATSS", "CenterNet", "DETR", "FCOS", "FasterRCNN", "FreeAnchor", "OTA", "RetinaNet", "YOLOX", "YOLOv3"]
