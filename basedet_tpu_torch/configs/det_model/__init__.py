from .atss_cfg import ATSSConfig
from .centernet_cfg import CenterNetConfig
from .detr_cfg import DETRConfig
from .faster_rcnn_cfg import FasterRCNNConfig
from .fcos_cfg import FCOSConfig
from .freeanchor_cfg import FreeAnchorConfig
from .ota_cfg import OTAConfig
from .retinanet_cfg import RetinaNetConfig
from .yolov3_cfg import YOLOv3Config
from .yolox_cfg import (
    YOLOXConfig,
    YOLOXLConfig,
    YOLOXMConfig,
    YOLOXNanoConfig,
    YOLOXSConfig,
    YOLOXTinyConfig,
    YOLOXXConfig,
)

__all__ = [
    "ATSSConfig",
    "CenterNetConfig",
    "DETRConfig",
    "FasterRCNNConfig",
    "FCOSConfig",
    "FreeAnchorConfig",
    "OTAConfig",
    "RetinaNetConfig",
    "YOLOv3Config",
    "YOLOXConfig",
    "YOLOXLConfig",
    "YOLOXMConfig",
    "YOLOXNanoConfig",
    "YOLOXSConfig",
    "YOLOXTinyConfig",
    "YOLOXXConfig",
]
