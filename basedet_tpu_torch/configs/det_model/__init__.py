from .centernet_cfg import CenterNetConfig
from .faster_rcnn_cfg import FasterRCNNConfig
from .retinanet_cfg import RetinaNetConfig
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
    "CenterNetConfig",
    "FasterRCNNConfig",
    "RetinaNetConfig",
    "YOLOXConfig",
    "YOLOXLConfig",
    "YOLOXMConfig",
    "YOLOXNanoConfig",
    "YOLOXSConfig",
    "YOLOXTinyConfig",
    "YOLOXXConfig",
]
