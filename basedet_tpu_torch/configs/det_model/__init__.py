from .faster_rcnn_cfg import FasterRCNNConfig
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
    "FasterRCNNConfig",
    "YOLOXConfig",
    "YOLOXLConfig",
    "YOLOXMConfig",
    "YOLOXNanoConfig",
    "YOLOXSConfig",
    "YOLOXTinyConfig",
    "YOLOXXConfig",
]
