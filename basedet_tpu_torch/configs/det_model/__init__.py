from .atss_cfg import ATSSConfig
from .centernet_cfg import CenterNetConfig
from .faster_rcnn_cfg import FasterRCNNConfig
from .fcos_cfg import FCOSConfig
from .freeanchor_cfg import FreeAnchorConfig
from .ota_cfg import OTAConfig
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
    "ATSSConfig",
    "CenterNetConfig",
    "FasterRCNNConfig",
    "FCOSConfig",
    "FreeAnchorConfig",
    "OTAConfig",
    "RetinaNetConfig",
    "YOLOXConfig",
    "YOLOXLConfig",
    "YOLOXMConfig",
    "YOLOXNanoConfig",
    "YOLOXSConfig",
    "YOLOXTinyConfig",
    "YOLOXXConfig",
]
