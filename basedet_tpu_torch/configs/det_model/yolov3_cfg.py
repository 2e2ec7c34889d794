"""YOLOv3 config (the port's own copy of
``basedet_tpu/configs/det_model/yolov3_cfg.py``)."""
from __future__ import annotations

from basedet_tpu_torch.configs.detection_cfg import DetectionConfig

_YOLOV3_CONFIG = dict(
    MODEL=dict(
        NAME="YOLOv3",
        WEIGHTS=None,
        BACKBONE=dict(
            NAME="darknet53",
            OUT_FEATURES=["dark3", "dark4", "dark5"],
            IMG_MEAN=(0.485, 0.456, 0.406),  # RGB fractions ×255 at runtime
            IMG_STD=(0.229, 0.224, 0.225),
            NORM="BN",
            FREEZE_AT=0,
        ),
        ANCHOR=dict(
            SCALES=[
                [[116, 90], [156, 198], [373, 326]],
                [[30, 61], [62, 45], [42, 119]],
                [[10, 13], [16, 30], [33, 23]],
            ],
        ),
        LOSSES=dict(),
        NMS_TYPE="normal",
        BATCHSIZE=8,
        IGNORE_THRESHOLD=0.7,
    ),
    SOLVER=dict(
        BUILDER_NAME="DefaultSolver",
        REDUCE_MODE="MEAN",
        BASIC_LR=0.001 / 8,
        WEIGHT_DECAY=0.0005,
        WARM_ITERS=2000,
        NUM_IMAGE_PER_EPOCH=100000,
        MAX_EPOCH=320,
        LR_DECAY_STAGES=[256, 300],
        LR_DECAY_RATE=0.1,
    ),
    TEST=dict(CLS_THRESHOLD=0.01, IOU_THRESHOLD=0.5),
)


class YOLOv3Config(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge(_YOLOV3_CONFIG)
