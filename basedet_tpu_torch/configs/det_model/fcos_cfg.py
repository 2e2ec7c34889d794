"""FCOS config (the port's own copy of
``basedet_tpu/configs/det_model/fcos_cfg.py``)."""
from __future__ import annotations

from basedet_tpu_torch.configs.detection_cfg import DetectionConfig

_FCOS_CONFIG = dict(
    MODEL=dict(
        NAME="FCOS",
        WEIGHTS=None,
        ANCHOR=dict(NUM_ANCHORS=1, OFFSET=0.5),
        BACKBONE=dict(
            OUT_FEATURES=["res3", "res4", "res5"],
            OUT_FEATURE_CHANNELS=[512, 1024, 2048],
        ),
        FPN=dict(
            OUT_FEATURES=["p3", "p4", "p5", "p6", "p7"],
            NORM=None,
            STRIDES=[8, 16, 32, 64, 128],
            TOP_BLOCK_IN_CHANNELS=2048,
            OUT_CHANNELS=256,
            TOP_BLOCK_IN_FEATURE="res5",
        ),
        LOSSES=dict(
            FOCAL_LOSS_ALPHA=0.25,
            FOCAL_LOSS_GAMMA=2,
            IOU_LOSS_TYPE="giou",
            REG_LOSS_WEIGHT=1.0,
        ),
        BOX_REG=dict(MEAN=[0.0, 0.0, 0.0, 0.0], STD=[1.0, 1.0, 1.0, 1.0]),
        HEAD=dict(
            NUM_CONVS=4,
            CLS_PRIOR_PROB=0.01,
            OBJECT_SIZES_OF_INTEREST=[
                [-1, 64],
                [64, 128],
                [128, 256],
                [256, 512],
                [512, float("inf")],
            ],
            CENTER_SAMPLING_RADIUS=1.5,
            SHARE_PARAM=True,
        ),
    ),
)


class FCOSConfig(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge(_FCOS_CONFIG)
        self.TEST.IOU_THRESHOLD = 0.6
