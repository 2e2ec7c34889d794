"""YOLOX configs (the port's own copy of ``basedet_tpu/configs/det_model/yolox_cfg.py``):
the size variants nano/tiny/s/m/l/x by depth/width factors.
"""
from __future__ import annotations

from basedet_tpu_torch.configs.detection_cfg import DetectionConfig

TEST_SIZE = 640

_YOLOX_CONFIG = dict(
    MODEL=dict(
        NAME="YOLOX",
        WEIGHTS=None,
        DEPTH_FACTOR=1.0,
        WIDTH_FACTOR=1.0,
        DEPTHWISE=False,
        ACTIVATION="silu",
        BN_EPS=1e-3,
        BN_MOMENTUM=0.97,
        USE_L1=False,
        BACKBONE=dict(
            NAME="csp_darknet",
            OUT_FEATURES=["dark3", "dark4", "dark5"],
            IMG_MEAN=None,
            IMG_STD=None,
            NORM="BN",
            FREEZE_AT=0,
        ),
        BATCHSIZE=8,
    ),
    SOLVER=dict(
        BUILDER_NAME="YOLOXSolver",
        LR_SCHEDULER_NAME="YoloxCosineLR",
        REDUCE_MODE="MEAN",
        BASIC_LR=0.01 / 64,
        WEIGHT_DECAY=5e-4,
        EXTRA_OPT_ARGS=dict(momentum=0.9, nesterov=True),
        WARM_ITERS=None,  # derived from WARM_EPOCH
        WARM_EPOCH=5,
        NUM_IMAGE_PER_EPOCH=120000,
        MAX_EPOCH=300,
        EXTRA_LR_ARGS=dict(NO_AUG_EPOCH=15, MIN_LR_RATIO=0.05),
    ),
    DATA=dict(BUILDER_NAME="YOLOXDataloaderBuilder"),
    TRAINER=dict(EMA=dict(ENABLE=True)),
    HOOKS=dict(BUILDER_NAME="YOLOXHookList"),
    AUG=dict(
        TRAIN_SETTING=dict(
            INPUT_SIZE=(640, 640),
            MULTISCALE_RANGE=(14, 26),
            SYNC_ITER=10,
            MOSAIC_PROB=1.0,
            MOSAIC_SCALE=(0.1, 2),
            ENABLE_MIXUP=True,
            MIXUP_PROB=1.0,
            MIXUP_SCALE=(0.5, 1.5),
            HSV_PROB=1.0,
            FLIP_PROB=0.5,
            DEGREES=10.0,
            TRANSLATE=0.1,
            SHEAR=2.0,
            NO_AUG_EPOCH=15,
        ),
    ),
    TEST=dict(
        CLS_THRESHOLD=0.001,
        IOU_THRESHOLD=0.65,
        IMG_MIN_SIZE=TEST_SIZE,
        IMG_MAX_SIZE=TEST_SIZE,
    ),
)


class YOLOXConfig(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge(_YOLOX_CONFIG)
        self.GLOBAL.LOG_INTERVAL = 10

    def _scale(self, depth: float, width: float):
        self.MODEL.DEPTH_FACTOR = depth
        self.MODEL.WIDTH_FACTOR = width


class YOLOXSConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(0.33, 0.50)


class YOLOXMConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(0.67, 0.75)


class YOLOXLConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(1.0, 1.0)


class YOLOXXConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(1.33, 1.25)


class YOLOXTinyConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(0.33, 0.375)
        self.AUG.TRAIN_SETTING.INPUT_SIZE = (416, 416)


class YOLOXNanoConfig(YOLOXConfig):
    def __init__(self):
        super().__init__()
        self._scale(0.33, 0.25)
        self.MODEL.DEPTHWISE = True
        self.AUG.TRAIN_SETTING.INPUT_SIZE = (416, 416)
