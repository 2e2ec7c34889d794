"""DETR config (the port's own copy of
``basedet_tpu/configs/det_model/detr_cfg.py``)."""
from __future__ import annotations

from basedet_tpu_torch.configs.detection_cfg import DetectionConfig

_DETR_CONFIG = dict(
    MODEL=dict(
        NAME="DETR",
        WEIGHTS=None,
        POS_EMBED="sine",
        NUM_QUERIES=100,
        TRANSFORMER=dict(
            DIM=256,
            NUM_HEADS=8,
            NUM_ENCODERS=6,
            NUM_DECODERS=6,
            DIM_FFN=2048,
            DROPOUT=0.1,
            PRE_NORM=False,
        ),
        MATCHER=dict(
            SET_WEIGHT_CLASS=1,
            SET_WEIGHT_BBOX=5,
            SET_WEIGHT_GIOU=2,
        ),
        BACKBONE=dict(FREEZE_AT=2),
    ),
    LOSSES=dict(
        AUX_LOSS=True,
        CE_LOSS_COEF=1,
        BBOX_LOSS_COEF=5,
        GIOU_LOSS_COEF=2,
        EOS_COEF=0.1,
    ),
    DATA=dict(BUILDER_NAME="DETRDataloaderBuilder"),
    SOLVER=dict(
        BUILDER_NAME="DetrSolver",
        OPTIMIZER_NAME="AdamW",
        BASIC_LR=1e-4 / 16,
        BACKBONE_LR_RATIO=0.1,
        WEIGHT_DECAY=1e-4,
        WARM_ITERS=0,
        NUM_IMAGE_PER_EPOCH=120000,
        MAX_EPOCH=150,
        LR_DECAY_STAGES=[100],
        LR_DECAY_RATE=0.1,
    ),
    TRAINER=dict(
        GRAD_CLIP=dict(ENABLE=True, TYPE="norm", ARGS=dict(max_norm=0.1)),
    ),
    TEST=dict(CLS_THRESHOLD=0.0),
)


class DETRConfig(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge(_DETR_CONFIG)
