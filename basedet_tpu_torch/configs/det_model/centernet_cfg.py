"""CenterNet config (the port's own copy of
``basedet_tpu/configs/det_model/centernet_cfg.py``). ``AUG.TRAIN_VALUE``
names CenterNet's affine crop and colour augmentations; the port's loaders
read them only for a real dataset, which they do not serve yet, so the
synthetic loader trains it without them."""
from __future__ import annotations

from basedet_tpu_torch.configs.detection_cfg import DetectionConfig

_CENTERNET_CONFIG = dict(
    MODEL=dict(
        NAME="CenterNet",
        WEIGHTS=None,
        BATCHSIZE=16,
        BACKBONE=dict(
            NAME="resnet50",
            IMG_MEAN=[103.53, 116.28, 123.675],
            IMG_STD=[57.375, 57.120, 58.395],
            NORM="BN",
            FREEZE_AT=0,
        ),
        HEAD=dict(
            DECONV_CHANNEL=[2048, 256, 128, 64],
            DECONV_KERNEL=[4, 4, 4],
            MODULATE_DEFORM=True,
            IN_CHANNELS=64,
            CLS_PRIOR_PROB=0.1,
            DOWN_SCALE=4,
            MIN_OVERLAP=0.7,
            TENSOR_DIM=128,
        ),
        LOSS=dict(CLS_WEIGHT=1, WH_WEIGHT=0.1, REG_WEIGHT=1),
        OUTPUT_SIZE=(128, 128),
    ),
    AUG=dict(
        TRAIN_VALUE=(
            ("CenterAffine", dict(border=128, output_size=(512, 512))),
            ("RandomHorizontalFlip", dict(prob=0.5)),
            ("RandomBrightness", dict(low=0.6, high=1.4)),
            ("RandomContrast", dict(low=0.6, high=1.4)),
            ("RandomSaturation", dict(low=0.6, high=1.4)),
        ),
    ),
    TEST=dict(CLS_THRESHOLD=0.05),
)


class CenterNetConfig(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge(_CENTERNET_CONFIG)
