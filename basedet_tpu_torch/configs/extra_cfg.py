"""Default sub-config trees (the port's own copy of
``basedet_tpu/configs/extra_cfg.py``): DataConfig, GlobalConfig, ModelConfig,
SolverConfig, TrainerConfig and TestConfig, key for key as in the JAX
package, so that either package's overrides apply to both.
"""
from __future__ import annotations

from basedet_tpu_torch.utils.config_dict import ConfigDict


class DataConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.BUILDER_NAME = "DataloaderBuilder"
        self.TRAIN = dict(
            name="coco_2017_train",
            remove_images_without_annotations=True,
            order=("image", "boxes", "boxes_category", "info"),
        )
        self.TEST = dict(
            name="coco_2017_val",
            remove_images_without_annotations=False,
            order=("image", "info"),
        )
        self.NUM_CLASSES = 80
        self.NUM_WORKERS = 2
        self.ENABLE_INFINITE_SAMPLER = True
        # static-shape knobs: gt padded to MAX_INSTANCES rows; images
        # padded to the smallest (H, W) bucket that fits.
        self.MAX_INSTANCES = 100
        self.SIZE_BUCKETS = None  # None → pad to x32 of max in batch


class GlobalConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.OUTPUT_DIR = "logs"
        self.CKPT_SAVE_DIR = "logs/ckpt"
        self.LOG_INTERVAL = 20
        self.TENSORBOARD = dict(ENABLE=False)


class ModelConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.BATCHSIZE = 2
        self.WEIGHTS = None
        self.BACKBONE = dict(
            NAME="resnet50",
            IMG_MEAN=[103.530, 116.280, 123.675],  # BGR
            IMG_STD=[57.375, 57.12, 58.395],
            NORM="FrozenBN",
            FREEZE_AT=2,
        )


class SolverConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.BUILDER_NAME = "DetSolver"
        self.OPTIMIZER_NAME = "SGD"
        self.LR_SCHEDULER_NAME = "MultiStepLR"
        self.BASIC_LR = 0.01 / 16.0  # per-image LR
        self.WEIGHT_DECAY = 1e-4
        self.EXTRA_OPT_ARGS = dict(momentum=0.9)
        self.REDUCE_MODE = "MEAN"
        self.EPOCHWISE_STEP = False
        self.WARM_ITERS = 500
        self.NUM_IMAGE_PER_EPOCH = 80000
        self.MAX_EPOCH = 18
        self.LR_DECAY_STAGES = [12, 16]
        self.LR_DECAY_RATE = 0.1
        self.EXTRA_LR_ARGS = dict()


class TrainerConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.NAME = "DetTrainer"
        self.RESUME = False
        # AMP = a bf16 compute policy (not ported yet: the port refuses it)
        self.AMP = dict(ENABLE=False, DYNAMIC_SCALE=False, DTYPE="bfloat16")
        self.EMA = dict(
            ENABLE=False,
            ALPHA=5e-4,
            MOMENTUM=None,
            UPDATE_PERIOD=1,
            BURNIN_ITER=2000,
        )
        self.GRAD_CLIP = dict(
            ENABLE=False,
            TYPE="value",  # "value" | "norm"
            ARGS=dict(lower=-1, upper=1),
        )


class TestConfig(ConfigDict):
    def __init__(self):
        super().__init__()
        self.EVALUATOR_NAME = "COCOEvaluator"
        self.MAX_BOXES_PER_IMAGE = 100
        self.IMG_MIN_SIZE = 800
        self.IMG_MAX_SIZE = 1333
        self.VIS_THRESHOLD = 0.3
        self.CLS_THRESHOLD = 0.05
        self.IOU_THRESHOLD = 0.5
        self.EVAL_EPOCH_INTERVAL = None
