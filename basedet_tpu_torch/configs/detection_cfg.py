"""DetectionConfig (the port's own copy of the tree in
``basedet_tpu/configs/detection_cfg.py``). The JAX package's config also
builds its flax model, loader, solver and trainer; the port builds them with
``basedet_tpu_torch.utils.registry.build_*(cfg, device)`` instead, so the copy
holds the tree only.
"""
from __future__ import annotations

from .base_cfg import BaseConfig
from .extra_cfg import (
    DataConfig,
    GlobalConfig,
    ModelConfig,
    SolverConfig,
    TestConfig,
    TrainerConfig,
)


class DetectionConfig(BaseConfig):
    def __init__(self, cfg=None, **kwargs):
        super().__init__()
        self.MODEL = ModelConfig()
        self.DATA = DataConfig()
        self.SOLVER = SolverConfig()
        self.TRAINER = TrainerConfig()
        self.HOOKS = dict(BUILDER_NAME="SimpleHookList")
        self.TEST = TestConfig()
        self.AUG = dict(
            TRAIN_VALUE=(
                (
                    "ShortestEdgeResize",
                    dict(
                        min_size=(640, 672, 704, 736, 768, 800),
                        max_size=1333,
                        sample_style="choice",
                    ),
                ),
                ("RandomHorizontalFlip", dict(prob=0.5)),
            ),
        )
        self.GLOBAL = GlobalConfig()
        if cfg:
            self.merge(cfg)
        if kwargs:
            self.merge(kwargs)

