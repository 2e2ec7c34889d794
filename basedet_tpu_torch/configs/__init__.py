"""The port's config trees: the JAX package's ``basedet_tpu/configs``, copied
for the models the port runs (YOLOX, Faster R-CNN and CenterNet)."""
from .base_cfg import BaseConfig
from .detection_cfg import DetectionConfig
from .det_model import *  # noqa: F401,F403

__all__ = ["BaseConfig", "DetectionConfig"]
