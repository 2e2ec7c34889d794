from .transforms import DataRNG, Transform, TransformCompose, build_transforms
from . import centernet_transform  # noqa: F401  (registers CenterAffine)

__all__ = ["DataRNG", "Transform", "TransformCompose", "build_transforms"]
