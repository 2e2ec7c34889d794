from .coco import COCODataset
from .info import register_dataset, resolve_dataset
from .mosaic_dataset import MosaicDataset

__all__ = ["COCODataset", "MosaicDataset", "register_dataset", "resolve_dataset"]
