from .build import (
    DataloaderBuilder,
    DETRDataloaderBuilder,
    YOLOXDataloaderBuilder,
    build_test_dataloader,
    build_train_dataloader,
    world_size,
)
from .datasets import COCODataset, MosaicDataset, register_dataset, resolve_dataset
from .transforms import DataRNG, TransformCompose, build_transforms

__all__ = ["COCODataset", "DETRDataloaderBuilder", "DataRNG", "DataloaderBuilder", "MosaicDataset",
           "TransformCompose", "YOLOXDataloaderBuilder", "build_test_dataloader", "build_train_dataloader",
           "build_transforms", "register_dataset", "resolve_dataset", "world_size"]
