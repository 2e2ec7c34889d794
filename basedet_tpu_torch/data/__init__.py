from .build import (
    DataloaderBuilder,
    YOLOXDataloaderBuilder,
    build_test_dataloader,
    build_train_dataloader,
)

__all__ = ["DataloaderBuilder", "YOLOXDataloaderBuilder", "build_test_dataloader",
           "build_train_dataloader"]
