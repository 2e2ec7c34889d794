from .build import YOLOXDataloaderBuilder, build_test_dataloader, build_train_dataloader

__all__ = ["YOLOXDataloaderBuilder", "build_test_dataloader", "build_train_dataloader"]
