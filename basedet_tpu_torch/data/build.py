"""Data loaders (counterpart of ``basedet_tpu/data/build.py``). Only the
synthetic ``dummy`` dataset is ported; any other is refused."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.registry import registers


def _refuse(name: str, key: str):
    raise NotImplementedError(
        f"dataset {name!r}: COCO loading is not ported to basedet_tpu_torch yet; "
        f"use {key} dummy"
    )


def _forever(loader) -> Iterator[Dict[str, np.ndarray]]:
    while True:
        yield from loader


def build_train_dataloader(cfg) -> Iterator[Dict[str, np.ndarray]]:
    """``dummy``: an endless stream of synthetic batches of ``BATCHSIZE``
    images at ``AUG.TRAIN_SETTING.INPUT_SIZE``, gt padded to
    ``DATA.MAX_INSTANCES``, as the JAX package's YOLOX builder gives them on
    one device."""
    name = cfg.DATA.TRAIN.get("name", "dummy")
    if name != "dummy":
        _refuse(name, "DATA.TRAIN.name")
    return _forever(DummyLoader(
        batch_size=cfg.MODEL.BATCHSIZE,
        image_size=tuple(cfg.AUG.TRAIN_SETTING.INPUT_SIZE),
        max_instances=cfg.DATA.get("MAX_INSTANCES", 100),
        num_classes=cfg.DATA.NUM_CLASSES,
    ))


@registers.dataloader.register()
class YOLOXDataloaderBuilder:
    @classmethod
    def build(cls, cfg):
        return build_train_dataloader(cfg)


def build_test_dataloader(cfg, dataset_name: Optional[str] = None):
    """``dummy``: 8 synthetic batches of one image, as the JAX package gives
    them."""
    name = dataset_name or cfg.DATA.TEST.get("name", "dummy")
    if name != "dummy":
        _refuse(name, "DATA.TEST.name")
    return DummyLoader(
        batch_size=1,
        image_size=tuple(cfg.DATA.get("DUMMY_IMAGE_SIZE", (512, 512))),
        max_instances=cfg.DATA.get("MAX_INSTANCES", 100),
        num_classes=cfg.DATA.NUM_CLASSES,
        length=8,
    )
