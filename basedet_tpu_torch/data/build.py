"""Data loaders (counterpart of ``basedet_tpu/data/build.py``): the COCO-format
datasets that ``DATA.TRAIN.name`` and ``DATA.TEST.name`` name
(``data/datasets/info.py``), or the synthetic ``dummy`` batches.

The global batch is ``MODEL.BATCHSIZE`` times the world size, which is the
process group's (``basedet_tpu_torch/parallel``) and 1 without one. The
sequence of global batches does not depend on the world size; a train
loader yields the rank's ``MODEL.BATCHSIZE`` rows of each (rank r: rows
r·B … (r+1)·B−1): the synthetic loader makes the global batch and slices it,
the COCO loaders decode the rank's images only. On a CUDA ``device`` the
batches leave the loader page-locked (a pinned ``CanvasRing``) and cross to
the card without blocking the host.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from basedet_tpu_torch.data.collators.pack import CanvasRing
from basedet_tpu_torch.parallel import shard_batch, world_size
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.registry import registers


def _ring(device) -> CanvasRing:
    return CanvasRing(pin=torch.device(device).type == "cuda")


def _dummy_stream(cfg, image_size) -> Iterator[Dict[str, np.ndarray]]:
    """The rank's rows of synthetic global batches, without end; an epoch
    that yields none raises."""
    loader = DummyLoader(
        batch_size=cfg.MODEL.BATCHSIZE * world_size(),
        image_size=tuple(image_size),
        max_instances=cfg.DATA.get("MAX_INSTANCES", 100),
        num_classes=cfg.DATA.NUM_CLASSES,
    )
    while True:
        produced = False
        for batch in loader:
            produced = True
            yield shard_batch(batch)
        if not produced:
            raise RuntimeError("dataloader epoch produced no batches")


@registers.dataloader.register()
class YOLOXDataloaderBuilder:
    """Mosaic and MixUp batches at ``AUG.TRAIN_SETTING.INPUT_SIZE``
    (``coco_loader.build_yolox_train_loader``); ``dummy``: synthetic batches
    at that size, as the JAX package gives them on one device."""

    @classmethod
    def build(cls, cfg, device="cpu"):
        if cfg.DATA.TRAIN.get("name", "dummy") == "dummy":
            return _dummy_stream(cfg, cfg.AUG.TRAIN_SETTING.INPUT_SIZE)
        from basedet_tpu_torch.data.coco_loader import build_yolox_train_loader

        return build_yolox_train_loader(cfg, cfg.MODEL.BATCHSIZE * world_size(), _ring(device))


@registers.dataloader.register()
class DataloaderBuilder:
    """``AUG.TRAIN_VALUE`` transforms, aspect-ratio grouped batches and the
    pad collator (``coco_loader.build_coco_train_loader``); ``dummy``:
    synthetic batches at ``DATA.DUMMY_IMAGE_SIZE`` (512x512 unless set)."""

    @classmethod
    def build(cls, cfg, device="cpu"):
        if cfg.DATA.TRAIN.get("name", "dummy") == "dummy":
            return _dummy_stream(cfg, cfg.DATA.get("DUMMY_IMAGE_SIZE", (512, 512)))
        from basedet_tpu_torch.data.coco_loader import build_coco_train_loader

        return build_coco_train_loader(cfg, cfg.MODEL.BATCHSIZE * world_size(), _ring(device))


@registers.dataloader.register()
class DETRDataloaderBuilder:
    """``DataloaderBuilder``'s pipeline with DETR's valid-pixel ``mask`` in
    each batch (pinned and copied without blocking, like the image);
    ``dummy``: ``DataloaderBuilder``'s synthetic batches, which carry no mask
    (the model makes it from ``im_info``)."""

    @classmethod
    def build(cls, cfg, device="cpu"):
        if cfg.DATA.TRAIN.get("name", "dummy") == "dummy":
            return DataloaderBuilder.build(cfg, device)
        from basedet_tpu_torch.data.coco_loader import build_coco_train_loader

        return build_coco_train_loader(cfg, cfg.MODEL.BATCHSIZE * world_size(), _ring(device), with_mask=True)


def build_train_dataloader(cfg, device="cpu"):
    return YOLOXDataloaderBuilder.build(cfg, device)


def build_test_dataloader(cfg, dataset_name: Optional[str] = None, device="cpu"):
    """The eval loader of ``DATA.TEST.name`` (or ``dataset_name``): each
    image through ``ShortestEdgeResize(TEST.IMG_MIN_SIZE, IMG_MAX_SIZE)``,
    batches of one, padded to the test buckets. ``dummy``: 8 synthetic
    batches of one image, as the JAX package gives them."""
    name = dataset_name or cfg.DATA.TEST.get("name", "dummy")
    if name == "dummy":
        return DummyLoader(
            batch_size=1,
            image_size=tuple(cfg.DATA.get("DUMMY_IMAGE_SIZE", (512, 512))),
            max_instances=cfg.DATA.get("MAX_INSTANCES", 100),
            num_classes=cfg.DATA.NUM_CLASSES,
            length=8,
        )
    from basedet_tpu_torch.data.coco_loader import build_coco_test_loader

    return build_coco_test_loader(cfg, name, ring=_ring(device))
