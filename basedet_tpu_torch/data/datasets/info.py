"""Dataset name → (images, annotations) registry (counterpart of
``basedet_tpu/data/datasets/info.py``). Relative paths resolve under
``$BASEDET_DATA_DIR`` (``datasets`` unless set), as in the JAX package."""
from __future__ import annotations

import os

from basedet_tpu_torch.utils.registry import registers


def data_root() -> str:
    return os.environ.get("BASEDET_DATA_DIR", "datasets")


_COCO_INFO = {
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
    "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
    "objects365_train": ("objects365/train", "objects365/annotations/objects365_train.json"),
    "objects365_val": ("objects365/val", "objects365/annotations/objects365_val.json"),
}

for _name, _paths in _COCO_INFO.items():
    registers.datasets_info.register(_paths, name=_name)


def resolve_dataset(name: str):
    """(images_dir, anno_path) of a registered name, under the data root."""
    imgs, anno = registers.datasets_info.get(name)
    root = data_root()
    return os.path.join(root, imgs), os.path.join(root, anno)


def register_dataset(name: str, images_dir: str, anno_path: str) -> None:
    """Register a dataset by explicit paths (absolute paths bypass the data
    root); registering a name again replaces it."""
    registers.datasets_info.register((images_dir, anno_path), name=name, overwrite=True)
