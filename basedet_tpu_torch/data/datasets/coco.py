"""COCO detection dataset from the instances JSON (counterpart of
``basedet_tpu/data/datasets/coco.py``): category ids remapped to contiguous
labels 1..C (0 is background), crowd and degenerate boxes dropped, and,
where asked, images without annotations. Images decode through
``image_ops.imread_bgr`` (BGR uint8 HWC)."""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from basedet_tpu_torch.data.image_ops import imread_bgr
from basedet_tpu_torch.utils.logger import logger


class COCODataset:
    def __init__(self, images_dir: str, anno_path: str, remove_images_without_annotations: bool = True,
                 use_crowd: bool = False):
        self.images_dir = images_dir
        with open(anno_path) as f:
            coco = json.load(f)

        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.cat_ids = [c["id"] for c in cats]
        self.cat_names = [c["name"] for c in cats]
        self.cat_id_to_label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}

        anns_by_img: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.items: List[dict] = []
        for img in coco["images"]:
            boxes, labels, iscrowd = [], [], []
            for a in anns_by_img.get(img["id"], []):
                if a.get("ignore", False):
                    continue
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                crowd = a.get("iscrowd", 0)
                if crowd and not use_crowd:
                    continue
                boxes.append([x, y, x + w, y + h])
                labels.append(self.cat_id_to_label[a["category_id"]])
                iscrowd.append(crowd)
            if remove_images_without_annotations and not boxes:
                continue
            self.items.append(dict(
                id=img["id"], file_name=img["file_name"], height=img["height"], width=img["width"],
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4), labels=np.asarray(labels, np.int32),
                iscrowd=np.asarray(iscrowd, np.int32),
            ))
        logger.info(f"loaded {len(self.items)} images from {anno_path} ({len(self.cat_ids)} categories)")

    def __len__(self) -> int:
        return len(self.items)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.images_dir, self.items[idx]["file_name"])

    def load_image(self, idx: int) -> np.ndarray:
        """HWC uint8 BGR, the models' channel order."""
        return imread_bgr(self.image_path(idx))

    def __getitem__(self, idx: int) -> dict:
        item = self.items[idx]
        return dict(image=self.load_image(idx), boxes=item["boxes"].copy(), labels=item["labels"].copy(),
                    image_id=item["id"], orig_size=(item["height"], item["width"]))

    def aspect_ratios(self) -> np.ndarray:
        return np.asarray([it["height"] / it["width"] for it in self.items], np.float32)
