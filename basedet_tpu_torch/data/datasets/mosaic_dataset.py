"""Mosaic and MixUp around a dataset (counterpart of
``basedet_tpu/data/datasets/mosaic_dataset.py``): a 4-image mosaic on a 2x
canvas (fill 114), the random affine, MixUp, then YOLOX's ``TrainTransform``,
at the fixed ``input_dim``.

Its draws come from ``self.rng`` (a ``DataRNG``), which the loader seeds
per worker and pass; in the JAX package's order, call for call. Images stay
uint8 (the JAX package casts them to float32 with the same values; the
model casts on the card).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from basedet_tpu_torch.data.image_ops import resize_bilinear
from basedet_tpu_torch.data.transforms.transforms import DataRNG
from basedet_tpu_torch.data.transforms.yolox_transform import TrainTransform, random_affine


def get_mosaic_coordinate(i, xc, yc, w, h, input_h, input_w):
    """(canvas rect, source rect) of mosaic quadrant i."""
    if i == 0:  # top-left
        l = (max(xc - w, 0), max(yc - h, 0), xc, yc)
        s = (w - (l[2] - l[0]), h - (l[3] - l[1]), w, h)
    elif i == 1:  # top-right
        l = (xc, max(yc - h, 0), min(xc + w, input_w * 2), yc)
        s = (0, h - (l[3] - l[1]), min(w, l[2] - l[0]), h)
    elif i == 2:  # bottom-left
        l = (max(xc - w, 0), yc, xc, min(input_h * 2, yc + h))
        s = (w - (l[2] - l[0]), 0, w, min(l[3] - l[1], h))
    else:  # bottom-right
        l = (xc, yc, min(xc + w, input_w * 2), min(input_h * 2, yc + h))
        s = (0, 0, min(w, l[2] - l[0]), min(l[3] - l[1], h))
    return l, s


def adjust_box_anns(bbox, scale, padw, padh, w_max, h_max):
    bbox = bbox.copy()
    bbox[:, 0::2] = np.clip(bbox[:, 0::2] * scale + padw, 0, w_max)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2] * scale + padh, 0, h_max)
    return bbox


class MosaicDataset:
    def __init__(self, dataset, img_size: Tuple[int, int] = (640, 640), mosaic: bool = True,
                 preproc: Optional[TrainTransform] = None, degrees: float = 10.0, translate: float = 0.1,
                 mosaic_scale=(0.1, 2.0), mixup_scale=(0.5, 1.5), shear: float = 2.0, enable_mixup: bool = True,
                 mosaic_prob: float = 1.0, mixup_prob: float = 1.0, rng: Optional[DataRNG] = None):
        self._dataset = dataset
        self.input_dim = tuple(img_size[:2])  # (h, w)
        self.preproc = preproc or TrainTransform()
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.mixup_scale = mixup_scale
        self.shear = shear
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.rng = rng or DataRNG(0)

    def __len__(self):
        return len(self._dataset)

    def _load_resized(self, idx):
        """A record resized to fit input_dim, keeping its aspect."""
        rec = self._dataset[idx]
        img = rec["image"]
        h, w = img.shape[:2]
        ih, iw = self.input_dim
        scale = min(ih / h, iw / w)
        img = resize_bilinear(img, (int(w * scale), int(h * scale)))
        return img, rec["boxes"] * scale, rec["labels"], rec

    def _record(self, img, boxes, labels, image_id):
        img, boxes, labels = self.preproc(img, boxes, labels, self.rng)
        return dict(image=img, boxes=boxes.astype(np.float32), labels=labels.astype(np.int32),
                    image_id=image_id, orig_size=self.input_dim)

    def __getitem__(self, idx) -> dict:
        ih, iw = self.input_dim
        rng = self.rng.py
        if not (self.enable_mosaic and rng.random() < self.mosaic_prob):
            img, boxes, labels, rec = self._load_resized(idx)
            out = np.full((ih, iw, 3), 114, np.uint8)  # letterbox
            out[: img.shape[0], : img.shape[1]] = img
            return self._record(out, boxes, labels, rec.get("image_id", idx))

        yc = int(rng.uniform(0.5 * ih, 1.5 * ih))
        xc = int(rng.uniform(0.5 * iw, 1.5 * iw))
        indices = [idx] + [rng.randint(0, len(self._dataset) - 1) for _ in range(3)]
        canvas = np.full((ih * 2, iw * 2, 3), 114, np.uint8)
        all_boxes, all_labels, base_rec = [], [], None
        for i, index in enumerate(indices):
            img, boxes, labels, rec = self._load_resized(index)
            base_rec = base_rec or rec
            h, w = img.shape[:2]
            (lx1, ly1, lx2, ly2), (sx1, sy1, sx2, sy2) = get_mosaic_coordinate(i, xc, yc, w, h, ih, iw)
            canvas[ly1:ly2, lx1:lx2] = img[sy1:sy2, sx1:sx2]
            padw, padh = lx1 - sx1, ly1 - sy1
            if len(boxes):
                b = boxes.copy()
                b[:, 0::2] = np.clip(b[:, 0::2] + padw, 0, 2 * iw)
                b[:, 1::2] = np.clip(b[:, 1::2] + padh, 0, 2 * ih)
                all_boxes.append(b)
                all_labels.append(labels)

        boxes = np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(all_labels, 0) if all_labels else np.zeros((0,), np.int32)
        img, boxes = random_affine(canvas, boxes, self.rng, target_size=(iw, ih), degrees=self.degrees,
                                   translate=self.translate, scales=self.scale, shear=self.shear)
        if self.enable_mixup and len(boxes) and rng.random() < self.mixup_prob:
            img, boxes, labels = self.mixup(img, boxes, labels)
        return self._record(img, boxes, labels, base_rec.get("image_id", idx))

    def mixup(self, origin_img, origin_boxes, origin_labels):
        """Copy-paste MixUp with a random other image, jittered in scale and
        flipped at random."""
        ih, iw = self.input_dim
        rng = self.rng.py
        jit = rng.uniform(*self.mixup_scale)
        index = rng.randint(0, len(self._dataset) - 1)
        img, boxes, labels, _ = self._load_resized(index)

        cp = np.full((ih, iw, 3), 114, np.uint8)
        cp[: img.shape[0], : img.shape[1]] = img
        cp = resize_bilinear(cp, (int(iw * jit), int(ih * jit)))
        do_flip = rng.random() > 0.5
        if do_flip:
            cp = cp[:, ::-1]

        oh, ow = cp.shape[:2]
        th, tw = origin_img.shape[:2]
        padded = np.zeros((max(oh, th), max(ow, tw), 3), np.uint8)
        padded[:oh, :ow] = cp
        yoff = rng.randint(0, padded.shape[0] - th) if padded.shape[0] > th else 0
        xoff = rng.randint(0, padded.shape[1] - tw) if padded.shape[1] > tw else 0
        patch = padded[yoff: yoff + th, xoff: xoff + tw]

        b = adjust_box_anns(boxes, jit, 0, 0, ow, oh)
        if do_flip:
            b[:, 0::2] = ow - b[:, 0::2][:, ::-1]
        b[:, 0::2] = np.clip(b[:, 0::2] - xoff, 0, tw)
        b[:, 1::2] = np.clip(b[:, 1::2] - yoff, 0, th)

        out_img = (0.5 * origin_img.astype(np.float32) + 0.5 * patch.astype(np.float32)).astype(np.uint8)
        return (out_img, np.concatenate([origin_boxes, b], axis=0),
                np.concatenate([origin_labels, labels], axis=0))
