"""Detection transforms on numpy record dicts (counterpart of
``basedet_tpu/data/transforms/transforms.py``).

Records are dicts: {image: HWC uint8/float BGR, boxes: (N, 4) xyxy,
labels: (N,), ...}; each transform is (record, rng) → record and
``TransformCompose`` chains them. Names are registered bare and with the
``MGE_`` prefix, as in the JAX package.

Where the JAX package draws from the global ``random`` and ``np.random``,
the port draws from the ``DataRNG`` it is handed, in the same order, call
for call: a ``DataRNG(s)`` gives the draws of the JAX package after
``random.seed(s)`` and ``np.random.seed(s)``.
"""
from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np

from basedet_tpu_torch.data.image_ops import resize_bilinear
from basedet_tpu_torch.utils.registry import registers


class DataRNG:
    """The random streams of the host data pipeline: ``py`` for what the JAX
    package draws from ``random``, ``np`` for what it draws from
    ``np.random``."""

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.py = random.Random(seed)
        self.np = np.random.RandomState(seed % 2 ** 32)


def _register(cls):
    registers.transforms.register(cls)
    registers.transforms.register(cls, name=f"MGE_{cls.__name__}")
    return cls


class Transform:
    def __call__(self, record: dict, rng: DataRNG) -> dict:
        raise NotImplementedError


def _keep_rows(record: dict, keep: np.ndarray) -> None:
    for key in ("labels", "iscrowd"):
        if key in record and len(record[key]) == len(keep):
            record[key] = record[key][keep]


@_register
class ShortestEdgeResize(Transform):
    """Resize so the shortest edge equals one of min_size (choice/range) with
    the longest edge capped at max_size."""

    def __init__(self, min_size, max_size: int, sample_style: str = "choice"):
        self.min_size = (min_size,) if isinstance(min_size, (int, float)) else tuple(min_size)
        self.max_size = max_size
        self.sample_style = sample_style

    def pick_size(self, rng: DataRNG) -> float:
        if self.sample_style == "choice":
            return rng.py.choice(self.min_size)
        return rng.py.uniform(self.min_size[0], self.min_size[-1])

    def __call__(self, record, rng):
        img = record["image"]
        h, w = img.shape[:2]
        size = self.pick_size(rng)
        scale = min(size / min(h, w), self.max_size / max(h, w))
        nh, nw = int(round(h * scale)), int(round(w * scale))
        record["image"] = resize_bilinear(img, (nw, nh))
        if "boxes" in record and len(record["boxes"]):
            record["boxes"] = record["boxes"] * np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
        record["scale"] = scale
        return record


@_register
class RandomHorizontalFlip(Transform):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, record, rng):
        if rng.py.random() >= self.prob:
            return record
        img = record["image"]
        w = img.shape[1]
        record["image"] = np.ascontiguousarray(img[:, ::-1])
        if "boxes" in record and len(record["boxes"]):
            b = record["boxes"].copy()
            b[:, 0], b[:, 2] = w - record["boxes"][:, 2], w - record["boxes"][:, 0]
            record["boxes"] = b
        return record


class _Jitter(Transform):
    def __init__(self, low: float = 0.9, high: float = 1.1, prob: float = 0.5):
        self.low, self.high, self.prob = low, high, prob


@_register
class RandomBrightness(_Jitter):
    def __call__(self, record, rng):
        if rng.py.random() < self.prob:
            record["image"] = np.clip(
                record["image"].astype(np.float32) * rng.py.uniform(self.low, self.high), 0, 255)
        return record


@_register
class RandomContrast(_Jitter):
    def __call__(self, record, rng):
        if rng.py.random() < self.prob:
            img = record["image"].astype(np.float32)
            mean = img.mean()
            record["image"] = np.clip((img - mean) * rng.py.uniform(self.low, self.high) + mean, 0, 255)
        return record


@_register
class RandomSaturation(_Jitter):
    def __call__(self, record, rng):
        if rng.py.random() < self.prob:
            img = record["image"].astype(np.float32)
            gray = img.mean(axis=2, keepdims=True)
            record["image"] = np.clip((img - gray) * rng.py.uniform(self.low, self.high) + gray, 0, 255)
        return record


@_register
class PadToTargetSize(Transform):
    """Bottom/right pad to a fixed (h, w)."""

    def __init__(self, target_size: Tuple[int, int], pad_value: float = 0.0):
        self.target_size = tuple(target_size)
        self.pad_value = pad_value

    def __call__(self, record, rng):
        img = record["image"]
        h, w = img.shape[:2]
        th, tw = self.target_size
        out = np.full((th, tw, img.shape[2]), self.pad_value, img.dtype)
        out[:h, :w] = img
        record["image"] = out
        return record


@_register
class MinIoURandomCrop(Transform):
    """SSD-style crop keeping boxes with sufficient IoU."""

    def __init__(self, min_ious: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size: float = 0.3,
                 max_tries: int = 50):
        self.sample_modes = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.max_tries = max_tries

    def __call__(self, record, rng):
        boxes = record.get("boxes")
        if boxes is None or not len(boxes):
            return record
        img = record["image"]
        h, w = img.shape[:2]
        while True:
            mode = rng.py.choice(self.sample_modes)
            if mode == 1:
                return record
            for _ in range(self.max_tries):
                nw = rng.py.uniform(self.min_crop_size * w, w)
                nh = rng.py.uniform(self.min_crop_size * h, h)
                if nh / nw < 0.5 or nh / nw > 2:
                    continue
                left = rng.py.uniform(0, w - nw)
                top = rng.py.uniform(0, h - nh)
                patch = np.asarray([left, top, left + nw, top + nh], np.float32)
                lt = np.maximum(boxes[:, :2], patch[:2])
                rb = np.minimum(boxes[:, 2:4], patch[2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                iou = inter / np.maximum(area_b + nw * nh - inter, 1e-12)
                if iou.min() < mode:
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:4]) / 2
                keep = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                        & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3]))
                if not keep.any():
                    continue
                x1, y1, x2, y2 = patch.astype(int)
                record["image"] = img[y1:y2, x1:x2]
                nb = boxes[keep].copy()
                nb[:, 0::2] = np.clip(nb[:, 0::2] - x1, 0, x2 - x1)
                nb[:, 1::2] = np.clip(nb[:, 1::2] - y1, 0, y2 - y1)
                record["boxes"] = nb
                _keep_rows(record, keep)
                return record


@_register
class Expand(Transform):
    """Random canvas expansion."""

    def __init__(self, mean: Sequence[float] = (0, 0, 0), ratio_range=(1, 4), prob: float = 0.5):
        self.mean = mean
        self.ratio_range = ratio_range
        self.prob = prob

    def __call__(self, record, rng):
        if rng.py.random() >= self.prob:
            return record
        img = record["image"]
        h, w, c = img.shape
        ratio = rng.py.uniform(*self.ratio_range)
        nh, nw = int(h * ratio), int(w * ratio)
        top = rng.py.randint(0, nh - h)
        left = rng.py.randint(0, nw - w)
        out = np.empty((nh, nw, c), img.dtype)
        out[...] = np.asarray(self.mean, img.dtype)
        out[top:top + h, left:left + w] = img
        record["image"] = out
        if "boxes" in record and len(record["boxes"]):
            record["boxes"] = record["boxes"] + np.asarray([left, top, left, top], np.float32)
        return record


@_register
class RandomSelect(Transform):
    """Pick one of two transform branches."""

    def __init__(self, transforms1, transforms2, prob: float = 0.5):
        self.t1 = TransformCompose(transforms1)
        self.t2 = TransformCompose(transforms2)
        self.prob = prob

    def __call__(self, record, rng):
        return self.t1(record, rng) if rng.py.random() < self.prob else self.t2(record, rng)


@_register
class RandomSizeCrop(Transform):
    """Random crop with size in [min_size, max_size]."""

    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, record, rng):
        img = record["image"]
        h, w = img.shape[:2]
        cw = rng.py.randint(min(self.min_size, w), min(self.max_size, w))
        ch = rng.py.randint(min(self.min_size, h), min(self.max_size, h))
        left = rng.py.randint(0, w - cw)
        top = rng.py.randint(0, h - ch)
        record["image"] = img[top:top + ch, left:left + cw]
        if "boxes" in record and len(record["boxes"]):
            b = record["boxes"] - np.asarray([left, top, left, top], np.float32)
            b[:, 0::2] = np.clip(b[:, 0::2], 0, cw)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, ch)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            record["boxes"] = b[keep]
            _keep_rows(record, keep)
        return record


class TransformCompose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, record, rng):
        for t in self.transforms:
            record = t(record, rng)
        return record


def build_transforms(spec) -> TransformCompose:
    """Build from config tuples ((name, kwargs), ...), the ``AUG.TRAIN_VALUE``
    protocol."""
    return TransformCompose([registers.transforms.get(name)(**dict(kwargs)) for name, kwargs in spec])
