"""YOLOX's augmentations (counterpart of
``basedet_tpu/data/transforms/yolox_transform.py``): HSV jitter, the random
affine and the final per-sample transform, in numpy and CPU torch. Draws
come from the ``DataRNG`` handed in, in the JAX package's order: ``rng.np``
where it draws from ``np.random``, ``rng.py`` where from ``random``."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from basedet_tpu_torch.data.image_ops import bgr_to_hsv_u8, get_rotation_matrix_2d, hsv_to_bgr_u8, warp_affine
from basedet_tpu_torch.data.transforms.transforms import DataRNG


def augment_hsv(img: np.ndarray, rng: DataRNG, hgain=5, sgain=30, vgain=30) -> np.ndarray:
    """Random HSV jitter in place on uint8 BGR. ``gains.astype(img.dtype)``
    casts negative gains to uint8 as the JAX package does; the uint8 sums
    then wrap as there."""
    gains = rng.np.uniform(-1, 1, 3) * [hgain, sgain, vgain]
    gains *= rng.np.randint(0, 2, 3)
    img_hsv = bgr_to_hsv_u8(img)
    gains = gains.astype(img.dtype)
    img_hsv[..., 0] = (img_hsv[..., 0] + gains[0]) % 180
    img_hsv[..., 1] = np.clip(img_hsv[..., 1] + gains[1], 0, 255)
    img_hsv[..., 2] = np.clip(img_hsv[..., 2] + gains[2], 0, 255)
    img[...] = hsv_to_bgr_u8(img_hsv)
    return img


def _aug_param(rng: DataRNG, value, center=0.0) -> float:
    if isinstance(value, (int, float)):
        return rng.py.uniform(center - value, center + value)
    return rng.py.uniform(value[0], value[1])


def get_affine_matrix(rng: DataRNG, target_size: Tuple[int, int], degrees=10.0, translate=0.1, scales=0.1,
                      shear=10.0):
    """Rotation, scale, shear and translation as one (2, 3) matrix."""
    tw, th = target_size
    angle = _aug_param(rng, degrees)
    scale = _aug_param(rng, scales, center=1.0)
    R = get_rotation_matrix_2d((0, 0), angle, scale)
    M = np.ones((2, 3))
    shear_x = math.tan(_aug_param(rng, shear) * math.pi / 180)
    shear_y = math.tan(_aug_param(rng, shear) * math.pi / 180)
    M[0] = R[0] + shear_y * R[1]
    M[1] = R[1] + shear_x * R[0]
    M[0, 2] = _aug_param(rng, translate) * tw
    M[1, 2] = _aug_param(rng, translate) * th
    return M, scale


def apply_affine_to_bboxes(boxes: np.ndarray, target_size, M) -> np.ndarray:
    """Warp xyxy boxes by their four corners, then clip to target_size."""
    n = len(boxes)
    if n == 0:
        return boxes
    tw, th = target_size
    corners = np.ones((4 * n, 3))
    corners[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(4 * n, 2)
    corners = (corners @ M.T).reshape(n, 8)
    xs, ys = corners[:, 0::2], corners[:, 1::2]
    out = boxes.copy()
    out[:, 0] = xs.min(1).clip(0, tw)
    out[:, 1] = ys.min(1).clip(0, th)
    out[:, 2] = xs.max(1).clip(0, tw)
    out[:, 3] = ys.max(1).clip(0, th)
    return out


def random_affine(img: np.ndarray, boxes: np.ndarray, rng: DataRNG, target_size=(640, 640), degrees=10.0,
                  translate=0.1, scales=0.1, shear=10.0):
    M, _ = get_affine_matrix(rng, target_size, degrees, translate, scales, shear)
    img = warp_affine(img, M, target_size, border_value=114)
    return img, apply_affine_to_bboxes(boxes, target_size, M)


class TrainTransform:
    """The final per-sample step: HSV jitter, random flip, and dropping boxes
    under a pixel wide or high."""

    def __init__(self, flip_prob=0.5, hsv_prob=1.0):
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def __call__(self, img: np.ndarray, boxes: np.ndarray, labels: np.ndarray, rng: DataRNG):
        if rng.py.random() < self.hsv_prob:
            img = np.ascontiguousarray(img)
            augment_hsv(img, rng)
        if rng.py.random() < self.flip_prob:
            w = img.shape[1]
            img = np.ascontiguousarray(img[:, ::-1])
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if len(boxes):
            keep = ((boxes[:, 2] - boxes[:, 0]) > 1) & ((boxes[:, 3] - boxes[:, 1]) > 1)
            boxes, labels = boxes[keep], labels[keep]
        return img, boxes, labels
