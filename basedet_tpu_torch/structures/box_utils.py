"""Scalar and numpy box utilities (the port's own copy of
``basedet_tpu/structures/box_utils.py``, which imports no JAX)."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def get_iou_cpu(box1: Sequence[float], box2: Sequence[float]) -> float:
    """Scalar IoU of two xyxy boxes (pure python)."""
    ix1 = max(box1[0], box2[0])
    iy1 = max(box1[1], box2[1])
    ix2 = min(box1[2], box2[2])
    iy2 = min(box1[3], box2[3])
    iw = max(ix2 - ix1, 0.0)
    ih = max(iy2 - iy1, 0.0)
    inter = iw * ih
    a1 = max(box1[2] - box1[0], 0.0) * max(box1[3] - box1[1], 0.0)
    a2 = max(box2[2] - box2[0], 0.0) * max(box2[3] - box2[1], 0.0)
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def rotate_box(
    boxes: np.ndarray, angle_deg: float, center, expand_bounds=True
) -> np.ndarray:
    """Axis-aligned envelope of xyxy boxes rotated about ``center``."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    theta = math.radians(angle_deg)
    c, s = math.cos(theta), math.sin(theta)
    cx, cy = center
    corners = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(-1, 4, 2)
    x = corners[..., 0] - cx
    y = corners[..., 1] - cy
    rx = x * c - y * s + cx
    ry = x * s + y * c + cy
    return np.stack(
        [rx.min(1), ry.min(1), rx.max(1), ry.max(1)], axis=1
    )
