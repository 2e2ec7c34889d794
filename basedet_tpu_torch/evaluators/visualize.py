"""Detection visualization (counterpart of ``basedet_tpu/evaluators/visualize.py``,
the reference's ``visualize_detection``), drawn with Pillow's ``ImageDraw``
where the JAX package draws with cv2. Pillow is imported when a picture is
drawn: without it this raises, and nothing else needs it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def visualize_detection(
    img: np.ndarray,
    dets: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.3,
    color=(0, 255, 0),
) -> np.ndarray:
    """img: HWC BGR uint8; dets: (N, 6) [x1, y1, x2, y2, score, label] →
    a copy with each detection scoring at least ``score_threshold`` outlined
    two pixels wide in ``color`` (BGR, as the image) and labelled
    ``name:score`` above its corner."""
    from PIL import Image, ImageDraw

    canvas = Image.fromarray(np.ascontiguousarray(img, dtype=np.uint8))  # channels kept in BGR order
    draw = ImageDraw.Draw(canvas)
    fill = tuple(int(c) for c in color)
    for det in dets:
        x1, y1, x2, y2, score = (float(v) for v in det[:5])
        if score < score_threshold:
            continue
        label = int(det[5]) if len(det) > 5 else -1
        draw.rectangle([int(x1), int(y1), int(x2), int(y2)], outline=fill, width=2)
        name = (
            class_names[label]
            if class_names is not None and 0 <= label < len(class_names)
            else str(label)
        )
        draw.text((int(x1), max(int(y1) - 12, 0)), f"{name}:{score:.2f}", fill=fill)
    return np.asarray(canvas).copy()
