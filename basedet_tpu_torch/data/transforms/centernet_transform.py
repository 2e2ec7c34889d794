"""CenterAffine (counterpart of
``basedet_tpu/data/transforms/centernet_transform.py``): a random centre and
scale affine warp to a fixed output size, for CenterNet."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from basedet_tpu_torch.data.image_ops import get_affine_transform, warp_affine
from basedet_tpu_torch.data.transforms.transforms import Transform, _keep_rows, _register


@_register
class CenterAffine(Transform):
    def __init__(self, border: int = 128, output_size: Tuple[int, int] = (512, 512), random_aug: bool = True):
        self.border = border
        self.output_size = tuple(output_size)  # (h, w)
        self.random_aug = random_aug

    def _border(self, border, size):
        i = 1
        while size - border // i <= border // i:
            i *= 2
        return border // i

    def __call__(self, record, rng):
        img = record["image"]
        h, w = img.shape[:2]
        oh, ow = self.output_size
        if self.random_aug:
            scale = max(h, w) * rng.py.choice(np.arange(0.6, 1.4, 0.1))
            h_border = self._border(self.border, h)
            w_border = self._border(self.border, w)
            cx = rng.py.randint(w_border, w - w_border) if w - 2 * w_border > 0 else w // 2
            cy = rng.py.randint(h_border, h - h_border) if h - 2 * h_border > 0 else h // 2
        else:
            scale = max(h, w)
            cx, cy = w / 2, h / 2

        src = np.array([[cx, cy], [cx, cy - scale / 2], [cx - scale / 2, cy - scale / 2]], np.float32)
        dst = np.array([[ow / 2, oh / 2], [ow / 2, 0], [0, 0]], np.float32)
        M = get_affine_transform(src, dst)
        record["image"] = warp_affine(img, M, (ow, oh))
        boxes = record.get("boxes")
        if boxes is not None and len(boxes):
            pts = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(-1, 2)
            pts = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ M.T
            pts = pts.reshape(-1, 8)
            xs, ys = pts[:, 0::2], pts[:, 1::2]
            nb = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1).astype(np.float32)
            nb[:, 0::2] = nb[:, 0::2].clip(0, ow)
            nb[:, 1::2] = nb[:, 1::2].clip(0, oh)
            keep = (nb[:, 2] > nb[:, 0]) & (nb[:, 3] > nb[:, 1])
            record["boxes"] = nb[keep]
            _keep_rows(record, keep)
        return record
