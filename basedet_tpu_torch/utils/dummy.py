"""Synthetic batch generator for tests and benchmarks (the port's own copy of
``basedet_tpu/utils/dummy.py``): deterministic fake annotations and random
images, shaped like the real collator's output (NHWC). A seed gives the same
batches, byte for byte, in both packages.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class DummyLoader:
    def __init__(
        self,
        batch_size: int = 2,
        image_size: Tuple[int, int] = (256, 256),
        max_instances: int = 16,
        num_instances: int = 3,
        num_classes: int = 80,
        seed: int = 3,
        length: int = 1000,
    ):
        self.batch_size = batch_size
        self.image_size = image_size
        self.max_instances = max_instances
        self.num_instances = num_instances
        self.num_classes = num_classes
        self.seed = seed
        self.length = length

    def make_batch(self, it: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + it)
        h, w = self.image_size
        data = rng.uniform(0, 255, (self.batch_size, h, w, 3)).astype(np.float32)
        gt = np.zeros((self.batch_size, self.max_instances, 5), np.float32)
        n = min(self.num_instances, self.max_instances)
        for b in range(self.batch_size):
            x1 = rng.uniform(0, w * 0.5, n)
            y1 = rng.uniform(0, h * 0.5, n)
            bw = rng.uniform(w * 0.1, w * 0.4, n)
            bh = rng.uniform(h * 0.1, h * 0.4, n)
            cls = rng.randint(1, self.num_classes + 1, n)
            gt[b, :n] = np.stack(
                [x1, y1, np.minimum(x1 + bw, w - 1), np.minimum(y1 + bh, h - 1), cls],
                axis=1,
            )
        im_info = np.tile(
            np.asarray([h, w, h, w, n], np.float32), (self.batch_size, 1)
        )
        return {"data": data, "gt_boxes": gt, "im_info": im_info}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.length):
            yield self.make_batch(i)

    def __len__(self) -> int:
        return self.length
