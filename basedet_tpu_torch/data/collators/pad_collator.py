"""Pad collator: records → one batch (counterpart of
``basedet_tpu/data/collators/pad_collator.py``).

Batch: ``data`` (B, H, W, 3) uint8 (float32 where a transform made floats),
padded at the bottom and right to the smallest size bucket that fits (or to
multiples of 32), ``gt_boxes`` (B, K, 5) [x1 y1 x2 y2 label] padded to
``max_instances`` rows, ``im_info`` (B, 5) [cur_h, cur_w, orig_h, orig_w,
num_instances], all CPU tensors, and ``image_id`` (B,) numpy; with
``with_mask`` (``DETRPadCollator``) also ``mask`` (B, H, W) uint8, 1 on each
image's pixels and 0 on the padding.

The image canvas and the mask are filled in one pass of the host library's
pack (``data/collators/pack.py``), as the JAX package's collator packs.
In the main process the canvases come from ``ring`` (pinned on the card's
path); in a DataLoader worker they are fresh tensors, which the loader moves
through shared memory and pins in the main process. A worker keeps no ring:
its batch is still being sent when it packs the next.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from basedet_tpu_torch.data.collators.pack import CanvasRing, new_canvas, pack_images


def _round32(x: int) -> int:
    return (x + 31) // 32 * 32


def pick_bucket(h: int, w: int, buckets: Optional[Sequence[Tuple[int, int]]]) -> Tuple[int, int]:
    if buckets:
        for bh, bw in buckets:
            if h <= bh and w <= bw:
                return bh, bw
        return buckets[-1]
    return _round32(h), _round32(w)


def check_group_buckets(buckets: Optional[Sequence[Tuple[int, int]]]) -> None:
    """Raise unless ``pick_bucket`` commutes with the maximum: for any two
    sets of rows, the larger in each dimension of their two canvases must be
    the canvas of their union. Each rank of a data group pads its rows to
    its own canvas and the trainer then pads every rank to the group's
    largest; that equals the canvas of the global batch only where this
    holds. Multiples of 32 (no buckets) always commute; a bucket ladder does
    where, for every pair of sizes, the buckets picked do. ``pick_bucket``
    is constant between consecutive bucket edges, so the edges themselves
    are the only sizes to try."""
    if not buckets:
        return
    hs, ws = sorted({b[0] for b in buckets}), sorted({b[1] for b in buckets})
    sizes = [(h, w) for h in hs for w in ws]
    for h1, w1 in sizes:
        a = pick_bucket(h1, w1, buckets)
        for h2, w2 in sizes:
            b = pick_bucket(h2, w2, buckets)
            union = pick_bucket(max(h1, h2), max(w1, w2), buckets)
            if (max(a[0], b[0]), max(a[1], b[1])) != tuple(union):
                raise ValueError(f"size buckets {list(buckets)} do not commute with the maximum: rows of at most "
                                 f"{(h1, w1)} pad to {a}, rows of at most {(h2, w2)} to {b}, both together to "
                                 f"{union}; ranks would pad the global batch to another canvas than one process")


class DetectionPadCollator:
    def __init__(self, max_instances: int = 100, size_buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 pad_value: float = 0.0, ring: Optional[CanvasRing] = None, with_mask: bool = False):
        self.max_instances = max_instances
        self.with_mask = with_mask
        self.size_buckets = [tuple(b) for b in size_buckets] if size_buckets else None
        self.pad_value = pad_value
        self.ring = ring

    def __call__(self, records: List[dict]) -> dict:
        ring = self.ring if torch.utils.data.get_worker_info() is None else None
        B, K = len(records), self.max_instances
        H, W = pick_bucket(max(r["image"].shape[0] for r in records),
                           max(r["image"].shape[1] for r in records), self.size_buckets)
        mask_t = new_canvas((B, H, W), torch.uint8, ring) if self.with_mask else None
        data = pack_images([np.asarray(r["image"]) for r in records], H, W, self.pad_value, ring, mask_t)
        gt_t, info_t = new_canvas((B, K, 5), torch.float32, ring), new_canvas((B, 5), torch.float32, ring)
        gt, info = gt_t.numpy(), info_t.numpy()
        gt[...] = 0
        image_ids = []
        for b, r in enumerate(records):
            h, w = r["image"].shape[:2]
            boxes = r.get("boxes", np.zeros((0, 4), np.float32))
            labels = r.get("labels", np.zeros((0,), np.int32))
            n = min(len(boxes), K)
            if n:
                gt[b, :n, :4] = boxes[:n]
                gt[b, :n, 4] = labels[:n]
            oh, ow = r.get("orig_size", (h, w))
            info[b] = [h, w, oh, ow, n]
            image_ids.append(r.get("image_id", b))
        batch = {"data": data, "gt_boxes": gt_t, "im_info": info_t, "image_id": np.asarray(image_ids)}
        if mask_t is not None:
            batch["mask"] = mask_t
        return batch


class DETRPadCollator(DetectionPadCollator):
    """The pad collator with DETR's valid-pixel ``mask``."""

    def __init__(self, **kwargs):
        super().__init__(**{**kwargs, "with_mask": True})
