"""The batch pack and its canvases (counterpart of
``basedet_tpu/native/pack.py``).

``pack_images`` copies variable-size HWC images into one (B, H, W, C)
canvas, top-left, padded with ``pad``, through the host library
(``basedet_tpu_torch/native``: one pass over the canvas, OpenMP threads in
the main process), with DETR's valid-pixel mask in the same pass where one
is asked for; ``pack_numpy`` is its plain version. uint8 stays uint8 (the
model casts on the card). ``CanvasRing`` reuses canvases; with ``pin`` they are page-locked,
so that the copy to the card runs without blocking the host
(``layers.common.pre_processing.to_device``). Each pinned slot carries a
CUDA event, ``copy_done``, which ``to_device`` records after the slot's copy;
the ring waits on it before it hands the slot out again, so a canvas is
never rewritten while its copy is queued.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from basedet_tpu_torch.native.pack import pack_into

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


class CanvasRing:
    """``depth`` reusable canvases per (shape, dtype), handed out in turn.
    A fresh canvas every batch pays its page faults each time; a pinned one
    also a page-locking allocation."""

    def __init__(self, depth: int = 4, pin: bool = False):
        self.depth = depth
        self.pin = pin
        self._slots: Dict[tuple, List[torch.Tensor]] = {}
        self._next: Dict[tuple, int] = {}

    def get(self, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        ring = self._slots.setdefault(key, [])
        if len(ring) < self.depth:
            slot = torch.empty(key[0], dtype=dtype, pin_memory=self.pin)
            if self.pin:
                slot.copy_done = torch.cuda.Event()
            else:  # touch every page now, not inside the pack
                slot.view(-1)[:: max(1, 4096 // slot.element_size())] = 0
            ring.append(slot)
            return slot
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.depth
        slot = ring[i]
        if self.pin:
            slot.copy_done.synchronize()  # returns at once if never recorded
        return slot


def canvas_dtype(images: Sequence[np.ndarray], pad: float) -> np.dtype:
    """uint8 where every image is uint8 and ``pad`` is a uint8 value, else
    float32, as the JAX package decides."""
    dtype = images[0].dtype
    if not all(i.dtype == dtype for i in images):
        return np.dtype(np.float32)
    if dtype == np.uint8 and not (0 <= pad <= 255 and float(pad).is_integer()):
        return np.dtype(np.float32)
    return dtype if dtype in _TORCH_DTYPES else np.dtype(np.float32)


def new_canvas(shape: Sequence[int], dtype: torch.dtype, ring: "CanvasRing | None" = None) -> torch.Tensor:
    return ring.get(shape, dtype) if ring is not None else torch.empty(tuple(shape), dtype=dtype)


def pack_numpy(images: Sequence[np.ndarray], pad: float, out: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
    """The plain version of ``native.pack.pack_into``: the same canvas and
    mask, image by image in numpy."""
    for b, img in enumerate(images):
        h, w = img.shape[:2]
        out[b, :h, :w] = img
        out[b, :h, w:] = pad
        out[b, h:] = pad
        if mask is not None:
            mask[b] = 0
            mask[b, :h, :w] = 1


def pack_images(images: List[np.ndarray], H: int, W: int, pad: float = 0.0,
                ring: "CanvasRing | None" = None, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C) canvas of the images, each at its top left, the rest
    ``pad``; ``mask`` (B, H, W) uint8, where given, is filled with 1 on each
    image's pixels and 0 elsewhere in the same pass."""
    if not images:
        return torch.zeros((0, H, W, 3), dtype=torch.float32)
    dtype = canvas_dtype(images, pad)
    out = new_canvas((len(images), H, W, images[0].shape[2]), _TORCH_DTYPES[dtype], ring)
    pack_into(images, pad, out.numpy(), None if mask is None else mask.numpy())
    return out


def pin_batch(batch: dict, ring: CanvasRing,
              keys: Sequence[str] = ("data", "gt_boxes", "im_info", "mask")) -> dict:
    """The batch with each tensor of ``keys`` it holds that is not page-locked
    copied into a slot of ``ring`` (a pinned ring, in the main process)."""
    out = dict(batch)
    for k in keys:
        if k not in out:
            continue
        t = out[k]
        if not t.is_pinned():
            slot = ring.get(t.shape, t.dtype)
            slot.copy_(t)
            out[k] = slot
    return out
