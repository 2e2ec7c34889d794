"""Input pre-processing on NHWC tensors: pad to a multiple of 32, then
normalize (counterpart of ``basedet_tpu/layers/common/pre_processing.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or tensor on ``device`` (cast to ``dtype`` where given,
    on the device). A page-locked tensor crosses to the card with
    ``non_blocking=True``; where it carries a ``copy_done`` event (a slot of
    ``data.collators.CanvasRing``), the event is recorded after the copy, so
    that the slot is not rewritten before the copy has run. Anything else
    crosses as a plain copy."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu" and t.is_pinned():
        out = t.to(device, non_blocking=True)
        done = getattr(t, "copy_done", None)
        if done is not None:
            done.record()
    else:
        out = t.to(device)
    return out if dtype is None else out.to(dtype)


def get_multiple_size(input_size: int, multiple: int = 32) -> int:
    return (input_size + multiple - 1) // multiple * multiple


def get_padded_tensor(x: torch.Tensor, multiple_number: int = 32, pad_value: float = 0.0) -> torch.Tensor:
    """Pad H and W (dims -3, -2 of an NHWC tensor) at the bottom and right up
    to multiples."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = get_multiple_size(h, multiple_number), get_multiple_size(w, multiple_number)
    if (ph, pw) == (h, w):
        return x
    return F.pad(x, (0, 0, 0, pw - w, 0, ph - h), value=pad_value)


def normalize_image(
    image: torch.Tensor,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """(x - mean) / std over the channel (last) axis."""
    image = image.to(torch.float32)
    if mean is not None:
        image = image - torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    if std is not None:
        image = image / torch.as_tensor(std, dtype=torch.float32, device=image.device)
    return image


def data_to_input(
    image: torch.Tensor,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    multiple: int = 32,
) -> torch.Tensor:
    return normalize_image(get_padded_tensor(image, multiple), mean, std)
