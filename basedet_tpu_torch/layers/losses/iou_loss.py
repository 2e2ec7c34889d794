"""Elementwise IoU losses over matched (..., 4) box pairs (counterpart of
``iou_loss`` in ``basedet_tpu/layers/losses/iou_loss.py``). Ported:
``iou`` (-log iou), ``linear_iou`` (1 - iou) and ``square_iou`` (1 - iou²),
for boxes in any mode but ``ltrb``."""
from __future__ import annotations

import torch

from basedet_tpu_torch.structures.box_convert import convert_boxes
from basedet_tpu_torch.structures.box_ops import elementwise_iou

_LOSSES = ("iou", "linear_iou", "square_iou")


def iou_loss(pred: torch.Tensor, target: torch.Tensor, box_mode: str = "xyxy",
             loss_type: str = "iou", eps: float = 1e-8) -> torch.Tensor:
    if loss_type not in _LOSSES or box_mode == "ltrb":
        raise ValueError(f"iou_loss: {loss_type!r} on {box_mode!r} boxes is not ported")
    ious = elementwise_iou(convert_boxes(pred, box_mode, "xyxy"),
                           convert_boxes(target, box_mode, "xyxy"))
    if loss_type == "iou":
        return -torch.log(ious.clamp(min=eps))
    if loss_type == "square_iou":
        return 1.0 - ious ** 2
    return 1.0 - ious
