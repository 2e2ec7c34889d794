"""Elementwise IoU losses over matched (..., 4) box pairs (counterpart of
``basedet_tpu/layers/losses/iou_loss.py``): ``iou`` (-log iou),
``linear_iou`` (1 - iou), ``giou`` (1 - giou) and ``square_iou`` (1 - iou²),
for boxes in ``ltrb`` (distances of a box's edges from one shared point, the
FCOS family's offsets) or any mode ``convert_boxes`` knows, each term in the
JAX package's order."""
from __future__ import annotations

from typing import Tuple, Union

import torch

from basedet_tpu_torch.structures.box_convert import convert_boxes

_LOSSES = ("iou", "linear_iou", "giou", "square_iou")


def elementwise_iou_xyxy(b1: torch.Tensor, b2: torch.Tensor, iou_type: str = "iou",
                         eps: float = 1e-8) -> torch.Tensor:
    """Elementwise IoU or GIoU of matched xyxy boxes (..., 4), areas of
    inverted boxes counted as 0."""
    area1 = (b1[..., 2] - b1[..., 0]).clamp(min=0) * (b1[..., 3] - b1[..., 1]).clamp(min=0)
    area2 = (b2[..., 2] - b2[..., 0]).clamp(min=0) * (b2[..., 3] - b2[..., 1]).clamp(min=0)
    iw = (torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
    ih = (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0)
    inter = iw * ih
    union = area1 + area2 - inter
    ious = inter / union.clamp(min=eps)
    if iou_type == "iou":
        return ious
    if iou_type == "giou":
        gw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
        gh = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
        enclose = gw * gh
        return ious - (enclose - union) / enclose.clamp(min=eps)
    raise ValueError(f"iou_type {iou_type} not supported")


def _ltrb_to_signed_xyxy(b: torch.Tensor) -> torch.Tensor:
    """ltrb distances (l, t, r, b) → signed xyxy around their shared point."""
    return torch.cat([-b[..., :2], b[..., 2:4]], dim=-1)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, box_mode: str = "xyxy", loss_type: str = "iou",
             eps: float = 1e-8, return_iou: bool = False) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The loss of each matched pair, and with ``return_iou`` the IoU (GIoU
    for ``giou``) it came from."""
    if loss_type not in _LOSSES:
        raise ValueError(f"iou_loss: loss_type {loss_type!r} is not one of {_LOSSES}")
    if box_mode == "ltrb":
        p, t = _ltrb_to_signed_xyxy(pred), _ltrb_to_signed_xyxy(target)
    else:
        p, t = convert_boxes(pred, box_mode, "xyxy"), convert_boxes(target, box_mode, "xyxy")
    ious = elementwise_iou_xyxy(p, t, "giou" if loss_type == "giou" else "iou", eps)
    if loss_type == "iou":
        loss = -torch.log(ious.clamp(min=eps))
    elif loss_type == "square_iou":
        loss = 1.0 - ious ** 2
    else:
        loss = 1.0 - ious
    return (loss, ious) if return_iou else loss
