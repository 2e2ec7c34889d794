"""Box math on xyxy tensors (counterpart of ``basedet_tpu/structures/box_ops.py``)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., M, N) of (..., M, 4) and (..., N, 4); 0 where the
    union is not positive."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)


def clip_boxes(boxes: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Clip (B, N, 4) xyxy boxes to [0, w] x [0, h], with h and w (B,) per
    image."""
    h, w = h[:, None], w[:, None]
    x1 = boxes[..., 0].clamp(min=0.0)
    y1 = boxes[..., 1].clamp(min=0.0)
    x2 = boxes[..., 2].clamp(min=0.0)
    y2 = boxes[..., 3].clamp(min=0.0)
    return torch.stack(
        [torch.minimum(x1, w), torch.minimum(y1, h), torch.minimum(x2, w), torch.minimum(y2, h)],
        dim=-1,
    )


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of matched (..., 4) box pairs; 0 where the union is not positive."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
