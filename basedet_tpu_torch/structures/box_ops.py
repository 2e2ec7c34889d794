"""Box math on xyxy tensors (counterpart of ``basedet_tpu/structures/box_ops.py``),
shape-polymorphic over leading batch axes as the JAX functions are.

``box_iou`` is also the plain version of the pairwise-IoU CUDA kernel
(``ops/iou_kernel.py::box_iou``, which exports it as ``box_iou_plain``):
``box_iou.calls`` counts its calls, so that a run can show the kernel took
its place."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_center(boxes: torch.Tensor) -> torch.Tensor:
    """Centres (..., 2) of xyxy boxes."""
    return (boxes[..., :2] + boxes[..., 2:4]) * 0.5


def box_wh(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., 2:4] - boxes[..., :2]


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas: (..., M, 4) x (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., M, N) of (..., M, 4) and (..., N, 4); 0 where the
    union is not positive."""
    box_iou.calls += 1
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)


box_iou.calls = 0


def box_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection over the area of boxes2 (..., M, N)."""
    inter = pairwise_intersection(boxes1, boxes2)
    a2 = box_area(boxes2)[..., None, :]
    return torch.where(a2 > 0, inter / a2.clamp(min=1e-12), 0.0)


def box_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU (..., M, N): the IoU less the share of the
    smallest enclosing box that the union leaves empty."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - torch.where(enclose > 0, (enclose - union) / enclose.clamp(min=1e-12), 0.0)


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


def point_distance(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Signed distances (l, t, r, b) of (..., M, 2) points to the edges of
    (..., N, 4) boxes -> (..., M, N, 4); all positive iff the point lies
    inside the box."""
    px = points[..., :, None, 0]
    py = points[..., :, None, 1]
    return torch.stack([px - boxes[..., None, :, 0], py - boxes[..., None, :, 1],
                        boxes[..., None, :, 2] - px, boxes[..., None, :, 3] - py], dim=-1)


def scale_boxes(boxes: torch.Tensor, scale_x, scale_y) -> torch.Tensor:
    """xyxy boxes with x scaled by ``scale_x`` and y by ``scale_y``."""
    scale = torch.tensor([scale_x, scale_y, scale_x, scale_y], dtype=boxes.dtype, device=boxes.device)
    return boxes * scale


def nonempty_mask(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold (a mask in place of a
    filter, for static shapes)."""
    wh = box_wh(boxes)
    return (wh[..., 0] > threshold) & (wh[..., 1] > threshold)
