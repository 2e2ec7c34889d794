from .box_convert import BoxMode, convert_boxes
from .box_ops import (
    box_area,
    box_center,
    box_giou,
    box_iou,
    box_ioa,
    box_wh,
    clip_boxes,
    elementwise_iou,
    nonempty_mask,
    pairwise_intersection,
    point_distance,
    scale_boxes,
)
from .boxcoder import BoxCoder, PointCoder, SumBoxCoder
from .container import Container

__all__ = [
    "BoxCoder",
    "BoxMode",
    "Container",
    "PointCoder",
    "SumBoxCoder",
    "box_area",
    "box_center",
    "box_giou",
    "box_iou",
    "box_ioa",
    "box_wh",
    "clip_boxes",
    "convert_boxes",
    "elementwise_iou",
    "nonempty_mask",
    "pairwise_intersection",
    "point_distance",
    "scale_boxes",
]
