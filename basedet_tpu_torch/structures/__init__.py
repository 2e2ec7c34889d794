from .box_convert import BoxMode, convert_boxes
from .box_ops import box_area, box_iou, clip_boxes, elementwise_iou, nonempty_mask
from .boxcoder import BoxCoder

__all__ = ["BoxCoder", "BoxMode", "box_area", "box_iou", "clip_boxes", "convert_boxes",
           "elementwise_iou", "nonempty_mask"]
