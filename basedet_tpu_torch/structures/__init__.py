from .box_convert import BoxMode, convert_boxes
from .box_ops import box_area, box_iou, clip_boxes, elementwise_iou

__all__ = ["BoxMode", "box_area", "box_iou", "clip_boxes", "convert_boxes", "elementwise_iou"]
