from .cross_entropy import binary_cross_entropy
from .iou_loss import iou_loss
from .smooth_l1_loss import smooth_l1_loss

__all__ = ["binary_cross_entropy", "iou_loss", "smooth_l1_loss"]
