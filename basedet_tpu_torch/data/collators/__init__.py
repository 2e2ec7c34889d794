from .pack import CanvasRing, pack_images, pin_batch
from .pad_collator import DETRPadCollator, DetectionPadCollator, pick_bucket

__all__ = ["CanvasRing", "DETRPadCollator", "DetectionPadCollator", "pack_images", "pick_bucket", "pin_batch"]
