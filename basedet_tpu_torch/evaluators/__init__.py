from .coco_eval import COCOEvaluator
from .coco_metrics import evaluate_coco_map

__all__ = ["COCOEvaluator", "evaluate_coco_map"]
