"""COCO evaluator for the port (counterpart of ``basedet_tpu/evaluators/coco_eval.py``):
run inference over the test loader, turn the padded detections into COCO
result records, save them, and compute box mAP with the in-repo COCOeval
(``coco_metrics.py``)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from basedet_tpu_torch.evaluators.coco_metrics import evaluate_coco_map
from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.utils.registry import registers


@registers.evaluators.register()
class COCOEvaluator:
    def __init__(self, cfg):
        self.cfg = cfg
        self.save_path = os.path.join(cfg.GLOBAL.get("OUTPUT_DIR", "logs"), "predict_coco.json")

    @staticmethod
    def detections_to_records(
        dets: Dict[str, np.ndarray],
        image_ids: List[int],
        label_to_cat_id: Optional[Dict[int, int]] = None,
    ) -> List[dict]:
        """Padded detections {boxes, box_scores, box_labels, valid} (B, D, ...)
        → COCO result records (xywh, category_id). ``box_labels`` are 0-based
        class indices from the head."""
        records = []
        boxes = np.asarray(dets["boxes"])
        scores = np.asarray(dets["box_scores"])
        labels = np.asarray(dets["box_labels"])
        valid = np.asarray(dets["valid"])
        for b, img_id in enumerate(image_ids):
            for d in range(boxes.shape[1]):
                if not valid[b, d]:
                    continue
                x1, y1, x2, y2 = boxes[b, d].tolist()
                label = int(labels[b, d]) + 1  # 0-based head index → 1..C
                cat = label_to_cat_id[label] if label_to_cat_id is not None else label
                records.append(dict(image_id=int(img_id), category_id=int(cat),
                                    bbox=[x1, y1, x2 - x1, y2 - y1], score=float(scores[b, d])))
        return records

    def save_results(self, records: List[dict]) -> None:
        os.makedirs(os.path.dirname(self.save_path) or ".", exist_ok=True)
        with open(self.save_path, "w") as f:
            json.dump(records, f)
        logger.info(f"saved {len(records)} detections to {self.save_path}")

    def evaluate_records(self, records: List[dict], dataset, match=None) -> Dict[str, float]:
        """Evaluate result records against a dataset's annotations
        (``items`` with boxes/labels/iscrowd, ``label_to_cat_id``);
        ``match`` as ``evaluate_coco_map`` takes it."""
        gt_by, dt_by = {}, {}
        img_ids = []
        for item in dataset.items:
            img_ids.append(item["id"])
            for box, label, crowd in zip(item["boxes"], item["labels"], item["iscrowd"]):
                x1, y1, x2, y2 = box.tolist()
                gt_by.setdefault((item["id"], int(label)), []).append(
                    dict(bbox=[x1, y1, x2 - x1, y2 - y1], area=(x2 - x1) * (y2 - y1),
                         iscrowd=int(crowd)))
        cat_labels = sorted(dataset.label_to_cat_id.keys())
        cat_to_label = {v: k for k, v in dataset.label_to_cat_id.items()}
        for r in records:
            label = cat_to_label.get(r["category_id"], None)
            if label is None:
                continue
            dt_by.setdefault((r["image_id"], label), []).append(dict(bbox=r["bbox"], score=r["score"]))
        return evaluate_coco_map(gt_by, dt_by, img_ids, cat_labels, match)

    def evaluate_model(self, model, dataloader) -> Dict[str, float]:
        """Inference over the test loader → records → metrics. A loader
        without ``.dataset`` (the dummy one) gives the detection count only."""
        records = []
        dataset = getattr(dataloader, "dataset", None)
        n_images = 0
        for batch in dataloader:
            image_ids = batch.pop("image_id", None)
            dets = model.inference({k: batch[k] for k in ("data", "im_info")})
            dets = {k: v.cpu().numpy() for k, v in dets.items()}
            n = len(batch["data"])
            if image_ids is None:
                image_ids = list(range(n_images, n_images + n))
            n_images += n
            records.extend(self.detections_to_records(
                dets, list(np.asarray(image_ids)),
                dataset.label_to_cat_id if dataset is not None else None,
            ))
        self.save_results(records)
        if dataset is None:
            return {"num_detections": float(len(records))}
        return self.evaluate_records(records, dataset)
