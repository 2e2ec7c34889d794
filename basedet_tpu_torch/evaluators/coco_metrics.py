"""COCO bbox mAP evaluation in pure numpy (the port's own copy of
``basedet_tpu/evaluators/coco_metrics.py``, without its optional C++ matcher:
the Python matcher it falls back to is the same protocol).

pycocotools' COCOeval bbox protocol:
  * IoU thresholds 0.50:0.05:0.95 (10), areas all/small/medium/large,
    maxDets (1, 10, 100);
  * greedy per-(image, category) matching in descending score order, each
    detection matched to the best unmatched gt with IoU >= threshold;
    crowd/ignored gts may be matched by leftover detections without penalty;
  * 101-point interpolated AP, averaged over classes present in the gt.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (D, 4) and (G, 4) xywh boxes; for crowd gt, IoU =
    intersection / det area (pycocotools semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(
        0, np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    )
    ih = np.maximum(
        0, np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :] > 0, d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_python(ious, g_ignore, iscrowd):
    """Greedy per-threshold matching (pycocotools evaluateImg loop)."""
    T = len(IOU_THRS)
    D, G = ious.shape
    dt_m = np.zeros((T, D), np.int64)       # matched gt index + 1, 0 = unmatched
    gt_m = np.zeros((T, G), np.int64)
    dt_ig = np.zeros((T, D), np.int32)
    for t, thr in enumerate(IOU_THRS):
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                if gt_m[t, g] > 0 and not iscrowd[g]:
                    continue
                # gts are sorted non-ignored first; once we hit ignored gts,
                # stop if we already have a real match
                if best_g > -1 and g_ignore[best_g] == 0 and g_ignore[g] == 1:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g == -1:
                continue
            dt_ig[t, d] = g_ignore[best_g]
            dt_m[t, d] = best_g + 1
            gt_m[t, best_g] = d + 1
    return dt_m, gt_m, dt_ig


def _prep_pair(dts: List[dict], gts: List[dict], max_det: int) -> Optional[dict]:
    """Area-independent work for one (image, category): score-sort dets,
    compute the crowd-adjusted IoU matrix ONCE (pycocotools computes IoU per
    (img, cat) and reuses it across area ranges too)."""
    if len(dts) == 0 and len(gts) == 0:
        return None
    d_scores = np.asarray([d["score"] for d in dts])
    d_order = np.argsort(-d_scores, kind="stable")[:max_det]
    d_boxes = np.asarray(
        [dts[i]["bbox"] for i in d_order], np.float64
    ).reshape(-1, 4)
    g_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
    iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], np.int32)
    return dict(
        d_scores=d_scores[d_order],
        d_areas=d_boxes[:, 2] * d_boxes[:, 3],
        g_areas=np.asarray([g["area"] for g in gts], np.float64),
        iscrowd=iscrowd,
        ious=_iou_xywh(d_boxes, g_boxes, iscrowd),
    )


def _eval_prepped(p: Optional[dict], area_rng) -> Optional[dict]:
    """Per-area matching over a prepped (image, category) pair."""
    if p is None:
        return None
    g_ignore = (
        (p["iscrowd"] > 0)
        | (p["g_areas"] < area_rng[0])
        | (p["g_areas"] > area_rng[1])
    ).astype(np.int32)
    # sort gts: non-ignored first (pycocotools gtind ordering)
    g_order = np.argsort(g_ignore, kind="stable")
    g_ignore = g_ignore[g_order]
    iscrowd = p["iscrowd"][g_order]
    ious = p["ious"][:, g_order] if g_order.size else p["ious"]

    dt_m, gt_m, dt_ig = _match_python(ious, g_ignore, iscrowd)

    # unmatched detections outside the area range are ignored
    out_of_rng = (p["d_areas"] < area_rng[0]) | (p["d_areas"] > area_rng[1])
    dt_ig = np.logical_or(
        dt_ig, (dt_m == 0) & out_of_rng[None, :]
    ).astype(np.int32)

    return dict(
        dt_scores=p["d_scores"],
        dt_matches=dt_m,
        dt_ignore=dt_ig,
        gt_ignore=g_ignore,
        num_gt=int(np.sum(g_ignore == 0)),
    )


def evaluate_coco_map(
    gt_by_img_cat: Dict,
    dt_by_img_cat: Dict,
    img_ids: Sequence,
    cat_labels: Sequence[int],
) -> Dict[str, float]:
    """Compute the standard COCO bbox metrics.

    gt_by_img_cat / dt_by_img_cat: {(image_id, label): [dict(bbox=xywh,
    score?, area, iscrowd)]}.
    Returns the 12 standard metrics (AP, AP50, AP75, APs/m/l, AR@1/10/100,
    ARs/m/l).
    """
    T = len(IOU_THRS)
    R = len(RECALL_THRS)
    results: Dict[str, float] = {}

    # evaluate every (cat, area, img) once at maxDet=100 and slice later;
    # dets/IoUs are prepped once per (img, cat) and shared across areas
    area_names = list(AREA_RANGES)
    keys, preps = [], []
    for cat in cat_labels:
        for img in img_ids:
            gts = gt_by_img_cat.get((img, cat), [])
            dts = dt_by_img_cat.get((img, cat), [])
            p = _prep_pair(dts, gts, max(MAX_DETS))
            if p is not None:
                keys.append((cat, img))
                preps.append(p)
    eval_imgs = {
        (cat, a_name, img): None
        for cat in cat_labels for a_name in area_names for img in img_ids
    }
    for (cat, img), p in zip(keys, preps):
        for a_name in area_names:
            eval_imgs[(cat, a_name, img)] = _eval_prepped(p, AREA_RANGES[a_name])

    def accumulate(a_name: str, max_det: int):
        """precision (T, R, K) and recall (T, K) for this slice."""
        precisions = -np.ones((T, R, len(cat_labels)))
        recalls = -np.ones((T, len(cat_labels)))
        for k, cat in enumerate(cat_labels):
            es = [
                eval_imgs[(cat, a_name, img)]
                for img in img_ids
                if eval_imgs[(cat, a_name, img)] is not None
            ]
            if not es:
                continue
            scores = np.concatenate([e["dt_scores"][:max_det] for e in es])
            order = np.argsort(-scores, kind="mergesort")
            dt_m = np.concatenate(
                [e["dt_matches"][:, :max_det] for e in es], axis=1
            )[:, order]
            dt_ig = np.concatenate(
                [e["dt_ignore"][:, :max_det] for e in es], axis=1
            )[:, order]
            num_gt = sum(e["num_gt"] for e in es)
            if num_gt == 0:
                continue
            tps = (dt_m > 0) & (dt_ig == 0)
            fps = (dt_m == 0) & (dt_ig == 0)
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp = tp_sum[t]
                fp = fp_sum[t]
                rc = tp / num_gt
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                recalls[t, k] = rc[-1] if len(rc) else 0.0
                # monotone envelope (right-to-left running max)
                pr = np.maximum.accumulate(pr[::-1])[::-1]
                inds = np.searchsorted(rc, RECALL_THRS, side="left")
                valid = inds < len(pr)
                q = np.zeros(R)
                q[valid] = pr[inds[valid]]
                precisions[t, :, k] = q
        return precisions, recalls

    def mean_valid(x):
        v = x[x > -1]
        return float(np.mean(v)) if v.size else -1.0

    p_all, r_all = accumulate("all", 100)
    results["AP"] = mean_valid(p_all)
    results["AP50"] = mean_valid(p_all[np.isclose(IOU_THRS, 0.5)])
    results["AP75"] = mean_valid(p_all[np.isclose(IOU_THRS, 0.75)])
    for a in ("small", "medium", "large"):
        p, _ = accumulate(a, 100)
        results[f"AP{a[0]}"] = mean_valid(p)
    for md in MAX_DETS:
        _, r = accumulate("all", md)
        results[f"AR@{md}"] = mean_valid(r)
    for a in ("small", "medium", "large"):
        _, r = accumulate(a, 100)
        results[f"AR{a[0]}"] = mean_valid(r)
    return results
