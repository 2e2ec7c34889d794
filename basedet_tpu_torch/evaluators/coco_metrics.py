"""COCO bbox mAP evaluation (the port's own copy of
``basedet_tpu/evaluators/coco_metrics.py``): numpy, with the greedy matching
in the host library (``basedet_tpu_torch/native``). Every (image, class) pair
and area range goes through ``coco_match_area``, one call an area for all
pairs; where a pair holds more than 1024 gts (the library's capacity for
that call) every pair takes the per-pair path, ``match_dets`` once a pair and
area, as the JAX package does. ``_match_python`` is the plain version of both.

pycocotools' COCOeval bbox protocol:
  * IoU thresholds 0.50:0.05:0.95 (10), areas all/small/medium/large,
    maxDets (1, 10, 100);
  * greedy per-(image, category) matching in descending score order, each
    detection matched to the best unmatched gt with IoU >= threshold;
    crowd/ignored gts may be matched by leftover detections without penalty;
  * 101-point interpolated AP, averaged over classes present in the gt.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np

from basedet_tpu_torch.native.build import check, load

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


MAX_BATCHED_GTS = 1024  # coco_match_area's gts a pair
_F64P, _I64P = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
_I32P, _I8P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8)


def _match_python(ious, g_ignore, iscrowd):
    """Greedy per-threshold matching (pycocotools evaluateImg loop): the
    plain version of the library's ``match_dets``."""
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


def _match(ious, g_ignore, iscrowd):
    """``_match_python``'s (dt_m, gt_m, dt_ig) through the library's
    ``match_dets``."""
    T = len(IOU_THRS)
    D, G = ious.shape
    dt_m = np.zeros((T, D), np.int64)
    gt_m = np.zeros((T, G), np.int64)
    dt_ig = np.zeros((T, D), np.int32)
    ious_c = np.ascontiguousarray(ious, np.float64)
    gi = np.ascontiguousarray(g_ignore, np.int32)
    ic = np.ascontiguousarray(iscrowd, np.int32)
    thrs = np.ascontiguousarray(IOU_THRS, np.float64)
    check(load().match_dets(ious_c.ctypes.data_as(_F64P), gi.ctypes.data_as(_I32P), ic.ctypes.data_as(_I32P), D, G,
                            thrs.ctypes.data_as(_F64P), T, dt_m.ctypes.data_as(_I64P), gt_m.ctypes.data_as(_I64P),
                            dt_ig.ctypes.data_as(_I32P)), "match_dets")
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


def _eval_prepped(p: Optional[dict], area_rng, match=_match) -> Optional[dict]:
    """Per-area matching over a prepped (image, category) pair, by ``match``
    (the library's, or ``_match_python``)."""
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

    dt_m, gt_m, dt_ig = match(ious, g_ignore, iscrowd)

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


def _eval_img(dts: List[dict], gts: List[dict], area_rng, max_det: int, match=_match) -> Optional[dict]:
    """Per-(image, category) matching for all IoU thresholds at once."""
    return _eval_prepped(_prep_pair(dts, gts, max_det), area_rng, match)


def _eval_areas_batched(keys, preps, area_names) -> Optional[Dict]:
    """Every pair at every area in one ``coco_match_area`` call an area:
    {(cat, area, img): the per-pair result}. None where there are no pairs
    or a pair holds more than ``MAX_BATCHED_GTS`` gts; the caller then takes
    the per-pair path."""
    if not preps:
        return None
    n = len(preps)
    D = np.asarray([len(p["d_scores"]) for p in preps], np.int64)
    G = np.asarray([len(p["g_areas"]) for p in preps], np.int64)
    if int(G.max(initial=0)) > MAX_BATCHED_GTS:
        return None
    lib = load()
    d_off, g_off, iou_off = np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros(n, np.int64)
    np.cumsum(D[:-1], out=d_off[1:])
    np.cumsum(G[:-1], out=g_off[1:])
    np.cumsum((D * G)[:-1], out=iou_off[1:])
    ious = np.concatenate([p["ious"].reshape(-1) for p in preps]).astype(np.float64, copy=False)
    d_areas = np.concatenate([p["d_areas"] for p in preps]).astype(np.float64)
    g_areas = np.concatenate([p["g_areas"] for p in preps]).astype(np.float64)
    iscrowd = np.concatenate([p["iscrowd"] for p in preps]).astype(np.int32)
    thrs = np.ascontiguousarray(IOU_THRS, np.float64)
    T = len(IOU_THRS)
    total_d = int(D.sum())
    out: Dict = {}
    for a_name in area_names:
        lo, hi = AREA_RANGES[a_name]
        dt_matched = np.empty(T * total_d, np.int8)
        dt_ignore = np.empty(T * total_d, np.int8)
        num_gt = np.empty(n, np.int64)
        check(lib.coco_match_area(
            n, D.ctypes.data_as(_I64P), G.ctypes.data_as(_I64P), iou_off.ctypes.data_as(_I64P),
            d_off.ctypes.data_as(_I64P), g_off.ctypes.data_as(_I64P), ious.ctypes.data_as(_F64P),
            d_areas.ctypes.data_as(_F64P), g_areas.ctypes.data_as(_F64P), iscrowd.ctypes.data_as(_I32P),
            float(lo), float(hi), thrs.ctypes.data_as(_F64P), T, dt_matched.ctypes.data_as(_I8P),
            dt_ignore.ctypes.data_as(_I8P), num_gt.ctypes.data_as(_I64P)), "coco_match_area")
        if (num_gt < 0).any():
            raise RuntimeError("coco_match_area refused a pair within its capacity")
        for i, (cat, img) in enumerate(keys):
            d_n, s = int(D[i]), T * int(d_off[i])
            out[(cat, a_name, img)] = dict(
                dt_scores=preps[i]["d_scores"],
                dt_matches=dt_matched[s:s + T * d_n].reshape(T, d_n),
                dt_ignore=dt_ignore[s:s + T * d_n].reshape(T, d_n),
                num_gt=int(num_gt[i]),
            )
    return out


def evaluate_coco_map(
    gt_by_img_cat: Dict,
    dt_by_img_cat: Dict,
    img_ids: Sequence,
    cat_labels: Sequence[int],
    match=None,
) -> Dict[str, float]:
    """Compute the standard COCO bbox metrics.

    gt_by_img_cat / dt_by_img_cat: {(image_id, label): [dict(bbox=xywh,
    score?, area, iscrowd)]}. ``match`` (for example ``_match_python``)
    sends every pair through the per-pair path with that matcher; by default
    the library's batched matcher serves them.
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
    batched = None if match is not None else _eval_areas_batched(keys, preps, area_names)
    if batched is not None:
        eval_imgs.update(batched)
    else:
        for (cat, img), p in zip(keys, preps):
            for a_name in area_names:
                eval_imgs[(cat, a_name, img)] = _eval_prepped(p, AREA_RANGES[a_name], match or _match)

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
